"""The backend registry contract in the port (twin of tests/test_backends.py
and tests/test_backend_properties.py's grid): every registered first-stage
backend obeys the same build / search / add protocol and serves the facade's
pool -> candidates -> rerank pipeline, on both storage tiers and every
gather path.  Imports no JAX: the corpora are the port's synthetic twins."""
import numpy as np
import pytest
import torch

from repro_torch.anns import registry
from repro_torch.anns.base import CorpusView, QueryBatch
from repro_torch.anns.params import ResidualConfig
from repro_torch.core import maxsim
from repro_torch.core.config import LemurConfig
from repro_torch.data import synthetic
from repro_torch.retriever import LemurRetriever, SearchParams

BACKENDS = registry.list_backends()

# recall@10 floor per backend relative to the bruteforce first stage (the
# JAX contract's): exact methods match it, the sketches get a margin
PARITY = {"bruteforce": 1.0, "ivf": 0.95, "muvera": 0.7, "dessert": 0.7,
          "token_pruning": 0.6}


def gen(seed=0):
    return torch.Generator().manual_seed(seed)


@pytest.fixture(scope="module")
def corpus():
    return synthetic.make_corpus(m=300, d=16, avg_tokens=8, max_tokens=12, n_centers=24,
                                 seed=0)


@pytest.fixture(scope="module")
def protocol_data(corpus):
    rng = np.random.default_rng(7)
    m, dp = 150, 32
    T = lambda x: torch.as_tensor(np.asarray(x))  # noqa: E731
    view = CorpusView(T(rng.standard_normal((m, dp)).astype(np.float32)),
                      T(corpus.doc_tokens[:m]), T(corpus.doc_mask[:m]))
    extra = CorpusView(T(rng.standard_normal((40, dp)).astype(np.float32)),
                       T(corpus.doc_tokens[m:m + 40]), T(corpus.doc_mask[m:m + 40]))
    qb = QueryBatch(T(rng.standard_normal((5, dp)).astype(np.float32)),
                    T(corpus.doc_tokens[:5, :6]), T(corpus.doc_mask[:5, :6]))
    return view, extra, qb


@pytest.mark.parametrize("name", BACKENDS)
def test_build_search_contract(name, protocol_data):
    """(B, k) fp32 scores and int32 ids in [-1, m), -1 padded, valid ids
    unique per row, scores descending, also at k > m."""
    view, _, qb = protocol_data
    be = registry.get_backend(name)
    state = be.build(gen(), view, None)
    for k in (10, view.m + 20):
        scores, ids = be.search(state, qb, k)
        assert scores.shape == (5, k) and ids.shape == (5, k)
        assert ids.dtype == torch.int32 and scores.dtype == torch.float32
        assert int(ids.min()) >= -1 and int(ids.max()) < view.m
        for row in ids.tolist():
            valid = [i for i in row if i >= 0]
            assert len(set(valid)) == len(valid), "duplicate candidates"
        d = torch.diff(scores, dim=1)
        assert bool((d[~torch.isnan(d)] <= 1e-5).all()), "scores not sorted"


@pytest.mark.parametrize("name", BACKENDS)
def test_add_contract(name, protocol_data):
    """add() appends docs with ids continuing the numbering, the grown state
    serves them, and (but for IVF, which appends in place) the state it was
    given is left as it was."""
    view, extra, qb = protocol_data
    be = registry.get_backend(name)
    state = be.build(gen(), view, None)
    before = {k: v.clone() for k, v in be.pack_state(state)[0].items()}
    state2 = be.add(state, extra)
    _, ids = be.search(state2, qb, view.m + extra.m)
    assert int(ids.max()) < view.m + extra.m
    assert set(range(view.m, view.m + extra.m)) & set(ids.flatten().tolist()), \
        "no added doc ever retrieved"
    if name != "ivf":
        after = be.pack_state(state)[0]
        assert all(torch.equal(before[k], after[k]) for k in before)


def test_registry_aliases_and_errors():
    assert registry.get_backend("exact") is registry.get_backend("bruteforce")
    assert registry.list_backends() == ["bruteforce", "dessert", "ivf", "muvera",
                                        "token_pruning"]
    with pytest.raises(KeyError, match="unknown anns backend"):
        registry.get_backend("hnswlib")
    with pytest.raises(ValueError, match="not a registered backend"):
        LemurConfig(anns="faiss")
    assert LemurConfig(anns="exact").backend_config() == LemurConfig().bruteforce
    for name in BACKENDS:
        assert registry.get_config_cls(name) is type(LemurConfig().backend_config(name))
    with pytest.raises(TypeError, match="takes TokenPruningSearchParams"):
        SearchParams(backend=registry.get_params_cls("ivf")()).resolve(
            LemurConfig(), "token_pruning")


def test_rerank_masks_padded_candidates(corpus):
    """-1 pads score NEG, never alias doc 0."""
    docs = torch.as_tensor(corpus.doc_tokens[:50])
    mask = torch.as_tensor(corpus.doc_mask[:50])
    q = torch.as_tensor(corpus.doc_tokens[:2, :4])
    qm = torch.ones((2, 4), dtype=torch.bool)
    cand = torch.tensor([[3, 7, -1, -1], [0, -1, -1, -1]], dtype=torch.int32)
    scores, ids = maxsim.rerank(q, qm, cand, docs, mask, 3)
    assert set(ids[0, :2].tolist()) == {3, 7} and int(ids[0, 2]) == -1
    assert int(ids[1, 0]) == 0 and bool((ids[1, 1:] == -1).all())
    assert float(scores[0, 2]) <= maxsim.NEG / 2


@pytest.fixture(scope="module")
def lemur_system(corpus):
    cfg = LemurConfig(d=16, d_prime=64, m_pretrain=128, n_train=1024, n_ols=512, epochs=5,
                      k=10, k_prime=60, anns="bruteforce")
    r = LemurRetriever.build(corpus, cfg, generator=gen(), device="cpu")
    q = torch.as_tensor(synthetic.queries_from_corpus_query(corpus, 16, 4, seed=3))
    qm = torch.ones(q.shape[:2], dtype=torch.bool)
    _, truth = maxsim.true_topk(q, qm, torch.as_tensor(corpus.doc_tokens),
                                torch.as_tensor(corpus.doc_mask), 10)
    bf = float(maxsim.recall_at(r.search(q, qm)[1], truth).mean())
    return r, q, qm, truth, bf


@pytest.mark.parametrize("name", BACKENDS)
def test_query_recall_parity(name, lemur_system):
    """Every backend built by ``with_backend`` over one trained reduction
    clears its recall floor against the bruteforce first stage (IVF at full
    probe, its exactness guarantee)."""
    r, q, qm, truth, bf = lemur_system
    rb = r.with_backend(name, generator=gen(1))
    params = SearchParams()
    if name == "ivf":
        params = SearchParams(backend=registry.get_params_cls("ivf")(nprobe=rb.index.ann.nlist))
    rec = float(maxsim.recall_at(rb.search(q, qm, params)[1], truth).mean())
    assert rec >= PARITY[name] * bf - 1e-6, f"{name}: recall {rec:.3f} vs bruteforce {bf:.3f}"
    assert rb.backend == name and rb.cfg.anns == name and r.backend == "bruteforce"


@pytest.fixture(scope="module")
def tier_system():
    """fp32 and residual stores over the same reduction on a well-separated
    corpus (one topic a doc, strongly expressed): every tier, backend and
    gather path must retrieve a doc's own tokens top-1; k' covers the corpus."""
    corpus = synthetic.make_corpus(m=64, d=16, avg_tokens=8, max_tokens=12, n_centers=64,
                                   topic_strength=4.0, seed=5)
    cfg = LemurConfig(d=16, d_prime=32, m_pretrain=48, n_train=512, n_ols=256, epochs=3,
                      k=5, k_prime=64, anns="bruteforce")
    rcfg = cfg.replace(residual=ResidualConfig(enabled=True, bits=4, ncent=32,
                                               kmeans_iters=4, token_budget=6))
    r_fp = LemurRetriever.build(corpus, cfg, generator=gen(), device="cpu")
    r_res = LemurRetriever.build(corpus, rcfg, generator=gen(), device="cpu")
    picks = [3, 17, 31, 50]
    return (r_fp, r_res, torch.as_tensor(corpus.doc_tokens[picks]),
            torch.as_tensor(corpus.doc_mask[picks]), picks)


@pytest.mark.parametrize("name", BACKENDS)
def test_cross_tier_grid_identical_ids(name, tier_system):
    """Within a tier every gather path (paged rerank, legacy gather, the
    decoded view) gives the same ids; on both tiers the top-1 is the doc's
    own."""
    r_fp, r_res, q, qm, picks = tier_system
    for base in (r_fp, r_res):
        r = base.with_backend(name, generator=gen(1))
        spellings = [SearchParams(), SearchParams(use_fused_gather=False)]
        if r.index.store.residual:
            spellings.append(SearchParams(use_residual=False))
        ids = [r.search(q, qm, p)[1] for p in spellings]
        for other in ids[1:]:
            assert torch.equal(other, ids[0])
        assert ids[0][:, 0].tolist() == picks, (name, r.index.store.residual)


@pytest.mark.parametrize("name", BACKENDS)
def test_residual_tier_tombstones_never_surface(name, tier_system):
    """Deleted docs on a residual-tier store never surface through the
    backend's route, nor under the exact full-capacity scan."""
    _, r_res, q, qm, picks = tier_system
    r = r_res.with_backend(name, generator=gen(1))
    dead = [int(picks[0]), int(picks[1])]
    r.delete(dead)
    for p in (SearchParams(k=10), SearchParams(use_ann=False, k=10, k_prime=r.m)):
        got = set(r.search(q, qm, p)[1].flatten().tolist())
        assert not (got & set(dead)), f"tombstoned docs surfaced: {got & set(dead)}"
    assert not (set(r.candidates(q, qm).flatten().tolist()) & set(dead))


@pytest.mark.parametrize("name", BACKENDS)
def test_each_backend_adds_one_compile_key(name, tier_system):
    """A backend served through ``with_backend`` adds one compile-cache entry
    for its resolved params; equivalent spellings share it; an add within
    capacity adds none for IVF, one for a backend whose state grows (as
    JAX's jit retraces on a new state shape)."""
    r_fp, _, q, qm, _ = tier_system
    r = r_fp.with_backend(name, generator=gen(1))
    be = registry.get_backend(name)
    r.search(q, qm, SearchParams())
    r.search(q, qm, SearchParams(backend=be.default_params(r.cfg.backend_config())))
    assert r.trace_count() == 1
    r.search(q, qm, SearchParams())
    assert r.trace_count() == 1 and r_fp.trace_count() == 0


def _grid_data(m, td, d, seed, dp=16, B=3):
    rng = np.random.default_rng(seed)
    mask = rng.random((m, td)) < 0.8
    mask[:, 0] = True
    f = lambda *s: torch.as_tensor(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    view = CorpusView(f(m, dp), f(m, td, d), torch.as_tensor(mask))
    return view, QueryBatch(f(B, dp), f(B, 3, d), torch.ones((B, 3), dtype=torch.bool))


@pytest.mark.parametrize("name", BACKENDS)
@pytest.mark.parametrize("m,td,d,k,k_prime", [
    (24, 2, 4, 5, 10),
    (64, 5, 12, 10, 96),    # k' > m: clamped
    (40, 3, 8, 50, 30),     # k > k': the rerank clamps to k'
])
def test_backend_contract_grid(name, m, td, d, k, k_prime):
    """The invariants every backend upholds for any shape: first-stage ids
    in [-1, m) unique a row; the exact rerank leaks no -1 pad while real
    candidates remain; k' > m pads instead of failing."""
    view, qb = _grid_data(m, td, d, seed=1)
    be = registry.get_backend(name)
    state = be.build(gen(1), view, None)
    B = qb.tokens.shape[0]
    scores, ids = be.search(state, qb, k_prime)
    assert scores.shape == (B, k_prime) and ids.shape == (B, k_prime)
    assert ids.dtype == torch.int32 and int(ids.min()) >= -1 and int(ids.max()) < m
    kk = min(k, k_prime)
    _, r_ids = maxsim.rerank(qb.tokens, qb.mask, ids, view.doc_tokens, view.doc_mask, kk)
    assert r_ids.shape == (B, kk) and int(r_ids.min()) >= -1 and int(r_ids.max()) < m
    for first, row in zip(ids.tolist(), r_ids.tolist()):
        n_valid = sum(i >= 0 for i in first)
        assert all(i >= 0 for i in row[:min(kk, n_valid)]), "-1 leaked"
        valid = [i for i in row if i >= 0]
        assert len(set(valid)) == len(valid), "duplicate after rerank"
    _, i2 = be.search(state, qb, m + 7)
    assert i2.shape == (B, m + 7) and int(i2.min()) >= -1 and int(i2.max()) < m
