"""The port's serving path held against the JAX retriever on the same index.

A JAX ``LemurRetriever`` is built on ``tiny_corpus`` (SQ8 and fp32 IVF
lists, some docs deleted) and saved; ``repro_torch``'s
``LemurRetriever.load(..., device="cpu")`` serves the checkpoint, and
``convert.index_from_numpy`` serves the live JAX state.  Both must return
JAX's top-k ids and scores.

Tolerance: the two frameworks sum the same fp32 products in different
orders (matmul blocking), so scores agree to rtol 1e-5 / atol 1e-4, not bit
for bit.  An id may differ only where the two candidates' scores are a
near-tie (relative gap < 1e-5); such positions are counted and must stay
rare.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.pytree import named_leaves
from repro.core.config import LemurConfig as JaxConfig
from repro.data import synthetic
from repro.retriever import LemurRetriever as JaxRetriever
from repro.retriever import SearchParams as JaxParams
from repro.anns import registry
from repro.anns.params import IVFBackendConfig as JaxIVFConfig

from repro_torch.convert import index_from_numpy
from repro_torch.core import pages
from repro_torch.core.model import Psi
from repro_torch.core.config import LemurConfig
from repro_torch.retriever import IVFSearchParams, LemurRetriever, SearchParams

RTOL, ATOL, TIE = 1e-5, 1e-4, 1e-5
DELETED = [3, 17, 42, 99, 150, 151, 260]


def _cfg(sq8: bool) -> JaxConfig:
    return JaxConfig(d=16, d_prime=128, m_pretrain=64, n_train=512, n_ols=256,
                     epochs=2, k=10, k_prime=64, anns="ivf",
                     ivf=JaxIVFConfig(nprobe=8, sq8=sq8))


@pytest.fixture(scope="module", params=[True, False], ids=["sq8", "fp32"])
def built(request, tiny_corpus, tmp_path_factory):
    r = JaxRetriever.build(tiny_corpus, _cfg(request.param),
                           key=jax.random.PRNGKey(0))
    r.delete(DELETED)
    path = tmp_path_factory.mktemp(f"ckpt_{request.param}")
    r.save(path)
    q = synthetic.queries_from_corpus_query(tiny_corpus, 12, q_tokens=6, seed=3)
    qm = np.random.default_rng(4).random(q.shape[:2]) > 0.25
    qm[:, 0] = True
    return r, path, q.astype(np.float32), qm


def _save_tree(r):
    """The flat tree ``LemurRetriever.save`` writes, from the live retriever."""
    idx = r.index
    st = idx.store
    ann, _ = registry.get_backend(idx.backend).pack_state(idx.ann)
    tree = {"psi": idx.psi, "stats": {"mean": idx.stats.mean, "std": idx.stats.std},
            "pages": {"tok_pages": st.tok_pages, "page_table": st.page_table,
                      "n_tokens": st.n_tokens, "W": st.W, "alive": st.alive,
                      "n_docs": st.n_docs},
            "ann": dict(ann)}
    extra = {"format": "lemur-retriever-v1", "cfg": idx.cfg.to_dict(),
             "backend": idx.backend, "ann_meta": {}}
    return {n: np.asarray(x) for n, x in named_leaves(tree)}, extra


def assert_same_topk(s_ref, i_ref, s_got, i_got):
    """Scores within tolerance; differing ids only at counted near-ties."""
    s_ref, i_ref = np.asarray(s_ref), np.asarray(i_ref)
    s_got, i_got = s_got.numpy(), i_got.numpy()
    np.testing.assert_allclose(s_got, s_ref, rtol=RTOL, atol=ATOL)
    diff = i_got != i_ref
    gap = np.abs(s_got - s_ref) / np.maximum(np.abs(s_ref), 1.0)
    assert np.all(gap[diff] < TIE), "an id differs without a near-tie"
    assert diff.sum() <= max(1, diff.size // 50), f"{diff.sum()} near-ties"
    return int(diff.sum())


@pytest.mark.parametrize("k", [10, 5, 80])   # 80 > k' = 64: padded rows
def test_load_search_matches_jax(built, k):
    r, path, q, qm = built
    want_s, want_i = r.search(jnp.asarray(q), jnp.asarray(qm), JaxParams(k=k))
    port = LemurRetriever.load(path, device="cpu")
    got_s, got_i = port.search(q, qm, SearchParams(k=k))
    assert got_s.shape == (q.shape[0], k) and got_i.dtype == torch.int32
    assert_same_topk(want_s, want_i, got_s, got_i)
    assert not np.isin(got_i.numpy(), DELETED).any()


def test_index_from_live_jax_state(built):
    r, _, q, qm = built
    tree, extra = _save_tree(r)
    port = LemurRetriever(index_from_numpy(tree, extra, device="cpu"))
    params = SearchParams(backend=IVFSearchParams(nprobe=4))
    want_s, want_i = r.search(jnp.asarray(q), jnp.asarray(qm),
                              JaxParams(backend=registry.get_params_cls("ivf")(nprobe=4)))
    got_s, got_i = port.search(q, qm, params)
    assert_same_topk(want_s, want_i, got_s, got_i)
    assert port.n_alive == r.n_alive and port.m == r.m


def test_unported_routes_raise(built):
    """``use_residual=True``, refused before the residual tier was ported,
    serves an fp32 store as JAX does: the fp32 paged rerank, JAX's ids and
    launch plan (the other routes are held in tests/test_torch_routes.py,
    the residual tier's in tests/test_torch_residual_routes.py)."""
    r, path, q, qm = built
    port = LemurRetriever.load(path, device="cpu")
    want_s, want_i = r.search(jnp.asarray(q), jnp.asarray(qm), JaxParams(use_residual=True))
    got_s, got_i = port.search(q, qm, SearchParams(use_residual=True))
    assert_same_topk(want_s, want_i, got_s, got_i)
    s0, i0 = port.search(q, qm, SearchParams())
    assert torch.equal(got_i, i0) and torch.equal(got_s, s0)
    assert port.launches(SearchParams(use_residual=True)) == r.launches(
        JaxParams(use_residual=True))


def test_checkpoint_config_round_trip(built):
    r, path, _, _ = built
    port = LemurRetriever.load(path, device="cpu")
    assert port.cfg.to_dict() == r.cfg.to_dict()
    assert port.launches() == r.launches()
    assert port.resolve().backend.nprobe == 8


def test_residual_and_other_backends_refused(built):
    """A tree with part of the residual tier's leaves (compressed pages
    without the codec, or residual lists without their tables) is not a
    checkpoint either package writes.  The other backends, refused before
    they were ported, load: ``exact`` as the bruteforce state, a view of the
    store's W rows; a ``muvera`` tree without the projections (what JAX
    saves) raises the ``ValueError`` that names both ways forward."""
    r, _, _, _ = built
    tree, extra = _save_tree(r)
    with pytest.raises(ValueError, match="codec/centroids"):
        index_from_numpy({**tree, "pages/cent_pages": np.zeros((1, 16), np.int32),
                          "pages/code_pages": np.zeros((1, 16, 8), np.uint8)},
                         extra, device="cpu")
    with pytest.raises(ValueError, match="ann/rq_cuts"):
        index_from_numpy({**tree, "ann/rq_values": np.zeros((16, 16), np.float32)},
                         extra, device="cpu")
    with pytest.raises(ValueError, match=r"ann/hyper, ann/final.*with_backend\('muvera'\)"
                                         r".*muvera_from_numpy"):
        index_from_numpy(tree, {**extra, "backend": "muvera"}, device="cpu")
    base = {k: v for k, v in tree.items() if not k.startswith("ann/")}
    m = int(tree["pages/n_docs"][0])
    idx = index_from_numpy({**base, "ann/W": tree["pages/W"][:m]},
                           {**extra, "backend": "exact"}, device="cpu")
    assert idx.backend == "bruteforce"
    assert idx.ann["W"].data_ptr() == idx.store.W.data_ptr() and idx.ann["W"].shape[0] == m
    q, qm = built[2], built[3]
    s, ids = LemurRetriever(idx).search(q, qm, SearchParams(k=10))
    want_s, want_i = r.with_backend("exact").search(jnp.asarray(q), jnp.asarray(qm),
                                                    JaxParams(k=10))
    assert_same_topk(want_s, want_i, s, ids)


def test_from_arrays_serves_a_store_built_in_the_port(tiny_corpus):
    """from_arrays (the GPU smoke's entry point) builds the IVF over the
    store's W rows and serves a search whose candidates are all live docs."""
    rng = np.random.default_rng(7)
    m = tiny_corpus.m
    W = torch.as_tensor(rng.standard_normal((m, 64)), dtype=torch.float32)
    store, _ = pages.from_dense(W, torch.as_tensor(tiny_corpus.doc_tokens),
                                torch.as_tensor(tiny_corpus.doc_mask))
    store.alive[[0, 5]] = False
    psi = Psi.init(16, 64, torch.Generator().manual_seed(0), device="cpu")
    cfg = LemurConfig(d=16, d_prime=64, k=7, k_prime=40)
    r = LemurRetriever.from_arrays(cfg, psi, store,
                                   generator=torch.Generator().manual_seed(1))
    q = synthetic.queries_from_corpus_query(tiny_corpus, 5, q_tokens=4, seed=9)
    s, i = r.search(q)
    assert s.shape == (5, 7) and torch.isfinite(s).all()
    assert ((i >= 0) & (i < m)).all() and not np.isin(i.numpy(), [0, 5]).any()
