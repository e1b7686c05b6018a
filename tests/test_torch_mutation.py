"""The port's mutation (add, delete, update, clone, snapshot, install_refresh)
held against the JAX package on the same inputs, on the CPU.

* ``core/pages``: ``add_docs`` / ``delete_docs`` / ``free_list`` on stores
  that JAX's and the port's ``from_dense`` build from one numpy corpus, the
  same W rows given to both: every field, the free list and the byte counts
  bit for bit, also through a pages-a-doc growth, a slot-capacity growth and
  a pool growth, fp32 and the compressed tier (2 and 4 bits); the
  ``ValueError``s and the mutation taps as JAX's.
* ``anns/ivf``: ``extend_ivf`` given the same rows (fp32, SQ8, residual
  lists at 2 and 4 bits) equals JAX's full re-pack bit for bit, through a
  list-capacity doubling; ``_residual_pack`` too.
* The facade: a JAX-built retriever (SQ8 and fp32 lists, residual lists at
  2 and 4 bits with the compressed token tier) is saved, the port loads it,
  and both run one add / delete / update sequence.  Ids equal JAX's on the
  default, one-launch, exact and legacy routes up to counted near-ties (the
  frameworks sum fp32 products in other orders); the new W rows are within
  1e-3 x max|W| of JAX's ``fit_docs`` (two Cholesky factors of one Gram
  matrix); pages, tables, free list, byte counts, version, list ids and
  counts equal JAX's bit for bit.
* A held snapshot and a clone keep their results bit for bit while the
  other side mutates; with no other view an add within capacity keeps the
  pool's and W's storage; ``install_refresh`` takes a JAX-built refresh
  (``lifecycle.build_refresh``) as JAX does, and each corrupt refresh
  raises ``CorruptIndexError`` with the retriever untouched;
  ``trace_count`` gives JAX's counts; JAX serves a port save made after
  mutation; a legacy dense checkpoint loads; the fallback solver draws
  JAX's OLS tokens.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.anns import ivf as jivf
from repro.anns.params import IVFBackendConfig as JaxIVFConfig
from repro.anns.params import IVFSearchParams as JaxIVFParams
from repro.anns.params import ResidualConfig as JaxResidual
from repro.anns.quantization import train_residual_codec as jax_train_codec
from repro.checkpoint import manager as jckpt
from repro.core import pages as jpages
from repro.core.config import LemurConfig as JaxConfig
from repro.data import synthetic
from repro.lifecycle.refresh import build_refresh
from repro.retriever import LemurRetriever as JaxRetriever
from repro.retriever import SearchParams as JaxParams

from repro_torch import convert
from repro_torch.anns import ivf as pivf
from repro_torch.anns.quantization import ResidualCodec
from repro_torch.core import pages
from repro_torch.retriever import (
    CorruptIndexError,
    IVFSearchParams,
    LemurRetriever,
    SearchParams,
)
from repro_torch.retriever.facade import search_pipeline

RTOL, ATOL, TIE = 1e-5, 1e-4, 1e-5
W_TOL = 1e-3              # x max|W|: JAX's upper and the port's lower factor
DELETED = [3, 17, 42]
ROUTES = {   # name: (JAX params, port params)
    "default": (JaxParams(), SearchParams()),
    "one_launch": (JaxParams(backend=JaxIVFParams(use_one_launch=True)),
                   SearchParams(backend=IVFSearchParams(use_one_launch=True))),
    "exact": (JaxParams(use_ann=False, use_one_launch=True),
              SearchParams(use_ann=False, use_one_launch=True)),
    "legacy": (JaxParams(use_fused_gather=False,
                         backend=JaxIVFParams(use_fused_gather=False)),
               SearchParams(use_fused_gather=False,
                            backend=IVFSearchParams(use_fused_gather=False))),
}
VARIANTS = ["sq8", "fp32", "res2", "res4"]


def np_(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_same_topk(s_ref, i_ref, s_got, i_got):
    """Scores within tolerance; differing ids only at counted near-ties."""
    s_ref, i_ref, s_got, i_got = map(np_, (s_ref, i_ref, s_got, i_got))
    assert s_got.shape == s_ref.shape
    np.testing.assert_allclose(s_got, s_ref, rtol=RTOL, atol=ATOL)
    diff = i_got != i_ref
    gap = np.abs(s_got - s_ref) / np.maximum(np.abs(s_ref), 1.0)
    assert np.all(gap[diff] < TIE), "an id differs without a near-tie"
    assert diff.sum() <= max(1, diff.size // 50), f"{diff.sum()} near-ties"


def corpus(m, seed, max_tokens=12):
    return synthetic.make_corpus(m=m, d=16, avg_tokens=8, max_tokens=max_tokens,
                                 n_centers=24, seed=seed)


def jax_cfg(variant: str) -> JaxConfig:
    ivf = JaxIVFConfig(nprobe=8, sq8=variant == "sq8")
    extra = {}
    if variant.startswith("res"):
        bits = int(variant[3])
        ivf = JaxIVFConfig(nprobe=8, residual_bits=bits)
        extra = dict(residual=JaxResidual(enabled=True, bits=bits, ncent=32, kmeans_iters=3))
    return JaxConfig(d=16, d_prime=64, m_pretrain=64, n_train=512, n_ols=256, epochs=2,
                     k=10, k_prime=48, anns="ivf", ivf=ivf, **extra)


def queries(c, n=10, seed=3):
    q = synthetic.queries_from_corpus_query(c, n, q_tokens=6, seed=seed).astype(np.float32)
    qm = np.random.default_rng(seed + 1).random(q.shape[:2]) > 0.25
    qm[:, 0] = True
    return q, qm


def churn(r, new, old=(3, 17)):
    """One add / delete / update sequence (``old``: two live ids it deletes
    and replaces); returns the ids that must never surface again."""
    m0 = r.m
    r.add(new.doc_tokens[:24], new.doc_mask[:24])
    added = np.asarray(r.last_added_ids)
    r.delete([old[0], int(added[2]), int(added[5])])
    ids = r.update([old[1], int(added[7])], new.doc_tokens[24:27], new.doc_mask[24:27])
    assert list(np.asarray(ids)) == [m0 + 24, m0 + 25, m0 + 26]
    return [old[0], old[1], int(added[2]), int(added[5]), int(added[7])]


def state_equal(jr, pr, m_exact):
    """Pages, tables, counts, tombstones, the free list, byte counts and the
    version bit for bit; W within W_TOL; the lists' ids and counts bit for
    bit, and their rows of ids below ``m_exact`` and pads (rows from W rows
    both sides hold alike; the newly fit ones differ within W_TOL)."""
    js, ps = jr.index.store, pr.index.store
    names = ["tok_pages", "page_table", "n_tokens", "alive", "n_docs"]
    if js.codec is not None:
        names += ["cent_pages", "code_pages"]
    for k in names:
        assert np.array_equal(np.asarray(getattr(js, k)), np_(getattr(ps, k))), k
    W = np.asarray(js.W)
    assert np.abs(np_(ps.W) - W).max() <= W_TOL * np.abs(W).max()
    assert pr._free() == jr._free()
    assert pages.free_list(ps) == jpages.free_list(js)
    assert (pr.version, pr.last_mutation_bytes, pr.bytes_moved) == (
        jr.version, jr.last_mutation_bytes, jr.bytes_moved)
    ja, pa = jr.index.ann, pr.index.ann
    for k in ("ids", "counts"):
        assert np.array_equal(np.asarray(getattr(ja, k)), np_(getattr(pa, k))), k
    # the rows built before the churn, and every pad row, are the same bits
    old = np.asarray(ja.ids) < m_exact
    assert np.array_equal(np.asarray(ja.vecs)[old], np_(pa.vecs)[old])
    if ja.scales is not None:
        assert np.array_equal(np.asarray(ja.scales)[old], np_(pa.scales)[old])


# --------------------------------------------------------------------------
# pages
# --------------------------------------------------------------------------

def stores(tier: str, seed=0):
    """JAX's and the port's store over one corpus (tier fp32, res2, res4)."""
    c = corpus(40, seed)
    W = np.random.default_rng(seed).standard_normal((40, 8)).astype(np.float32)
    codec_j = codec_p = None
    if tier != "fp32":
        flat = c.doc_tokens[c.doc_mask]
        codec_j = jax_train_codec(jax.random.PRNGKey(1), jnp.asarray(flat), bits=int(tier[3]),
                                  ncent=8, iters=2)
        codec_p = ResidualCodec(*(torch.from_numpy(np.array(t)) for t in codec_j))
    js, jb = jpages.from_dense(W, c.doc_tokens, c.doc_mask, codec=codec_j)
    ps, pb = pages.from_dense(torch.from_numpy(W), torch.from_numpy(c.doc_tokens),
                              torch.from_numpy(c.doc_mask), codec=codec_p)
    assert jb == pb
    return js, ps


def long_docs(lengths, d=16, seed=3):
    """Docs of the given token counts (a corpus-like namespace)."""
    T = max(lengths)
    toks = np.random.default_rng(seed).standard_normal((len(lengths), T, d)).astype(np.float32)
    mask = np.arange(T)[None, :] < np.asarray(lengths)[:, None]
    return types.SimpleNamespace(m=len(lengths), doc_tokens=toks * mask[..., None],
                                 doc_mask=mask)


def store_equal(js, ps):
    for k in js._fields:
        a, b = getattr(js, k), getattr(ps, k)
        if k == "codec" or a is None:
            continue
        assert np.array_equal(np.asarray(a), np_(b)), k
    assert ps.td_max == js.td_max


@pytest.mark.parametrize("tier", ["fp32", "res2", "res4"])
def test_add_delete_pages_match_jax(tier):
    """A sequence through every growth bucket: a delete, an add that reuses
    the freed pages, a doc longer than any before (table width 1 -> 4), an
    add past the slot capacity (64 -> 128) and past the pool."""
    js, ps = stores(tier)
    jfree, pfree = jpages.free_list(js), pages.free_list(ps)
    assert jfree == pfree
    rng = np.random.default_rng(5)
    steps = [("delete", [1, 7, 8, 30]), ("add", corpus(6, 11)),
             ("add", long_docs([60, 5, 33])), ("delete", [0, 41]),
             ("add", corpus(30, 13)), ("add", corpus(90, 14)), ("delete", [45, 100, 2])]
    for kind, arg in steps:
        if kind == "delete":
            js, jfree, jb = jpages.delete_docs(js, jfree, arg)
            ps, pfree, pb = pages.delete_docs(ps, pfree, arg)
        else:
            w = rng.standard_normal((arg.m, 8)).astype(np.float32)
            js, jfree, jids, jb = jpages.add_docs(js, jfree, w, arg.doc_tokens, arg.doc_mask)
            ps, pfree, pids, pb = pages.add_docs(ps, pfree, torch.from_numpy(w),
                                                 torch.from_numpy(arg.doc_tokens),
                                                 torch.from_numpy(arg.doc_mask))
            assert np.array_equal(jids, pids) and pids.dtype == np.int32
        assert jb == pb and jfree == pfree, kind
        store_equal(js, ps)
        assert pages.free_list(ps) == jpages.free_list(js)
    assert ps.capacity == 256 and ps.pages_per_doc == 4


def test_delete_errors_match_jax():
    js, ps = stores("fp32")
    for bad in ([3, 3], [40], [-1], [5, 999]):
        with pytest.raises(ValueError) as je:
            jpages.delete_docs(js, [], bad)
        with pytest.raises(ValueError) as pe:
            pages.delete_docs(ps, [], bad)
        assert str(pe.value) == str(je.value)
    js, _, _ = jpages.delete_docs(js, [], [4])
    ps, _, _ = pages.delete_docs(ps, [], [4])
    with pytest.raises(ValueError) as je:
        jpages.delete_docs(js, [], [6, 4])
    with pytest.raises(ValueError) as pe:
        pages.delete_docs(ps, [], [6, 4])
    assert str(pe.value) == str(je.value) == "doc ids already deleted: [4]"
    assert pages.dense_add_bytes(900, 80, 128, 2048) == jpages.dense_add_bytes(900, 80, 128, 2048)


def test_shared_fields_are_copied_once():
    """A field named in ``shared`` is copied before its first write and
    leaves the set; the others are written in place."""
    _, ps = stores("fp32")
    held = ps
    before = {k: getattr(held, k).clone() for k in ("tok_pages", "W", "alive")}
    shared = {"tok_pages", "W", "alive", "page_table", "n_tokens", "n_docs"}
    c = corpus(2, 21)
    new, free, _, _ = pages.add_docs(ps, pages.free_list(ps), torch.ones((2, 8)),
                                     torch.from_numpy(c.doc_tokens),
                                     torch.from_numpy(c.doc_mask), shared=shared)
    assert not shared
    for k, v in before.items():
        assert torch.equal(getattr(held, k), v) and not torch.equal(getattr(new, k), v)
    ptr = new.W.data_ptr()
    new, _, _ = pages.delete_docs(new, free, [0], shared=shared)
    assert new.W.data_ptr() == ptr and torch.equal(held.W, before["W"])


def test_mutation_taps_match_jax():
    seen = {"jax": [], "port": []}

    def tap(name):
        def fn(kind, ids, **payload):
            seen[name].append((kind, np.asarray(ids).tolist(), sorted(payload),
                               np.asarray(payload["w"]).shape if "w" in payload else None))
        return fn

    jt, pt = tap("jax"), tap("port")
    jpages.register_mutation_tap(jt)
    pages.register_mutation_tap(pt)
    pages.register_mutation_tap(pt)
    pages.register_mutation_tap(lambda *a, **k: 1 / 0)     # swallowed
    try:
        js, ps = stores("fp32")
        c = corpus(3, 31)
        w = np.ones((3, 8), np.float32)
        js, jf, _, _ = jpages.add_docs(js, jpages.free_list(js), w, c.doc_tokens, c.doc_mask)
        ps, pf, _, _ = pages.add_docs(ps, pages.free_list(ps), torch.from_numpy(w),
                                      torch.from_numpy(c.doc_tokens),
                                      torch.from_numpy(c.doc_mask))
        jpages.delete_docs(js, jf, [2, 41])
        pages.delete_docs(ps, pf, [2, 41])
    finally:
        jpages.unregister_mutation_tap(jt)
        pages.unregister_mutation_tap(pt)
        pages._MUTATION_TAPS.clear()
    assert seen["port"] == seen["jax"] and len(seen["jax"]) == 2
    pages.unregister_mutation_tap(pt)                       # absent: no error


# --------------------------------------------------------------------------
# IVF growth
# --------------------------------------------------------------------------

def jax_ann_arrays(ann):
    return {k: (None if v is None else np.asarray(v)) for k, v in ann._asdict().items()}


def ann_equal(ja, pa):
    for k, v in ja._asdict().items():
        if v is None:
            assert getattr(pa, k) is None, k
        else:
            assert np.array_equal(np.asarray(v), np_(getattr(pa, k))), k


@pytest.mark.parametrize("kind", ["fp32", "sq8", "res2", "res4", "res4_ties"])
def test_extend_ivf_matches_jax(kind):
    """Three rounds of the same rows into JAX's and the port's lists; the
    last sends 300 rows to one list, past its capacity (64 -> 512).
    ``res4_ties``: half the rows zero (dead slots of a rebuilt index), so
    quantiles tie, a value sits on a cut and JAX's re-pack moves stored
    codes; the port re-encodes them alike."""
    rng = np.random.default_rng(2)
    X = rng.standard_normal((500, 32)).astype(np.float32)
    if kind == "res4_ties":
        X[::2] = 0.0
    kw = dict(sq8=kind == "sq8", residual_bits=int(kind[3]) if kind.startswith("res") else 0)
    ja = jivf.build_ivf(jax.random.PRNGKey(0), jnp.asarray(X), 16, **kw)
    pa = convert.ann_from_numpy(jax_ann_arrays(ja), "cpu")
    ann_equal(ja, pa)
    if kind == "res4_ties":
        moved = jivf.extend_ivf(ja, jnp.zeros((0, 32), jnp.float32))
        assert (np.asarray(moved.vecs) != np.asarray(ja.vecs)).any()
    for rnd in range(3):
        new = rng.standard_normal((40, 32)).astype(np.float32)
        if rnd == 2:
            new = np.asarray(ja.centroids[3] + ja.mean)[None] + 0.01 * rng.standard_normal(
                (300, 32)).astype(np.float32)
        ja = jivf.extend_ivf(ja, jnp.asarray(new))
        pa = pivf.extend_ivf(pa, torch.from_numpy(new))
        ann_equal(ja, pa)
    assert pa.capacity == 512
    got = pivf.assign_clusters(torch.from_numpy(X), pa.centroids)
    assert np.array_equal(got.numpy(), np.asarray(jivf.assign_clusters(jnp.asarray(X),
                                                                      ja.centroids)))


@pytest.mark.parametrize("bits", [2, 4])
def test_residual_pack_matches_jax(bits):
    rng = np.random.default_rng(bits)
    X = rng.standard_normal((300, 24)).astype(np.float32)
    ja = jivf.build_ivf(jax.random.PRNGKey(0), jnp.asarray(X), 8, residual_bits=bits)
    fp = np.array(jivf._residual_unpack(ja))
    want = jivf._residual_pack(ja.centroids, ja.rq_cuts, ja.rq_values, ja.ids, jnp.asarray(fp))
    pa = convert.ann_from_numpy(jax_ann_arrays(ja), "cpu")
    got = pivf._residual_pack(pa.centroids, pa.rq_cuts, pa.rq_values, pa.ids,
                              torch.from_numpy(fp))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got.numpy(), np.asarray(ja.vecs))     # codes are stable


def test_extend_ivf_copies_shared_fields():
    X = np.random.default_rng(0).standard_normal((100, 8)).astype(np.float32)
    pa = pivf.build_ivf(torch.from_numpy(X), 4, sq8=True, generator=torch.Generator().manual_seed(0))
    shared = {"ids", "vecs", "scales", "counts"}
    held = {k: getattr(pa, k).clone() for k in shared}
    new = pivf.extend_ivf(pa, torch.from_numpy(X[:5]), shared=shared)
    assert not shared and int(new.counts.sum()) == 105
    for k, v in held.items():
        assert torch.equal(getattr(pa, k), v), k
    ptr = new.vecs.data_ptr()
    assert pivf.extend_ivf(new, torch.from_numpy(X[:1])).vecs.data_ptr() == ptr


# --------------------------------------------------------------------------
# the facade
# --------------------------------------------------------------------------

@pytest.fixture(scope="module", params=VARIANTS)
def saved(request, tiny_corpus, tmp_path_factory):
    """A JAX retriever built on tiny_corpus (some docs deleted), saved."""
    r = JaxRetriever.build(tiny_corpus, jax_cfg(request.param), key=jax.random.PRNGKey(0))
    r.delete(DELETED[2:])
    path = tmp_path_factory.mktemp(f"mut_{request.param}")
    r.save(path)
    return request.param, path


@pytest.fixture(scope="module")
def churned(saved, tiny_corpus):
    """JAX and the port, each loaded from the save, after one churn."""
    variant, path = saved
    jr, pr = JaxRetriever.load(path), LemurRetriever.load(path, device="cpu")
    new = corpus(30, 9)
    gone = churn(jr, new)
    assert churn(pr, new) == gone
    return variant, jr, pr, gone


def test_churn_state_matches_jax(churned):
    variant, jr, pr, _ = churned
    state_equal(jr, pr, jr.m - 27)
    assert pr.m == jr.m and pr.n_alive == jr.n_alive
    assert np.array_equal(pr.last_added_ids, np.asarray(jr.last_added_ids))
    if variant.startswith("res"):
        assert pr.index.store.residual and pr.index.ann.residual


@pytest.mark.parametrize("route", list(ROUTES))
def test_churn_routes_match_jax(churned, tiny_corpus, route):
    _, jr, pr, gone = churned
    jp, pp = ROUTES[route]
    q, qm = queries(tiny_corpus)
    want = jr.search(jnp.asarray(q), jnp.asarray(qm), jp)
    got = pr.search(q, qm, pp)
    assert_same_topk(*want, *got)
    assert not np.isin(got[1].numpy(), gone).any()
    cand = pr.candidates(q, qm, pp)
    assert cand.shape == (q.shape[0], pr.resolve(pp).k_prime)
    assert not np.isin(cand.numpy(), gone).any()


def test_new_w_rows_match_jax_fit_docs(churned):
    _, jr, pr, _ = churned
    new = np.asarray(pr.last_added_ids)
    W = np.asarray(jr.index.store.W)[new]
    assert np.abs(pr.index.store.W[new].numpy() - W).max() <= W_TOL * np.abs(W).max()


def test_jax_serves_a_port_save_after_mutation(churned, tiny_corpus, tmp_path):
    _, jr, pr, gone = churned
    pr.save(tmp_path)
    back = JaxRetriever.load(tmp_path)
    q, qm = queries(tiny_corpus)
    want = back.search(jnp.asarray(q), jnp.asarray(qm))
    assert_same_topk(*want, *pr.search(q, qm))
    assert not np.isin(np.asarray(want[1]), gone).any()
    assert np.array_equal(np.asarray(back.index.store.alive), pr.index.store.alive.numpy())


def test_snapshot_and_clone_keep_their_results(saved, tiny_corpus):
    """A held snapshot and a clone answer their own corpus bit for bit while
    the other retriever mutates, and the clone's own mutation leaves the
    original as it was."""
    _, path = saved
    r = LemurRetriever.load(path, device="cpu")
    q, qm = queries(tiny_corpus)
    q, qm = torch.from_numpy(q), torch.from_numpy(qm)
    snap = r.snapshot()
    p = r.resolve(SearchParams(use_ann=False, use_one_launch=True))
    want = search_pipeline(snap, q, qm, p)
    twin = r.clone()
    assert twin.version == r.version
    want_twin = [twin.search(q, qm, pp) for _, pp in ROUTES.values()]
    churn(r, corpus(30, 9))
    got = search_pipeline(snap, q, qm, p)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for (_, pp), w in zip(ROUTES.values(), want_twin):
        g = twin.search(q, qm, pp)
        assert torch.equal(g[0], w[0]) and torch.equal(g[1], w[1])
    after = [r.search(q, qm, pp) for _, pp in ROUTES.values()]
    twin.add(corpus(5, 40).doc_tokens, corpus(5, 40).doc_mask)
    twin.delete([0, 1])
    for (_, pp), w in zip(ROUTES.values(), after):
        g = r.search(q, qm, pp)
        assert torch.equal(g[0], w[0]) and torch.equal(g[1], w[1])


def test_in_capacity_add_writes_in_place(saved):
    _, path = saved
    r = LemurRetriever.load(path, device="cpu")
    st = r.index.store
    pool = (st.tok_pages if not st.residual else st.code_pages).data_ptr()
    W = st.W.data_ptr()
    c = corpus(4, 50)
    r.add(c.doc_tokens, c.doc_mask)
    r.delete([int(r.last_added_ids[0]), 5])
    st = r.index.store
    assert st.W.data_ptr() == W
    assert (st.tok_pages if not st.residual else st.code_pages).data_ptr() == pool
    r.snapshot()
    r.add(c.doc_tokens, c.doc_mask)
    assert r.index.store.W.data_ptr() != W


# --------------------------------------------------------------------------
# install_refresh
# --------------------------------------------------------------------------

def port_refresh(res):
    return convert.refresh_from_numpy(
        res.backend, res.m0, np.asarray(res.W), jax_ann_arrays(res.ann),
        {"chol": (np.asarray(res.solver["chol"][0]), res.solver["chol"][1]),
         "feats": np.asarray(res.solver["feats"]), "x_ols": np.asarray(res.solver["x_ols"])},
        device="cpu")


def test_install_refresh_matches_jax(saved, tiny_corpus):
    """A refresh built by JAX over the loaded index, installed after a churn
    (so slots [m0, m) are caught up with the new solver) in both."""
    variant, path = saved
    jr, pr = JaxRetriever.load(path), LemurRetriever.load(path, device="cpu")
    res = build_refresh(jr, seed=1)
    new = corpus(30, 9)
    churn(jr, new)
    churn(pr, new)
    jr.install_refresh(res)
    pr.install_refresh(port_refresh(res))
    assert pr.version == jr.version and pr._last_refresh_caught_up == jr._last_refresh_caught_up
    state_equal(jr, pr, res.m0)
    q, qm = queries(tiny_corpus)
    for route in ("default", "exact"):
        jp, pp = ROUTES[route]
        assert_same_topk(*jr.search(jnp.asarray(q), jnp.asarray(qm), jp), *pr.search(q, qm, pp))
    # the refresh's own tensors were not written by the catch-up
    assert np.array_equal(port_refresh(res).ann.ids.numpy(), np.asarray(res.ann.ids))
    # an add after the swap uses the refresh's solver in both
    churn(jr, corpus(30, 19), old=(5, 19))
    churn(pr, corpus(30, 19), old=(5, 19))
    state_equal(jr, pr, res.m0)


CORRUPT = {   # name: (change to the refresh, message fragment)
    "backend": (lambda f: f._replace(backend="muvera"), "backend"),
    "m0_zero": (lambda f: f._replace(m0=0), "outside"),
    "m0_past": (lambda f: f._replace(m0=10_000), "outside"),
    "w_shape": (lambda f: f._replace(W=f.W[:, :5]), "W shape"),
    "w_nan": (lambda f: f._replace(W=f.W.clone().fill_(float("nan"))), "non-finite values"),
    "solver_keys": (lambda f: f._replace(solver={"chol": f.solver["chol"]}), "missing"),
    "chol_nan": (lambda f: f._replace(solver={**f.solver, "chol": f.solver["chol"] * float("nan")}),
                 "Gram factor"),
    "probe_fails": (lambda f: f._replace(ann=f.ann._replace(centroids=f.ann.centroids[:, :3])),
                    "probe search"),
    "ids_out_of_range": (lambda f: f._replace(ann=f.ann._replace(ids=f.ann.ids + 10_000)),
                         "out-of-range"),
}


@pytest.fixture(scope="module")
def refresh_case(tmp_path_factory, tiny_corpus):
    r = JaxRetriever.build(tiny_corpus, jax_cfg("sq8"), key=jax.random.PRNGKey(0))
    path = tmp_path_factory.mktemp("refresh")
    r.save(path)
    return path, build_refresh(r, seed=2)


@pytest.mark.parametrize("name", list(CORRUPT))
def test_corrupt_refresh_leaves_the_retriever_untouched(refresh_case, name):
    path, res = refresh_case
    pr = LemurRetriever.load(path, device="cpu")
    pr.add(corpus(3, 60).doc_tokens, corpus(3, 60).doc_mask)
    before = [t.clone() for t in (*pr.index.store[:6], *pr.index.ann[1:5])]
    version, ann, store = pr.version, pr.index.ann, pr.index.store
    change, msg = CORRUPT[name]
    with pytest.raises(CorruptIndexError, match=msg) as e:
        pr.install_refresh(change(port_refresh(res)))
    assert isinstance(e.value, ValueError) and e.value.preserves_replica_state
    assert pr.version == version and pr.index.ann is ann and pr.index.store is store
    after = (*pr.index.store[:6], *pr.index.ann[1:5])
    assert all(torch.equal(a, b) for a, b in zip(before, after))


# --------------------------------------------------------------------------
# compile accounting, persistence, the fallback solver
# --------------------------------------------------------------------------

def test_trace_count_matches_jax(saved, tiny_corpus):
    """The sequence of tests/test_retriever.py's compile-cache contract on
    both packages: repeated searches, an equal spelling, new params, a new
    batch shape, an add within capacity (nothing), a bucket growth (one)."""
    _, path = saved
    q, qm = queries(tiny_corpus)
    counts = {}
    for name, r, P, cast in (("jax", JaxRetriever.load(path), JaxParams, jnp.asarray),
                             ("port", LemurRetriever.load(path, device="cpu"), SearchParams,
                              lambda x: x)):
        exact, ann = P(k=5, use_ann=False), P(k=5)
        seq = []
        for _ in range(3):
            r.search(cast(q), cast(qm), ann)
        seq.append(r.trace_count(ann))
        r.search(cast(q), cast(qm), P(k=5, k_prime=r.cfg.k_prime))
        r.search(cast(q), cast(qm), exact)
        seq += [r.trace_count(ann), r.trace_count(exact), r.trace_count()]
        r.search(cast(q[:3]), cast(qm[:3]), ann)
        seq.append(r.trace_count(ann))
        r.add(tiny_corpus.doc_tokens[:15], tiny_corpus.doc_mask[:15])
        r.search(cast(q), cast(qm), ann)
        r.search(cast(q), cast(qm), exact)
        seq += [r.trace_count(ann), r.trace_count(exact)]
        big = corpus(600, 70)
        r.add(big.doc_tokens, big.doc_mask)
        r.search(cast(q), cast(qm), ann)
        r.search(cast(q), cast(qm), exact)
        seq += [r.trace_count(ann), r.trace_count(exact), r.trace_count()]
        counts[name] = (seq, {tuple(k): v for k, v in r.trace_shapes().items()})
    assert counts["port"] == counts["jax"]
    assert counts["port"][0][:6] == [1, 1, 1, 2, 2, 2]


def test_legacy_dense_checkpoint_loads(refresh_case, tiny_corpus, tmp_path):
    """A pre-paged checkpoint (W, doc_tokens, doc_mask) is paged on load by
    both packages and served alike."""
    path, _ = refresh_case
    jr = JaxRetriever.load(path)
    idx = jr.index
    from repro.anns import registry

    ann, meta = registry.get_backend("ivf").pack_state(idx.ann)
    tree = {"psi": idx.psi, "stats": {"mean": idx.stats.mean, "std": idx.stats.std},
            "W": idx.W, "doc_tokens": jnp.asarray(tiny_corpus.doc_tokens),
            "doc_mask": jnp.asarray(tiny_corpus.doc_mask), "ann": dict(ann)}
    jckpt.save(tmp_path, 0, tree, extra={"format": "lemur-retriever-v1",
                                         "cfg": idx.cfg.to_dict(), "backend": "ivf",
                                         "ann_meta": meta})
    jl, pl = JaxRetriever.load(tmp_path), LemurRetriever.load(tmp_path, device="cpu")
    store_equal(jl.index.store, pl.index.store)
    q, qm = queries(tiny_corpus)
    assert_same_topk(*jl.search(jnp.asarray(q), jnp.asarray(qm)), *pl.search(q, qm))


def test_fallback_solver_draws_jax_tokens(saved, tiny_corpus):
    """With no solver and no OLS tokens, the seeded fallback picks JAX's
    tokens (read through the page table; decoded on the compressed tier),
    and the W rows it fits agree with JAX's."""
    _, path = saved
    jl = JaxRetriever.load(path)
    tree, extra = convert.index_to_numpy(LemurRetriever.load(path, device="cpu").index)
    jr = JaxRetriever(jl.index)
    pr = LemurRetriever(convert.index_from_numpy(tree, extra, device="cpu"))
    assert pr.x_ols is None and jr._x_ols is None
    js, ps = jr._ensure_solver(7), pr._ensure_solver(7)
    assert np.array_equal(ps["x_ols"].numpy(), np.asarray(js["x_ols"]))
    c = corpus(6, 80)
    jr.add(c.doc_tokens, c.doc_mask, seed=7)
    pr.add(c.doc_tokens, c.doc_mask, seed=7)
    W = np.asarray(jr.index.store.W)
    assert np.abs(pr.index.store.W.numpy() - W).max() <= W_TOL * np.abs(W).max()


def test_solver_conversion_round_trip(saved):
    _, path = saved
    jr = JaxRetriever.load(path)
    js = jr._ensure_solver(0)
    ps = convert.solver_from_numpy({"chol": tuple(np.asarray(x) if i == 0 else x
                                                  for i, x in enumerate(js["chol"])),
                                    "feats": np.asarray(js["feats"]),
                                    "x_ols": np.asarray(js["x_ols"])}, "cpu")
    assert np.array_equal(ps["chol"].numpy(), np.asarray(js["chol"][0]).T)
    back = convert.solver_to_numpy(ps)
    assert back["chol"][1] is False and np.array_equal(back["chol"][0], np.asarray(js["chol"][0]))
    assert np.array_equal(back["x_ols"], np.asarray(js["x_ols"]))
