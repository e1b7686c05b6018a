"""The port's v0 surface held against the JAX package on the CPU.

* ``core.maxsim_pair`` against JAX's, within 1e-6 relative.
* Every name of JAX's ``repro.core``, ``repro.retriever`` and ``repro.anns``
  ``__all__`` resolves in the port's package of the same place.
* A JAX retriever built on ``tiny_corpus`` (SQ8 IVF lists, some docs
  deleted) and saved, loaded by the port: the dense views (``doc_tokens``,
  ``doc_mask``, ``dense_view``) equal JAX's bit for bit, deleted slots
  all-masked; the v0 ``query`` and ``candidates`` (``use_ann`` both ways,
  ``nprobe`` set and unset) against JAX's on that index, ids equal up to
  counted near-ties (relative gap < 1e-5), scores to rtol 1e-5 / atol 1e-4,
  candidate sets equal; ``attach_backend(index, "bruteforce")`` then
  ``add_docs(..., seed=0)`` then ``query`` against JAX's (the fallback
  solver's W rows agree to fp32 rounding, so ids to near-ties).
* ``build_index`` at small size held at recall level against JAX's on the
  same corpus (the builds draw different random numbers): the port's
  recall@10 at least JAX's minus 0.05.
* The four ``kernels.ops`` entries (``token_maxsim``, ``fused_psi``,
  ``fused_ivf_scan``, ``fused_ivf_scan_res``) against JAX ``repro.kernels.ops``
  with ``use_kernel=False``: fp32 to rtol / atol 1e-5, SQ8 within 2^-16 * 4
  of the largest score, the residual scan to 1e-5 and bit for bit where
  every product and sum is exact (small-integer tables and queries).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.anns as jax_anns
import repro.core as jax_core
import repro.retriever as jax_retriever
from repro.anns.params import IVFBackendConfig as JaxIVFConfig
from repro.anns.quantization import sq8_quant as jax_sq8
from repro.core import index as jax_index
from repro.core import maxsim as jax_maxsim
from repro.core.config import LemurConfig as JaxConfig
from repro.data import synthetic
from repro.kernels import ops as jax_ops
from repro.retriever import LemurRetriever as JaxRetriever

import repro_torch.anns as anns
import repro_torch.core as core
import repro_torch.retriever as retriever
from repro_torch.convert import psi_params_from_numpy
from repro_torch.core import index as v0
from repro_torch.core import maxsim
from repro_torch.core.config import LemurConfig
from repro_torch.core.model import Psi
from repro_torch.kernels import ops
from repro_torch.retriever import LemurRetriever, SearchParams

RTOL, ATOL, TIE = 1e-5, 1e-4, 1e-5
SQ8_RTOL = 2 ** -16 * 4
DELETED = [3, 17, 42, 99, 150, 151, 260]


def T(x):
    return torch.as_tensor(np.array(x))


def assert_same_topk(want_s, want_i, got_s, got_i):
    """Scores within tolerance; an id may differ only at a near-tie."""
    want_s, want_i = np.asarray(want_s), np.asarray(want_i)
    got_s, got_i = got_s.numpy(), got_i.numpy()
    np.testing.assert_allclose(got_s, want_s, rtol=RTOL, atol=ATOL)
    diff = got_i != want_i
    gap = np.abs(got_s - want_s) / np.maximum(np.abs(want_s), 1.0)
    assert np.all(gap[diff] < TIE), "an id differs without a near-tie"
    assert diff.sum() <= max(2, diff.size // 50), f"{diff.sum()} near-tie ids"


# --------------------------------------------------------------------------
# maxsim_pair, the exports
# --------------------------------------------------------------------------

@pytest.mark.parametrize("Tq,Td,d", [(4, 7, 16), (1, 1, 8), (9, 3, 33)])
def test_maxsim_pair_matches_jax(Tq, Td, d):
    rng = np.random.default_rng(Tq * Td + d)
    q = rng.standard_normal((Tq, d)).astype(np.float32)
    c = rng.standard_normal((Td, d)).astype(np.float32)
    qm, cm = rng.random(Tq) > 0.3, rng.random(Td) > 0.3
    qm[0] = cm[0] = True
    want = float(jax_maxsim.maxsim_pair(*map(jnp.asarray, (q, qm, c, cm))))
    got = float(maxsim.maxsim_pair(*map(T, (q, qm, c, cm))))
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want))
    assert float(core.maxsim_pair(*map(T, (q, qm, c, cm)))) == got


@pytest.mark.parametrize("jax_pkg,port_pkg", [(jax_core, core), (jax_retriever, retriever),
                                              (jax_anns, anns)],
                         ids=["core", "retriever", "anns"])
def test_every_jax_export_resolves(jax_pkg, port_pkg):
    """(``anns.kmeans`` resolves to the module, as the port keeps it.)"""
    missing = [n for n in jax_pkg.__all__ if not hasattr(port_pkg, n)]
    assert not missing, missing


def test_init_psi_is_a_psi():
    psi = core.init_psi(torch.Generator().manual_seed(0), 16, 32, device="cpu")
    assert isinstance(psi, Psi) and psi.dense.kernel.shape == (16, 32)
    again = core.init_psi(torch.Generator().manual_seed(0), 16, 32, device="cpu")
    assert torch.equal(psi.dense.kernel, again.dense.kernel)


# --------------------------------------------------------------------------
# a JAX-saved index: dense views, query, candidates
# --------------------------------------------------------------------------

def _cfg() -> JaxConfig:
    return JaxConfig(d=16, d_prime=128, m_pretrain=64, n_train=512, n_ols=256,
                     epochs=2, k=10, k_prime=64, anns="ivf",
                     ivf=JaxIVFConfig(nprobe=8, sq8=True))


@pytest.fixture(scope="module")
def saved(tiny_corpus, tmp_path_factory):
    jr = JaxRetriever.build(tiny_corpus, _cfg(), key=jax.random.PRNGKey(0))
    jr.delete(DELETED)
    path = tmp_path_factory.mktemp("v0_ckpt")
    jr.save(path)
    jr = JaxRetriever.load(path)
    q = synthetic.queries_from_corpus_query(tiny_corpus, 12, q_tokens=6, seed=3)
    qm = np.random.default_rng(4).random(q.shape[:2]) > 0.25
    qm[:, 0] = True
    return jr.index, LemurRetriever.load(path, device="cpu").index, q.astype(np.float32), qm


def test_dense_views_match_jax_bit_for_bit(saved):
    jidx, idx, _, _ = saved
    toks, mask = idx.dense_view()
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jidx.doc_tokens))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jidx.doc_mask))
    assert torch.equal(idx.doc_tokens, toks) and torch.equal(idx.doc_mask, mask)
    assert toks.shape == (idx.m, idx.store.td_max, 16)
    assert not mask[DELETED].any() and not toks[DELETED].any()
    alive = np.setdiff1d(np.arange(idx.m), DELETED)
    assert mask[alive].any(1).all()


@pytest.mark.parametrize("use_ann", [True, False], ids=["ann", "exact"])
@pytest.mark.parametrize("nprobe", [None, 3], ids=["nprobe_default", "nprobe_3"])
def test_query_matches_jax(saved, use_ann, nprobe):
    jidx, idx, q, qm = saved
    want = jax_index.query(jidx, jnp.asarray(q), jnp.asarray(qm), nprobe=nprobe,
                           use_ann=use_ann)
    got = v0.query(idx, q, qm, nprobe=nprobe, use_ann=use_ann)
    assert_same_topk(*want, *got)
    assert not np.isin(got[1].numpy(), DELETED).any()
    # v0 keywords resolve to the facade's params: the same bits
    p = SearchParams(use_ann=use_ann, backend=None if nprobe is None or not use_ann
                     else retriever.IVFSearchParams(nprobe=nprobe))
    s, i = LemurRetriever(idx).search(q, qm, p)
    assert torch.equal(s, got[0]) and torch.equal(i, got[1])


@pytest.mark.parametrize("use_ann", [True, False], ids=["ann", "exact"])
@pytest.mark.parametrize("nprobe", [None, 3], ids=["nprobe_default", "nprobe_3"])
def test_candidates_match_jax(saved, use_ann, nprobe):
    jidx, idx, q, qm = saved
    want = np.asarray(jax_index.candidates(jidx, jnp.asarray(q), jnp.asarray(qm), k_prime=40,
                                           nprobe=nprobe, use_ann=use_ann))
    got = v0.candidates(idx, q, qm, k_prime=40, nprobe=nprobe, use_ann=use_ann).numpy()
    assert got.shape == want.shape == (q.shape[0], 40)
    np.testing.assert_array_equal(np.sort(got, 1), np.sort(want, 1))
    assert not np.isin(got, DELETED).any()


def test_attach_backend_add_docs_query_match_jax(saved, tiny_corpus):
    jidx, idx, q, qm = saved
    new = synthetic.make_corpus(m=12, d=16, avg_tokens=8, max_tokens=12, n_centers=24,
                                seed=5)
    jb = jax_index.attach_backend(jidx, "bruteforce")
    jb = jax_index.add_docs(jb, jnp.asarray(new.doc_tokens), jnp.asarray(new.doc_mask), seed=0)
    b = v0.attach_backend(idx, "bruteforce")
    m0 = idx.m
    b = v0.add_docs(b, new.doc_tokens, new.doc_mask, seed=0)
    assert b.backend == "bruteforce" and b.m == jb.m == m0 + 12
    assert idx.m == m0 and idx.backend == "ivf"          # the v0 index is left as it was
    W, jW = b.store.W[m0:b.m].numpy(), np.asarray(jb.store.W)[m0:jb.m]
    assert np.abs(W - jW).max() <= 1e-3 * np.abs(jW).max()
    want = jax_index.query(jb, jnp.asarray(q), jnp.asarray(qm))
    got = v0.query(b, q, qm)
    assert_same_topk(*want, *got)
    # a new doc's own tokens find it through the new first stage
    probe = new.doc_tokens[0][None]
    _, ids = v0.query(b, probe, new.doc_mask[0][None], k=1)
    assert int(ids[0, 0]) == m0


def test_build_index_recall_matches_jax():
    corpus = synthetic.make_corpus(m=800, d=16, avg_tokens=10, max_tokens=14, n_centers=32,
                                   seed=0)
    jcfg = JaxConfig(d=16, d_prime=64, m_pretrain=256, n_train=2048, n_ols=512, epochs=4,
                     k=10, k_prime=64, anns="ivf", ivf=JaxIVFConfig(nprobe=8))
    jidx = jax_core.build_index(jax.random.PRNGKey(0), corpus, jcfg)
    idx = core.build_index(torch.Generator().manual_seed(0), corpus,
                           LemurConfig.from_dict(jcfg.to_dict()), device="cpu")
    assert idx.m == jidx.m == 800 and idx.backend == "ivf"
    q = synthetic.queries_from_corpus_query(corpus, 64, q_tokens=6, seed=7)
    qm = np.ones(q.shape[:2], bool)
    _, truth = maxsim.true_topk(T(q), T(qm), T(corpus.doc_tokens), T(corpus.doc_mask), 10)
    _, jids = jax_index.query(jidx, jnp.asarray(q), jnp.asarray(qm))
    _, ids = v0.query(idx, q, qm)
    jrec = float(maxsim.recall_at(T(jids), truth).mean())
    rec = float(maxsim.recall_at(ids, truth).mean())
    assert rec >= jrec - 0.05, (rec, jrec)
    assert rec > 2 * jcfg.k_prime / corpus.m, (rec, jrec)   # twice a blind first stage


# --------------------------------------------------------------------------
# the four ops entries
# --------------------------------------------------------------------------

def _psi_arrays(rng, d, dp):
    return {"dense": {"kernel": (rng.standard_normal((d, dp)) / np.sqrt(d)).astype(np.float32),
                      "bias": 0.1 * rng.standard_normal(dp).astype(np.float32)},
            "ln": {"scale": 1 + 0.1 * rng.standard_normal(dp).astype(np.float32),
                   "bias": 0.1 * rng.standard_normal(dp).astype(np.float32)}}


@pytest.mark.parametrize("n,m,Tt,d", [(9, 13, 5, 16), (1, 4, 1, 20)])
def test_ops_token_maxsim_matches_jax(n, m, Tt, d):
    rng = np.random.default_rng(n + m)
    x = rng.standard_normal((n, d)).astype(np.float32)
    docs = rng.standard_normal((m, Tt, d)).astype(np.float32)
    mask = rng.random((m, Tt)) > 0.3
    mask[0] = False                                    # a doc with no valid token
    want = np.asarray(jax_ops.token_maxsim(*map(jnp.asarray, (x, docs, mask)),
                                           use_kernel=False))
    got = ops.token_maxsim(*map(T, (x, docs, mask))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,d,dp", [(7, 16, 64), (1, 20, 128)])
def test_ops_fused_psi_matches_jax(n, d, dp):
    rng = np.random.default_rng(n * d)
    x = rng.standard_normal((n, d)).astype(np.float32)
    p = _psi_arrays(rng, d, dp)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    want = np.asarray(jax_ops.fused_psi(jnp.asarray(x), jp, use_kernel=False))
    as_dict = ops.fused_psi(T(x), psi_params_from_numpy(p, device="cpu"))
    as_psi = ops.fused_psi(T(x), Psi.from_arrays(p["dense"]["kernel"], p["dense"]["bias"],
                                                 p["ln"]["scale"], p["ln"]["bias"],
                                                 device="cpu"))
    np.testing.assert_allclose(as_dict.numpy(), want, rtol=1e-5, atol=1e-5)
    assert torch.equal(as_dict, as_psi)


@pytest.mark.parametrize("sq8", [False, True], ids=["fp32", "sq8"])
@pytest.mark.parametrize("B,nlist,cap,d,nprobe", [(4, 8, 6, 16, 3), (1, 5, 1, 20, 5)])
def test_ops_fused_ivf_scan_matches_jax(B, nlist, cap, d, nprobe, sq8):
    rng = np.random.default_rng(B * nlist + cap + sq8)
    ids = rng.integers(-1, 99, (nlist, cap)).astype(np.int32)
    ids[0] = -1                                        # an all-pad list
    vecs = (rng.standard_normal((nlist, cap, d)) * (ids >= 0)[..., None]).astype(np.float32)
    q = rng.standard_normal((B, d)).astype(np.float32)
    probe = rng.integers(0, nlist, (B, nprobe)).astype(np.int32)
    probe[0, 0] = 0
    lists = [jnp.asarray(vecs)]
    if sq8:
        lists = list(jax_sq8(jnp.asarray(vecs)))
    want = np.asarray(jax_ops.fused_ivf_scan(jnp.asarray(q), jnp.asarray(probe),
                                             jnp.asarray(ids), *lists, use_kernel=False))
    got = ops.fused_ivf_scan(T(q), T(probe), T(ids), *map(T, lists)).numpy()
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    if sq8:
        assert np.abs(got[fin] - want[fin]).max() <= SQ8_RTOL * np.abs(want[fin]).max()
    else:
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("exact", [False, True], ids=["float", "integer"])
@pytest.mark.parametrize("bits", [2, 4])
def test_ops_fused_ivf_scan_res_matches_jax(bits, exact):
    B, nlist, cap, d, nprobe = 3, 6, 7, 16, 4
    rng = np.random.default_rng(bits + 10 * exact)
    ids = rng.integers(-1, 99, (nlist, cap)).astype(np.int32)
    ids[0] = -1
    codes = rng.integers(0, 256, (nlist, cap, d * bits // 8)).astype(np.uint8)
    if exact:   # every product and sum exact in fp32: the decode shows bit for bit
        cent = rng.integers(-3, 4, (nlist, d)).astype(np.float32)
        values = np.sort(rng.integers(-4, 5, (d, 1 << bits)), axis=1).astype(np.float32)
        q = rng.integers(-3, 4, (B, d)).astype(np.float32)
    else:
        cent = rng.standard_normal((nlist, d)).astype(np.float32)
        values = np.sort(rng.standard_normal((d, 1 << bits)), axis=1).astype(np.float32)
        q = rng.standard_normal((B, d)).astype(np.float32)
    probe = rng.integers(0, nlist, (B, nprobe)).astype(np.int32)
    args = (q, probe, ids, codes, cent, values)
    want = np.asarray(jax_ops.fused_ivf_scan_res(*map(jnp.asarray, args), use_kernel=False))
    got = ops.fused_ivf_scan_res(*map(T, args)).numpy()
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        fin = np.isfinite(want)
        np.testing.assert_array_equal(np.isfinite(got), fin)
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-5)
