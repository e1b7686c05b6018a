"""The residual tier served and built by the port, held against the JAX
retriever.

A JAX ``LemurRetriever`` is built on ``tiny_corpus`` with the compressed
token store (``ResidualConfig(enabled=True, bits=b)``) and residual IVF
lists (``ivf.residual_bits=b``), b in {2, 4}, some docs deleted, and saved;
the port loads the checkpoint on the CPU and serves five routes:

* ``SearchParams()``: the residual scan and the compressed paged rerank;
* the one-launch IVF, ``IVFSearchParams(use_one_launch=True)``;
* ``use_residual=False``: the legacy rerank over decoded tokens;
* ``use_fused_gather=False`` on the scan and on the rerank: decode-then-score;
* the exact latent scan, ``use_ann=False``.

Each returns JAX's ids and scores and ``launches()`` equals JAX's plan.  A
port save of the tier is served by JAX with the same ids, a whole port
build with the tier is held at recall level against the JAX build, and the
tier leaves the build's psi, W and IVF as they are without it.

Tolerance: the frameworks sum fp32 products in other orders, so scores
agree to rtol 1e-5 / atol 1e-4 and ids up to counted near-ties (relative
score gap < 1e-5); recall at least JAX's minus 0.05 (the builds draw
different random numbers).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.anns.params import IVFBackendConfig as JaxIVFConfig
from repro.anns.params import IVFSearchParams as JaxIVFParams
from repro.anns.params import ResidualConfig as JaxResidual
from repro.configs.lemur_paper import SMOKE
from repro.core.config import LemurConfig as JaxConfig
from repro.data import synthetic
from repro.retriever import LemurRetriever as JaxRetriever
from repro.retriever import SearchParams as JaxParams

from repro_torch.core import maxsim
from repro_torch.core.config import LemurConfig
from repro_torch.retriever import IVFSearchParams, LemurRetriever, SearchParams

RTOL, ATOL, TIE = 1e-5, 1e-4, 1e-5
DELETED = [3, 17, 42, 99, 150]

#: route name -> (JAX spelling, port spelling)
ROUTES = {
    "default": (JaxParams(), SearchParams()),
    "one_launch_ivf": (JaxParams(backend=JaxIVFParams(use_one_launch=True)),
                       SearchParams(backend=IVFSearchParams(use_one_launch=True))),
    "residual_off": (JaxParams(use_residual=False), SearchParams(use_residual=False)),
    "legacy_scan_and_rerank": (
        JaxParams(use_fused_gather=False, backend=JaxIVFParams(use_fused_gather=False)),
        SearchParams(use_fused_gather=False, backend=IVFSearchParams(use_fused_gather=False))),
    "exact": (JaxParams(use_ann=False), SearchParams(use_ann=False)),
}


def T(x):
    return torch.as_tensor(np.array(x))


def residual_cfg(bits: int) -> JaxConfig:
    return JaxConfig(d=16, d_prime=128, m_pretrain=64, n_train=512, n_ols=256, epochs=2,
                     k=10, k_prime=64, anns="ivf",
                     ivf=JaxIVFConfig(nprobe=8, residual_bits=bits),
                     residual=JaxResidual(enabled=True, bits=bits, ncent=32,
                                          kmeans_iters=3))


@pytest.fixture(scope="module", params=[2, 4], ids=["2bit", "4bit"])
def built(request, tiny_corpus, tmp_path_factory):
    r = JaxRetriever.build(tiny_corpus, residual_cfg(request.param),
                           key=jax.random.PRNGKey(0))
    r.delete(DELETED)
    path = tmp_path_factory.mktemp(f"residual_{request.param}")
    r.save(path)
    q = synthetic.queries_from_corpus_query(tiny_corpus, 12, q_tokens=6, seed=3)
    qm = np.random.default_rng(4).random(q.shape[:2]) > 0.25
    qm[:, 0] = True
    return r, LemurRetriever.load(path, device="cpu"), q.astype(np.float32), qm


def assert_same_topk(s_ref, i_ref, s_got, i_got):
    s_ref, i_ref = np.asarray(s_ref), np.asarray(i_ref)
    s_got, i_got = np.asarray(s_got), np.asarray(i_got)
    np.testing.assert_allclose(s_got, s_ref, rtol=RTOL, atol=ATOL)
    diff = i_got != i_ref
    gap = np.abs(s_got - s_ref) / np.maximum(np.abs(s_ref), 1.0)
    assert np.all(gap[diff] < TIE), "an id differs without a near-tie"
    assert diff.sum() <= max(1, diff.size // 50), f"{diff.sum()} near-ties"


def test_load_keeps_the_tier(built):
    r, port, _, _ = built
    st, ann = port.index.store, port.index.ann
    bits = r.cfg.residual.bits
    assert st.residual and st.codec.bits == bits and st.tok_pages.shape[2] == 0
    assert st.code_pages.dtype == torch.uint8 and st.cent_pages.dtype == torch.int32
    assert ann.residual and ann.vecs.dtype == torch.uint8 and ann.scales is None
    assert ann.vecs.shape[2] == r.cfg.d_prime * bits // 8
    np.testing.assert_array_equal(st.code_pages.numpy(), np.asarray(r.index.store.code_pages))


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_route_matches_jax(built, route):
    r, port, q, qm = built
    jax_params, params = ROUTES[route]
    want_s, want_i = r.search(jnp.asarray(q), jnp.asarray(qm), jax_params)
    got_s, got_i = port.search(q, qm, params)
    assert got_s.shape == (q.shape[0], 10) and got_i.dtype == torch.int32
    assert_same_topk(want_s, want_i, got_s, got_i)
    assert not np.isin(got_i.numpy(), DELETED).any()
    assert port.launches(params) == r.launches(jax_params)


def test_port_save_of_the_tier_serves_under_jax(built, tmp_path):
    r, port, q, qm = built
    port.save(tmp_path)
    back = JaxRetriever.load(tmp_path)
    for name in ("cent_pages", "code_pages"):
        np.testing.assert_array_equal(np.asarray(getattr(back.index.store, name)),
                                      np.asarray(getattr(r.index.store, name)))
    for jax_params, params in ROUTES.values():
        want_s, want_i = back.search(jnp.asarray(q), jnp.asarray(qm), jax_params)
        got_s, got_i = port.search(q, qm, params)
        assert_same_topk(want_s, want_i, got_s, got_i)


def _corpus():
    return synthetic.make_corpus(m=2000, d=32, avg_tokens=16, max_tokens=24,
                                 n_centers=64, seed=0)


def test_build_with_the_tier_recall_matches_jax():
    """Both builds over one corpus with 4-bit tokens and lists, served with
    k = 10 and scored against exact MaxSim top-10 on the raw tokens."""
    corpus = _corpus()
    jcfg = SMOKE.replace(ivf=SMOKE.ivf.replace(residual_bits=4),
                         residual=JaxResidual(enabled=True, bits=4, ncent=64,
                                              kmeans_iters=4))
    jr = JaxRetriever.build(corpus, jcfg, key=jax.random.PRNGKey(0))
    r = LemurRetriever.build(corpus, LemurConfig.from_dict(jcfg.to_dict()), device="cpu",
                             generator=torch.Generator().manual_seed(0))
    assert r.index.store.residual and r.index.ann.residual and "codec" in r.build_log["seconds"]
    q = synthetic.queries_from_corpus_query(corpus, 128, q_tokens=8, seed=7)
    qm = np.ones(q.shape[:2], bool)
    _, truth = maxsim.true_topk(T(q), T(qm), T(corpus.doc_tokens), T(corpus.doc_mask), 10)
    _, jids = jr.search(jnp.asarray(q), jnp.asarray(qm), JaxParams(k=10))
    _, ids = r.search(q, qm, SearchParams(k=10))
    jrec = float(maxsim.recall_at(T(jids), truth).mean())
    rec = float(maxsim.recall_at(ids, truth).mean())
    assert rec >= jrec - 0.05, (rec, jrec)
    assert rec > 5 * SMOKE.k_prime / corpus.m


def test_tier_and_pooling_leave_psi_w_and_ivf_as_they_are():
    """The codec draws after everything else and pooling only changes what
    the store keeps: psi, W and the IVF lists of a build with the tier (2
    bits, a token budget of 6) equal those of a build without it."""
    corpus = synthetic.make_corpus(m=300, d=16, avg_tokens=8, max_tokens=12,
                                   n_centers=24, seed=0)
    base = LemurConfig(d=16, d_prime=64, m_pretrain=64, n_train=512, n_ols=256, epochs=2,
                       k=5, k_prime=40)
    tier = base.replace(residual=base.residual.replace(enabled=True, bits=2, ncent=16,
                                                       token_budget=6))
    a, b = (LemurRetriever.build(corpus, c, device="cpu",
                                 generator=torch.Generator().manual_seed(3))
            for c in (base, tier))
    for k, v in a.index.psi.params().items():
        assert torch.equal(v, b.index.psi.params()[k]), k
    assert torch.equal(a.index.store.W, b.index.store.W)
    assert torch.equal(a.index.ann.ids, b.index.ann.ids)
    assert torch.equal(a.index.ann.vecs, b.index.ann.vecs)
    st = b.index.store
    assert st.residual and int(st.n_tokens.max()) <= 6 and not a.index.store.residual
    s, i = b.search(corpus.doc_tokens[:4], corpus.doc_mask[:4])
    assert bool(torch.isfinite(s).all()) and bool((i >= 0).all())
