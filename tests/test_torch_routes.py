"""Every single-device search route of the port held against the JAX
retriever on the same index.

A JAX ``LemurRetriever`` is built on ``tiny_corpus`` (SQ8 and fp32 IVF
lists, some docs deleted) and saved; the port loads the checkpoint on the
CPU and serves it through each ``SearchParams`` spelling of a route:

* one-launch IVF, ``IVFSearchParams(use_one_launch=True)``;
* the exact latent scan, ``use_ann=False``, in one launch and blocked;
* the legacy gathered scan, ``IVFSearchParams(use_fused_gather=False)``,
  and the legacy gathered rerank, ``SearchParams(use_fused_gather=False)``.

Each returns JAX's ids and scores, and ``launches()`` equals JAX's plan.
Then the port's routes are held against each other: the one-launch IVF and
the legacy routes give the default route's ids and scores bit for bit (the
same plain arithmetic on the CPU), and the one-launch exact scan gives the
blocked scan's.

Tolerance: the frameworks sum fp32 products in other orders, so scores
agree to rtol 1e-5 / atol 1e-4 and ids up to counted near-ties (relative
score gap < 1e-5), as in ``tests/test_torch_retriever.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.anns.params import IVFBackendConfig as JaxIVFConfig
from repro.anns.params import IVFSearchParams as JaxIVFParams
from repro.core.config import LemurConfig as JaxConfig
from repro.data import synthetic
from repro.retriever import LemurRetriever as JaxRetriever
from repro.retriever import SearchParams as JaxParams

from repro_torch.retriever import IVFSearchParams, LemurRetriever, SearchParams

RTOL, ATOL, TIE = 1e-5, 1e-4, 1e-5
DELETED = [3, 17, 42, 99, 150, 151, 260]

#: route name -> (JAX spelling, port spelling)
ROUTES = {
    "one_launch_ivf": (JaxParams(backend=JaxIVFParams(use_one_launch=True)),
                       SearchParams(backend=IVFSearchParams(use_one_launch=True))),
    "exact_one_launch": (JaxParams(use_ann=False, use_one_launch=True),
                         SearchParams(use_ann=False, use_one_launch=True)),
    "exact_blocked": (JaxParams(use_ann=False), SearchParams(use_ann=False)),
    "legacy_scan": (JaxParams(backend=JaxIVFParams(use_fused_gather=False)),
                    SearchParams(backend=IVFSearchParams(use_fused_gather=False))),
    "legacy_rerank": (JaxParams(use_fused_gather=False),
                      SearchParams(use_fused_gather=False)),
    "legacy_scan_and_rerank": (
        JaxParams(use_fused_gather=False,
                  backend=JaxIVFParams(use_fused_gather=False, nprobe=4)),
        SearchParams(use_fused_gather=False,
                     backend=IVFSearchParams(use_fused_gather=False, nprobe=4))),
}


@pytest.fixture(scope="module", params=[True, False], ids=["sq8", "fp32"])
def built(request, tiny_corpus, tmp_path_factory):
    cfg = JaxConfig(d=16, d_prime=128, m_pretrain=64, n_train=512, n_ols=256,
                    epochs=2, k=10, k_prime=64, anns="ivf",
                    ivf=JaxIVFConfig(nprobe=8, sq8=request.param))
    r = JaxRetriever.build(tiny_corpus, cfg, key=jax.random.PRNGKey(0))
    r.delete(DELETED)
    path = tmp_path_factory.mktemp(f"routes_{request.param}")
    r.save(path)
    q = synthetic.queries_from_corpus_query(tiny_corpus, 12, q_tokens=6, seed=3)
    qm = np.random.default_rng(4).random(q.shape[:2]) > 0.25
    qm[:, 0] = True
    return r, LemurRetriever.load(path, device="cpu"), q.astype(np.float32), qm


def assert_same_topk(s_ref, i_ref, s_got, i_got):
    """Scores within tolerance; differing ids only at counted near-ties."""
    s_ref, i_ref = np.asarray(s_ref), np.asarray(i_ref)
    s_got, i_got = np.asarray(s_got), np.asarray(i_got)
    np.testing.assert_allclose(s_got, s_ref, rtol=RTOL, atol=ATOL)
    diff = i_got != i_ref
    gap = np.abs(s_got - s_ref) / np.maximum(np.abs(s_ref), 1.0)
    assert np.all(gap[diff] < TIE), "an id differs without a near-tie"
    assert diff.sum() <= max(1, diff.size // 50), f"{diff.sum()} near-ties"


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_route_matches_jax(built, route):
    r, port, q, qm = built
    jax_params, params = ROUTES[route]
    want_s, want_i = r.search(jnp.asarray(q), jnp.asarray(qm), jax_params)
    got_s, got_i = port.search(q, qm, params)
    assert got_s.shape == (q.shape[0], 10) and got_i.dtype == torch.int32
    assert_same_topk(want_s, want_i, got_s, got_i)
    assert not np.isin(got_i.numpy(), DELETED).any()


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_route_launch_plan_matches_jax(built, route):
    r, port, _, _ = built
    jax_params, params = ROUTES[route]
    assert port.launches(params) == r.launches(jax_params)


@pytest.mark.parametrize("route", ["one_launch_ivf", "legacy_scan", "legacy_rerank"])
@pytest.mark.parametrize("k", [10, 80])     # 80 > k' = 64: padded rows
def test_route_equals_default_route(built, route, k):
    """On the CPU the one-launch IVF and the legacy routes compute the
    default route's plain arithmetic: the same ids and scores, bit for bit,
    (NEG, -1) pads included."""
    _, port, q, qm = built
    s0, i0 = port.search(q, qm, SearchParams(k=k))
    s1, i1 = port.search(q, qm, dataclasses.replace(ROUTES[route][1], k=k))
    assert torch.equal(i1, i0) and torch.equal(s1, s0)


@pytest.mark.parametrize("k_prime", [64, 400])   # 400 > the 293 live docs: pads
def test_exact_one_launch_equals_blocked(built, k_prime):
    _, port, q, qm = built
    s0, i0 = port.search(q, qm, SearchParams(use_ann=False, k_prime=k_prime))
    s1, i1 = port.search(q, qm, SearchParams(use_ann=False, use_one_launch=True,
                                             k_prime=k_prime))
    assert_same_topk(s0, i0, s1, i1)
