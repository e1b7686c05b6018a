"""The port's online serving, drift monitor and refresh held against the JAX
package on the same inputs, on the CPU.

A JAX ``LemurRetriever`` is built on ``tiny_corpus`` (IVF, nprobe 16, the
lifecycle suite's config) and saved; the port loads the checkpoint.  Then:

* ``ragged_queries`` and ``poisson_trace`` give the same arrays in both
  packages (numpy draws in one order); the same queries go through a JAX
  ``RetrieverServer`` and the port's, queued behind a pause so both
  micro-batch alike: the bucket and occupancy histograms are equal, and
  every request's ids equal JAX's up to counted near-ties (relative score
  gap < 1e-5, the repo's rule; the frameworks sum fp32 products in other
  orders), its scores within rtol 1e-5 / atol 1e-4.  An open-loop
  ``replay`` of the trace through each loses nothing and answers the same
  way.
* One mutation sequence (96 docs from shifted topic centres, then 60
  deletes) goes through a JAX and a port ``DriftMonitor`` with one seed:
  the reservoirs are equal bit for bit, the excess skew is equal, coverage
  and fidelity (baseline and report) agree within 1e-3 (``DRIFT_TOL``: the
  coverage is a fraction of 64 probe docs, so any disagreement would show
  as 1/64; fidelity is a Pearson correlation of values equal to ~1e-6).
* ``build_refresh`` of the two drifted snapshots with one seed: the OLS
  sample is bit-equal, the Gram features within 1e-5 x max|feats| and the
  refit W within 1e-3 x max|W| (JAX's upper and the port's lower Cholesky
  factor of one Gram matrix, as ``tests/test_torch_mutation.py`` holds
  them).  The rebuilt IVF cannot match JAX's threefry draw, so it is held
  by what it recovers: after each package installs its own refresh, the
  same shifted reservoir's coverage no longer triggers on either side, and
  the port's is within ``COVERAGE_GAP`` (0.15) of JAX's (the skew, which
  reads the new lists' sizes, depends on each package's own draw).
"""
import jax
import numpy as np
import pytest

from repro.core import LemurConfig as JaxConfig
from repro.data import synthetic
from repro.lifecycle import DriftMonitor as JaxMonitor
from repro.lifecycle import build_refresh as jax_refresh
from repro.retriever import IVFBackendConfig as JaxIVFConfig
from repro.retriever import LemurRetriever as JaxRetriever
from repro.serving import BucketLadder as JaxLadder
from repro.serving import RetrieverServer as JaxServer
from repro.serving import poisson_trace as jax_trace
from repro.serving import ragged_queries as jax_queries
from repro.serving import replay as jax_replay

from repro_torch.lifecycle import DriftMonitor, build_refresh
from repro_torch.retriever import LemurRetriever
from repro_torch.serving import BucketLadder, RetrieverServer, poisson_trace, ragged_queries
from repro_torch.serving import replay

TIMEOUT = 120.0
RTOL, ATOL, TIE = 1e-5, 1e-4, 1e-5
DRIFT_TOL = 1e-3
W_TOL = 1e-3              # x max|W|
COVERAGE_GAP = 0.15
LADDER = ((8, 16), 4)


@pytest.fixture(scope="module")
def built(tiny_corpus, tmp_path_factory):
    cfg = JaxConfig(d=16, d_prime=32, m_pretrain=128, n_train=1024, n_ols=512, epochs=4,
                    k=5, k_prime=60, anns="ivf", ivf=JaxIVFConfig(nprobe=16))
    jr = JaxRetriever.build(tiny_corpus, cfg, key=jax.random.PRNGKey(0))
    path = tmp_path_factory.mktemp("online")
    jr.save(path)
    return jr, LemurRetriever.load(path, device="cpu")


def assert_same_topk(s_ref, i_ref, s_got, i_got):
    """Scores within tolerance; differing ids only at counted near-ties."""
    s_ref, i_ref, s_got, i_got = map(np.asarray, (s_ref, i_ref, s_got, i_got))
    np.testing.assert_allclose(s_got, s_ref, rtol=RTOL, atol=ATOL)
    diff = i_got != i_ref
    gap = np.abs(s_got - s_ref) / np.maximum(np.abs(s_ref), 1.0)
    assert np.all(gap[diff] < TIE), "an id differs without a near-tie"
    return int(diff.sum())


def serve_paused(srv, queries, arrivals):
    """Queue every query behind a pause (t_arrival from the trace), then
    let the worker drain: the micro-batches depend on the queue alone."""
    srv.pause()
    futs = [srv.submit(queries[i % len(queries)], t_arrival=float(at))
            for i, at in enumerate(arrivals)]
    srv.resume()
    return [f.result(timeout=TIMEOUT) for f in futs]


def test_trace_and_queries_match_jax():
    for rate, dur, seed in [(200.0, 0.5, 0), (1000.0, 0.2, 3)]:
        np.testing.assert_array_equal(poisson_trace(rate, dur, seed),
                                      jax_trace(rate, dur, seed))
    for a, b in zip(ragged_queries(12, 16, (2, 24), seed=5),
                    jax_queries(12, 16, (2, 24), seed=5)):
        np.testing.assert_array_equal(a, b)


def test_servers_match_jax(built):
    """Same queries, same queue: same micro-batches and the same answers."""
    jr, pr = built
    queries = ragged_queries(24, 16, (2, 16), seed=1)
    arrivals = poisson_trace(400.0, 0.15, seed=2)
    assert len(arrivals) > 24
    jl, pl = JaxLadder(*LADDER), BucketLadder(*LADDER)
    with JaxServer(jr.clone(), ladder=jl, max_wait_us=200) as js, \
            RetrieverServer(pr.clone(), ladder=pl, max_wait_us=200) as ps:
        j_out = serve_paused(js, queries, arrivals)
        p_out = serve_paused(ps, queries, arrivals)
        js_sum, ps_sum = js.stats.summary(), ps.stats.summary()
        assert ps_sum["bucket_hist"] == js_sum["bucket_hist"]
        assert ps_sum["occupancy_hist"] == js_sum["occupancy_hist"]
        assert ps_sum["n_requests"] == js_sum["n_requests"] == len(arrivals)
        ties = sum(assert_same_topk(js_, ji, ps_, pi)
                   for (js_, ji), (ps_, pi) in zip(j_out, p_out))
        assert ties <= max(1, len(arrivals) * 5 // 50), f"{ties} near-tie ids"
        # an open-loop replay of the same trace: nothing lost, same answers
        j_res, j_rep = jax_replay(js, queries, arrivals, timeout=TIMEOUT)
        p_res, p_rep = replay(ps, queries, arrivals, timeout=TIMEOUT)
    assert p_rep["n_lost"] == j_rep["n_lost"] == 0
    assert p_rep["n_requests"] == j_rep["n_requests"] == len(arrivals)
    for (js_, ji), (ps_, pi) in zip(j_res, p_res):
        assert_same_topk(js_, ji, ps_, pi)


def _shifted(n=96, seed=777):
    c = synthetic.make_corpus(m=n, d=16, avg_tokens=8, max_tokens=12, n_centers=6,
                              topic_strength=4.0, seed=seed)
    return c.doc_tokens, c.doc_mask


def _monitors(built):
    """A JAX and a port clone, each with an attached DriftMonitor of one
    seed, through the same adds and deletes."""
    jr, pr = built
    ja, pa = jr.clone(), pr.clone()
    jm = JaxMonitor(ja, reservoir=128, probes=64, seed=1)
    pm = DriftMonitor(pa, reservoir=128, probes=64, seed=1)
    jm.attach()
    pm.attach()
    toks, mask = _shifted()
    for r in (ja, pa):
        r.add(toks, mask)
        r.delete(np.arange(60))
    return ja, pa, jm, pm


def _same_report(j, p):
    assert p.n_reservoir == j.n_reservoir and p.triggered == j.triggered
    assert p.skew == j.skew
    for k in ("coverage", "baseline_coverage", "fidelity", "baseline_fidelity"):
        assert abs(getattr(p, k) - getattr(j, k)) <= DRIFT_TOL, k


def test_drift_monitor_matches_jax(built):
    ja, pa, jm, pm = _monitors(built)
    try:
        assert sorted(pm._res) == sorted(jm._res) and pm.n_mutations == jm.n_mutations
        for i, (t, mk) in jm._res.items():
            np.testing.assert_array_equal(pm._res[i][0], np.asarray(t))
            np.testing.assert_array_equal(pm._res[i][1], np.asarray(mk))
        j, p = jm.report(), pm.report()
        assert j.triggered and "coverage" in j.reason
        _same_report(j, p)
    finally:
        jm.detach()
        pm.detach()


def test_build_refresh_matches_jax(built):
    ja, pa, jm, pm = _monitors(built)
    try:
        jres, pres = jax_refresh(ja, seed=3), build_refresh(pa, seed=3)
        assert (pres.m0, pres.version, pres.backend) == (jres.m0, jres.version, jres.backend)
        np.testing.assert_array_equal(pres.solver["x_ols"].numpy(),
                                      np.asarray(jres.solver["x_ols"]))
        jf = np.asarray(jres.solver["feats"])
        assert np.abs(pres.solver["feats"].numpy() - jf).max() <= 1e-5 * np.abs(jf).max()
        jw = np.asarray(jres.W)
        assert np.abs(pres.W.numpy() - jw).max() <= W_TOL * np.abs(jw).max()
        dead = ~pa.index.store.alive[:pres.m0].numpy()
        assert not pres.W.numpy()[dead].any() and not jw[dead].any()
        # the rebuilt first stage, held by the coverage it recovers
        before = pm.report()
        ja.install_refresh(jres)
        pa.install_refresh(pres)
        j, p = jm.report(), pm.report()
        assert "coverage" not in j.reason and "coverage" not in p.reason, (j, p)
        assert p.coverage > before.coverage
        assert abs(p.coverage - j.coverage) <= COVERAGE_GAP, (p.coverage, j.coverage)
    finally:
        jm.detach()
        pm.detach()
