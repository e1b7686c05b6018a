"""Fault injection for the port's index lifecycle (``lifecycle/chaos.py``),
the twin of ``tests/test_lifecycle_chaos.py`` on port-built retrievers on
the CPU.

Every scenario asserts the same three-part contract: the failure surfaces
as a TYPED event (never a hang, never an unhandled crash on the serving
path), serving continues bit-identically on the last-good snapshot, and a
subsequent clean attempt succeeds (faults are transient, the lifecycle is
not wedged):

* refresh killed in each rebuild phase    -> ``RefreshFailed(phase=...)``
* corrupted rebuild handed to the swap    -> ``SwapAborted``, last-good kept
* replica killed mid-swap                 -> barrier excuses it, swap lands
  on the healthy replicas
* corrupt swap fanned fleet-wide          -> typed ``CorruptIndexError`` on
  the aggregate future, NO quarantine (rejection is not replica failure)

This file imports no JAX.  Every wait carries a timeout so a wedged barrier
fails the test instead of hanging the suite.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.config import LemurConfig
from repro_torch.data import synthetic
from repro_torch.fleet import Router, clone_replicas
from repro_torch.lifecycle import (ChaosError, ChaosInjector, LifecycleManager,
                                   RefreshCompleted, RefreshFailed, RefreshStarted,
                                   SwapAborted, SwapCompleted, build_refresh)
from repro_torch.retriever import (CorruptIndexError, IVFBackendConfig,
                                   LemurRetriever, SearchParams)
from repro_torch.serving import BucketLadder, RetrieverServer

TIMEOUT = 120.0
PARAMS = SearchParams(k=5, k_prime=60)
CHAOS_POINTS = ("refresh:solver", "refresh:refit", "refresh:recluster")


def gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


@pytest.fixture(scope="module")
def tiny_corpus():
    return synthetic.make_corpus(m=300, d=16, avg_tokens=8, max_tokens=12,
                                 n_centers=24, seed=0)


@pytest.fixture(scope="module")
def base(tiny_corpus):
    cfg = LemurConfig(d=16, d_prime=32, m_pretrain=128, n_train=1024,
                      n_ols=512, epochs=4, k=5, k_prime=60, anns="ivf",
                      ivf=IVFBackendConfig(nprobe=16))
    return LemurRetriever.build(tiny_corpus, cfg, generator=gen(0), device="cpu")


def _query(tq, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((tq, 16)).astype(np.float32)
    return q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-9)


def _ladder():
    return BucketLadder((32,), max_batch=4)


# --------------------------------------------------------------------------
# refresh killed mid-train
# --------------------------------------------------------------------------

@pytest.mark.parametrize("point", CHAOS_POINTS)
def test_refresh_crash_leaves_serving_untouched(base, point):
    serve_r = base.clone()
    chaos = ChaosInjector()
    chaos.fail_at(point)
    q, qm = _query(4, seed=1), np.ones(4, bool)
    with RetrieverServer(serve_r, ladder=_ladder(), max_wait_us=200,
                         default_params=PARAMS) as srv:
        s0, i0 = srv.search(q, qm, timeout=TIMEOUT)
        snap, ver = serve_r.snapshot(), serve_r.version
        mgr = LifecycleManager(srv, seed=3, chaos=chaos, cooldown_s=0.0)
        assert not mgr.refresh_now(reason="chaos")
        fails = mgr.events(RefreshFailed)
        assert len(fails) == 1
        assert fails[0].phase == point.split(":")[1]
        assert "ChaosError" in fails[0].error
        assert chaos.fired(point) == 1
        # serving was never touched: same snapshot, same version, bit-equal
        assert serve_r.snapshot() is snap and serve_r.version == ver
        s1, i1 = srv.search(q, qm, timeout=TIMEOUT)
        np.testing.assert_array_equal(i0, i1)
        np.testing.assert_array_equal(s0, s1)
        assert mgr.n_swaps == 0 and not mgr.events(SwapCompleted)
        # the fault was transient: the next attempt completes the swap
        assert mgr.refresh_now(reason="retry")
        assert serve_r.version == ver + 1
        assert mgr.events(SwapCompleted)[-1].version == serve_r.version


def test_refresh_crash_events_are_ordered(base):
    """A failed attempt leaves Started -> Failed; the retry appends
    Started -> Completed -> SwapCompleted — the runbook sequence."""
    serve_r = base.clone()
    chaos = ChaosInjector()
    chaos.fail_at("refresh:refit")
    with RetrieverServer(serve_r, ladder=_ladder(), max_wait_us=200,
                         default_params=PARAMS) as srv:
        mgr = LifecycleManager(srv, seed=3, chaos=chaos, cooldown_s=0.0)
        mgr.refresh_now(reason="a")
        mgr.refresh_now(reason="b")
        kinds = [e.kind for e in mgr.events()]
    assert kinds == ["RefreshStarted", "RefreshFailed", "RefreshStarted",
                     "RefreshCompleted", "SwapCompleted"]


# --------------------------------------------------------------------------
# corrupted rebuild handed to the swap
# --------------------------------------------------------------------------

def _poison(res):
    W = res.W.clone()
    W[:, 0] = float("nan")
    return res._replace(W=W)


def test_corrupt_refresh_aborts_swap_keeps_last_good(base):
    serve_r = base.clone()
    chaos = ChaosInjector()
    chaos.corrupt_results(_poison)
    q, qm = _query(6, seed=2), np.ones(6, bool)
    with RetrieverServer(serve_r, ladder=_ladder(), max_wait_us=200,
                         default_params=PARAMS) as srv:
        s0, i0 = srv.search(q, qm, timeout=TIMEOUT)
        snap, ver = serve_r.snapshot(), serve_r.version
        mgr = LifecycleManager(srv, seed=3, chaos=chaos, cooldown_s=0.0,
                               swap_timeout_s=TIMEOUT)
        assert not mgr.refresh_now(reason="chaos")
        aborts = mgr.events(SwapAborted)
        assert len(aborts) == 1 and "CorruptIndexError" in aborts[0].error
        # the rebuild itself completed; only the install was rejected
        assert mgr.events(RefreshCompleted) and mgr.n_refreshes == 1
        assert serve_r.snapshot() is snap and serve_r.version == ver
        s1, i1 = srv.search(q, qm, timeout=TIMEOUT)
        np.testing.assert_array_equal(i0, i1)
        # clearing the corruption lets the identical rebuild install
        chaos.corrupt_results(None)
        assert mgr.refresh_now(reason="clean")
        assert serve_r.version == ver + 1


# --------------------------------------------------------------------------
# fleet: replica killed mid-swap
# --------------------------------------------------------------------------

def test_fleet_swap_completes_when_replica_killed_mid_swap(base):
    reps = clone_replicas(base.clone(), 3)
    res = build_refresh(reps[0], seed=3)
    with Router(reps, ladder=_ladder(), max_wait_us=200,
                default_params=PARAMS, stall_timeout_s=30.0) as router:
        v0 = router.version
        router.servers[1].pause()       # replica 1 cannot drain its arm
        fut = router.apply(lambda r: r.install_refresh(res))
        assert router.kill_replica(1) >= 0
        fut.result(timeout=TIMEOUT)     # barrier excuses the dead replica
        assert fut.snapshot_version == v0 + 1
        assert router.n_healthy == 2 and router.quarantined() == [1]
        for i in (0, 2):
            assert router.servers[i].retriever.version == v0 + 1
        assert reps[1].version == v0    # the corpse kept its old snapshot
        # the surviving fleet serves the refit index bit-identically
        q, qm = _query(5, seed=3), np.ones(5, bool)
        s, ids = router.search(q, qm, timeout=TIMEOUT)
        ws, wi = reps[0].search(q[None], qm[None], PARAMS)
        np.testing.assert_array_equal(ids, wi[0].numpy())
        kinds = [e["event"] for e in router.events()]
        assert "quarantine" in kinds


# --------------------------------------------------------------------------
# fleet: corrupt swap rejected everywhere, nobody quarantined
# --------------------------------------------------------------------------

def test_fleet_corrupt_swap_typed_rejection_no_quarantine(base):
    reps = clone_replicas(base.clone(), 3)
    bad = _poison(build_refresh(reps[0], seed=3))
    with Router(reps, ladder=_ladder(), max_wait_us=200,
                default_params=PARAMS, stall_timeout_s=30.0) as router:
        v0 = router.version
        fut = router.apply(lambda r: r.install_refresh(bad))
        with pytest.raises(CorruptIndexError):
            fut.result(timeout=TIMEOUT)
        # a deterministic rejection is NOT a replica failure: the whole
        # fleet stays healthy on its last-good snapshot
        assert router.n_healthy == 3 and router.quarantined() == []
        for srv in router.servers:
            assert srv.retriever.version == v0
        q, qm = _query(4, seed=4), np.ones(4, bool)
        router.search(q, qm, timeout=TIMEOUT)   # still serving
        # and a clean result still lands fleet-wide afterwards
        good = build_refresh(router.servers[0].retriever, seed=3)
        fut = router.apply(lambda r: r.install_refresh(good))
        fut.result(timeout=TIMEOUT)
        assert fut.snapshot_version == v0 + 1
        assert all(s.retriever.version == v0 + 1 for s in router.servers)


# --------------------------------------------------------------------------
# manager over a fleet, faults injected end to end
# --------------------------------------------------------------------------

def test_manager_drives_fleet_through_transient_fault(base):
    """Drift detected on fleet-fanned mutations -> first refresh killed by
    chaos (typed RefreshFailed, fleet untouched) -> retry completes the
    fleet-wide warm swap; every replica converges on the same version."""
    reps = clone_replicas(base.clone(), 2)
    chaos = ChaosInjector()
    chaos.fail_at("refresh:recluster")
    with Router(reps, ladder=_ladder(), max_wait_us=200,
                default_params=PARAMS, stall_timeout_s=30.0) as router:
        mgr = LifecycleManager(router, seed=3, chaos=chaos, cooldown_s=0.0,
                               min_reservoir=8, swap_timeout_s=TIMEOUT)
        mgr.start(auto=False)
        try:
            sh = synthetic.make_corpus(m=96, d=16, avg_tokens=8,
                                       max_tokens=12, n_centers=6,
                                       topic_strength=4.0, seed=777)
            router.add(sh.doc_tokens, sh.doc_mask).result(timeout=TIMEOUT)
            router.delete(np.arange(60)).result(timeout=TIMEOUT)
            v0 = router.version
            assert not mgr.poll_once()          # chaos kills the rebuild
            assert mgr.events(RefreshFailed)
            assert router.version == v0
            assert mgr.poll_once()              # retry swaps fleet-wide
            assert router.version == v0 + 1
            assert all(s.retriever.version == v0 + 1
                       for s in router.servers)
            assert mgr.events(SwapCompleted)[-1].version == v0 + 1
            assert router.n_healthy == 2
        finally:
            mgr.stop()
