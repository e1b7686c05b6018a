"""The port's fleet serving (``repro_torch.fleet``), the twin of
``tests/test_fleet.py`` on port-built retrievers on the CPU.

The router's contracts, each driven deterministically:

* **Replica cloning** — ``clone()`` shares the built state, answers
  bit-identically, and isolates growth per clone until fanned out (the
  port copies a shared tensor on a clone's first write to it).
* **Deadlines + admission, all five backends** — an expired request
  resolves with a typed ``DeadlineExceeded`` (never a silent drop),
  rejected requests raise/resolve a typed ``Overloaded`` and never consume
  a micro-batch slot (server ``n_requests`` counts only served requests).
* **Router parity + exactly-once** — fleet answers are bit-identical to a
  direct ``retriever.search``; the submit/add interleaving property from
  ``test_torch_serving.py`` extends through a 3-replica router with a
  mid-stream replica kill: no dropped, duplicated, or cross-wired ids.
* **Write barrier** — ``add()`` resolves only when every replica landed on
  the same ``snapshot_version``; a paused replica holds the barrier; a
  quarantined replica is excused.
* **Health** — a replica that stops draining with outstanding work is
  quarantined by the monitor and its requests complete elsewhere.
* **SLO controller** — breach walks one rung down, recovery is hysteretic
  (``hold`` clean evaluations below ``recover_frac * target``), every
  logged transition is consistent with the p99 that triggered it, and the
  rung ladder stays within the pre-warmed bound.

This file imports no JAX.  Every wait carries a timeout so a deadlocked
router fails, not hangs.
"""
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.anns import registry
from repro_torch.core.config import LemurConfig
from repro_torch.data import synthetic
from repro_torch.retriever import LemurRetriever, SearchParams
from repro_torch.serving import (
    BucketLadder,
    DeadlineExceeded,
    Overloaded,
    RetrieverServer,
)
from repro_torch.fleet import (
    Router,
    SLOController,
    build_rungs,
    clone_replicas,
    warm_replicas,
)

BACKENDS = registry.list_backends()
TIMEOUT = 120.0


def gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


@pytest.fixture(scope="module")
def tiny_corpus():
    return synthetic.make_corpus(m=300, d=16, avg_tokens=8, max_tokens=12,
                                 n_centers=24, seed=0)


@pytest.fixture(scope="module")
def base(tiny_corpus):
    cfg = LemurConfig(d=16, d_prime=32, m_pretrain=128, n_train=1024,
                      n_ols=512, epochs=4, k=5, k_prime=60, anns="bruteforce")
    return LemurRetriever.build(tiny_corpus, cfg, generator=gen(0), device="cpu")


@pytest.fixture(scope="module")
def small(tiny_corpus):
    """Tiny fast-growing retriever for interleaving/kill properties (same
    shape as test_serving_runtime.small)."""
    import dataclasses as dc

    sub = dc.replace(tiny_corpus,
                     doc_tokens=tiny_corpus.doc_tokens[:60],
                     doc_mask=tiny_corpus.doc_mask[:60],
                     topics=tiny_corpus.topics[:60])
    cfg = LemurConfig(d=16, d_prime=32, m_pretrain=48, n_train=512, n_ols=256,
                      epochs=3, k=3, k_prime=512, anns="bruteforce")
    return LemurRetriever.build(sub, cfg, generator=gen(0), device="cpu"), sub


def _ragged_query(tq: int, d: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((tq, d)).astype(np.float32)
    return q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-9)


def _direct(r, q: np.ndarray, params):
    s, ids = r.search(q[None], np.ones((1, q.shape[0]), bool), params)
    return s[0].numpy(), ids[0].numpy()


# --------------------------------------------------------------------------
# replica cloning
# --------------------------------------------------------------------------

def test_clone_shares_state_and_answers_identically(base):
    c1, c2 = clone_replicas(base, 2)
    assert c1 is not base and c1 is not c2
    assert c1.index is base.index          # shared snapshot (copied on write)
    assert c1.version == base.version
    q = _ragged_query(7, base.cfg.d, seed=3)
    _, want = _direct(base, q, None)
    for c in (c1, c2):
        assert np.array_equal(_direct(c, q, None)[1], want)


def test_clone_add_is_deterministic_and_isolated(base):
    c1, c2 = clone_replicas(base, 2)
    grow = synthetic.make_corpus(m=3, d=16, avg_tokens=8, max_tokens=12,
                                 n_centers=24, seed=77)
    c1.add(grow.doc_tokens, grow.doc_mask)
    assert (c1.m, c1.version) == (base.m + 3, 1)
    assert (c2.m, c2.version) == (base.m, 0), "add leaked across clones"
    assert base.m == c2.m, "add mutated the source retriever"
    # fan the same add out to the second clone: bit-identical W rows — the
    # invariant the fleet write barrier relies on
    c2.add(grow.doc_tokens, grow.doc_mask)
    np.testing.assert_array_equal(c1.index.W.numpy(), c2.index.W.numpy())


# --------------------------------------------------------------------------
# deadlines + admission control, every backend (satellite)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", BACKENDS)
def test_deadline_and_admission_typed_outcomes(name, base):
    r = base.with_backend(name, generator=gen(1)).clone()
    ladder = BucketLadder((8,), 2)
    q = _ragged_query(6, base.cfg.d, seed=1)
    with RetrieverServer(r, ladder=ladder, max_wait_us=200,
                         max_queue_depth=3) as srv:
        _, want = srv.search(q, timeout=TIMEOUT)     # warm + sanity
        # -- deadline expiry: typed, never silent -------------------------
        srv.pause()
        expired = srv.submit(q, deadline_s=0.05)
        live = srv.submit(q)
        time.sleep(0.15)
        srv.resume()
        with pytest.raises(DeadlineExceeded) as ei:
            expired.result(timeout=TIMEOUT)
        assert ei.value.request_id == expired.request_id
        assert ei.value.waited_s >= 0.05
        assert np.array_equal(live.result(timeout=TIMEOUT)[1], want)
        assert srv.stats.n_expired == 1
        # -- admission control: typed reject, zero slots consumed ---------
        srv.pause()
        accepted = [srv.submit(q) for _ in range(3)]
        with pytest.raises(Overloaded):
            srv.submit(q)
        srv.resume()
        for f in accepted:
            assert np.array_equal(f.result(timeout=TIMEOUT)[1], want)
        assert srv.stats.n_rejected == 1
    summary = srv.stats.summary()
    # served = warm + live + 3 accepted; the expired and rejected requests
    # never occupied a micro-batch slot
    assert summary["n_requests"] == 5
    assert summary["n_expired"] == 1 and summary["n_rejected"] == 1


def test_expired_request_never_joins_a_batch(base):
    """An expired request queued BEHIND live ones is swept typed while the
    live ones coalesce without it."""
    r = base.clone()
    ladder = BucketLadder((8,), 4)
    q = _ragged_query(5, base.cfg.d, seed=2)
    with RetrieverServer(r, ladder=ladder, max_wait_us=200) as srv:
        srv.search(q, timeout=TIMEOUT)
        srv.pause()
        doomed = srv.submit(q, deadline_s=0.05)
        live = [srv.submit(q) for _ in range(3)]
        time.sleep(0.15)
        srv.resume()
        with pytest.raises(DeadlineExceeded):
            doomed.result(timeout=TIMEOUT)
        for f in live:
            f.result(timeout=TIMEOUT)
    hist = srv.stats.summary()["occupancy_hist"]
    assert 4 not in hist, f"expired request joined a batch: {hist}"


# --------------------------------------------------------------------------
# router: parity, least-outstanding dispatch, exactly-once under kill
# --------------------------------------------------------------------------

def test_router_parity_and_dispatch_balance(base):
    reps = clone_replicas(base, 3)
    ladder = BucketLadder((8, 16), 4)
    warm_replicas(reps, ladder, base.cfg.d)
    with Router(reps, ladder=ladder, max_wait_us=200,
                stall_timeout_s=30.0) as router:
        # pause every replica so outstanding counts accumulate during the
        # submit burst — least-outstanding dispatch then MUST spread the
        # requests across all three (with live replicas a fast worker can
        # legitimately drain each request before the next submit arrives,
        # which makes the balance assertion timing-dependent)
        for srv in router.servers:
            srv.pause()
        futs, wants = [], []
        for i in range(24):
            q = _ragged_query(3 + (i % 10), base.cfg.d, seed=i)
            futs.append(router.submit(q))
            wants.append(_direct(base, q, None)[1])
        for srv in router.servers:
            srv.resume()
        served = set()
        for f, want in zip(futs, wants):
            _, ids = f.result(timeout=TIMEOUT)
            assert np.array_equal(ids, want), "fleet ids diverged from direct"
            served.add(f.replica)
        rids = [f.request_id for f in futs]
        assert len(set(rids)) == len(rids)
        assert served == {0, 1, 2}, (
            f"least-outstanding dispatch starved replicas: {served}")
        assert router.stats.n_completed == 24


def test_router_interleaving_with_mid_stream_kill(small):
    """The submit/add interleaving property through a 3-replica router with
    a replica killed mid-stream: every request id resolves exactly once to
    its own query's answer, adds stay snapshot-consistent fleet-wide."""
    built, sub = small
    reps = clone_replicas(built, 3)
    addpool = synthetic.make_corpus(m=16, d=16, avg_tokens=8, max_tokens=12,
                                    n_centers=24, seed=901)
    rng = np.random.default_rng(5)
    params = SearchParams(k_prime=512)
    ladder = BucketLadder((8, 16), max_batch=4)
    expected: list[tuple[object, int]] = []
    adds = []
    n_added = 0
    with Router(reps, ladder=ladder, max_wait_us=300, default_params=params,
                max_queue_depth=None, stall_timeout_s=30.0) as router:
        for step in range(24):
            if step == 12:
                router.kill_replica(1)
            roll = rng.random()
            if roll < 0.25 and n_added < addpool.m:
                adds.append(router.add(
                    addpool.doc_tokens[n_added:n_added + 1],
                    addpool.doc_mask[n_added:n_added + 1]))
                n_added += 1
            elif roll < 0.6 or n_added == 0:
                j = int(rng.integers(0, 60))
                q = sub.doc_tokens[j][sub.doc_mask[j]]
                expected.append((router.submit(np.asarray(q)), j))
            else:
                a = int(rng.integers(0, n_added))
                q = addpool.doc_tokens[a][addpool.doc_mask[a]]
                expected.append((router.submit(np.asarray(q)), 60 + a))
        for fut in adds:
            assert fut.result(timeout=TIMEOUT) <= 60 + n_added
        assert router.n_healthy == 2
        assert router.quarantined() == [1]
        # every healthy replica landed on the same final snapshot
        versions = {i: reps[i].version for i in (0, 2)}
        assert set(versions.values()) == {n_added}, versions
        tail = router.submit(
            np.asarray(sub.doc_tokens[0][sub.doc_mask[0]]))
        tail.result(timeout=TIMEOUT)
        assert tail.snapshot_version == n_added
    rids = [f.request_id for f, _ in expected]
    assert len(set(rids)) == len(rids), "duplicate fleet request ids"
    for fut, j in expected:
        assert fut.done(), f"request {fut.request_id} dropped"
        s, ids = fut.result(timeout=0)
        assert ids[0] == j, (
            f"request {fut.request_id} cross-wired: top-1 {ids[0]} != {j}")


def test_router_deadline_and_admission(base):
    reps = clone_replicas(base, 2)
    ladder = BucketLadder((8,), 2)
    warm_replicas(reps, ladder, base.cfg.d)
    q = _ragged_query(6, base.cfg.d, seed=4)
    with Router(reps, ladder=ladder, max_wait_us=200, max_queue_depth=4,
                stall_timeout_s=30.0) as router:
        for srv in router.servers:
            srv.pause()
        doomed = router.submit(q, deadline_s=0.05)
        accepted = [router.submit(q) for _ in range(3)]
        rejected = router.submit(q)          # outstanding == 4 == bound
        assert rejected.done()
        with pytest.raises(Overloaded):
            rejected.result(timeout=0)
        time.sleep(0.15)
        for srv in router.servers:
            srv.resume()
        with pytest.raises(DeadlineExceeded) as ei:
            doomed.result(timeout=TIMEOUT)
        assert ei.value.request_id == doomed.request_id
        want = _direct(base, q, None)[1]
        for f in accepted:
            assert np.array_equal(f.result(timeout=TIMEOUT)[1], want)
        assert router.stats.n_rejected == 1
        assert router.stats.n_expired == 1


# --------------------------------------------------------------------------
# write barrier + health
# --------------------------------------------------------------------------

def test_add_barrier_waits_for_every_replica(base):
    reps = clone_replicas(base, 3)
    grow = synthetic.make_corpus(m=2, d=16, avg_tokens=8, max_tokens=12,
                                 n_centers=24, seed=13)
    with Router(reps, ladder=BucketLadder((8,), 2),
                stall_timeout_s=30.0) as router:
        router.servers[2].pause()
        af = router.add(grow.doc_tokens, grow.doc_mask)
        # replicas 0/1 apply (the first add can be slow, so poll rather
        # than sleep);
        # the paused replica 2 cannot, and the barrier must hold for it
        t_end = time.perf_counter() + TIMEOUT
        while ((reps[0].version < 1 or reps[1].version < 1)
               and time.perf_counter() < t_end):
            time.sleep(0.01)
        assert reps[0].version == 1 and reps[1].version == 1
        assert not af.done(), "barrier resolved before every replica applied"
        assert reps[2].version == 0
        router.servers[2].resume()
        assert af.result(timeout=TIMEOUT) == base.m + 2
        assert af.snapshot_version == 1
        assert {r.version for r in reps} == {1}
        # post-barrier searches observe the new snapshot on EVERY replica
        q = np.asarray(grow.doc_tokens[0][grow.doc_mask[0]])
        for _ in range(6):
            f = router.submit(q, params=SearchParams(use_ann=False,
                                                     k_prime=base.m + 2))
            _, ids = f.result(timeout=TIMEOUT)
            assert ids[0] == base.m and f.snapshot_version == 1


def test_add_barrier_excuses_quarantined_replica(base):
    reps = clone_replicas(base, 3)
    grow = synthetic.make_corpus(m=2, d=16, avg_tokens=8, max_tokens=12,
                                 n_centers=24, seed=14)
    with Router(reps, ladder=BucketLadder((8,), 2),
                stall_timeout_s=30.0) as router:
        router.servers[1].pause()
        af = router.add(grow.doc_tokens, grow.doc_mask)
        time.sleep(0.2)
        assert not af.done()
        router.quarantine(1, reason="test")
        assert af.result(timeout=TIMEOUT) == base.m + 2
        assert af.snapshot_version == 1
        assert reps[0].version == reps[2].version == 1


def test_router_delete_update_barrier_end_to_end(base):
    """The generalized write barrier, happy path: delete() and update()
    fan out to every replica, hold until all apply, land the fleet on one
    snapshot version, and post-barrier searches on EVERY replica see the
    replacement doc under its new id — never the tombstoned ones."""
    reps = clone_replicas(base, 3)
    grow = synthetic.make_corpus(m=4, d=16, avg_tokens=8, max_tokens=12,
                                 n_centers=24, seed=23)
    repl = synthetic.make_corpus(m=1, d=16, avg_tokens=8, max_tokens=12,
                                 n_centers=24, seed=24)
    with Router(reps, ladder=BucketLadder((8, 16), 2),
                stall_timeout_s=30.0) as router:
        af = router.add(grow.doc_tokens, grow.doc_mask)
        assert af.result(timeout=TIMEOUT) == base.m + 4
        # clones share the OLS solver => bit-identical adds => same ids
        ids = np.arange(base.m, base.m + 4)
        df = router.delete(ids[:2].tolist())
        assert df.result(timeout=TIMEOUT) == base.m + 2   # fleet n_alive
        assert df.snapshot_version == 2
        uf = router.update([int(ids[2])], repl.doc_tokens, repl.doc_mask)
        new = np.asarray(uf.result(timeout=TIMEOUT))
        assert new.tolist() == [base.m + 4]               # fresh slot id
        assert uf.snapshot_version == 3                   # ONE bump
        assert {r.version for r in reps} == {3}
        assert {r.n_alive for r in reps} == {base.m + 2}
        q3 = np.asarray(repl.doc_tokens[0][repl.doc_mask[0]])
        full = SearchParams(use_ann=False, k_prime=base.m + 5)
        for _ in range(6):
            f = router.submit(q3, params=full)
            _, got = f.result(timeout=TIMEOUT)
            assert got[0] == base.m + 4 and f.snapshot_version == 3
            assert int(ids[2]) not in got and int(ids[0]) not in got


def test_router_stop_without_drain_resolves_mutation_barriers(base):
    """The no-leak guarantee through the fleet layer: a non-drain router stop
    cancels every replica's queued mutation, and each pending fleet barrier
    (add, delete, update) resolves with a TYPED error — a caller blocked on
    ``result(timeout=...)`` never hangs, and no replica applied anything."""
    reps = clone_replicas(base, 2)
    grow = synthetic.make_corpus(m=2, d=16, avg_tokens=8, max_tokens=12,
                                 n_centers=24, seed=21)
    router = Router(reps, ladder=BucketLadder((8,), 2),
                    stall_timeout_s=30.0).start()
    try:
        for srv in router.servers:
            srv.pause()                 # wedge both workers: barriers stay queued
        af = router.add(grow.doc_tokens, grow.doc_mask)
        df = router.delete([0])
        uf = router.update([1], grow.doc_tokens[:1], grow.doc_mask[:1])
        assert not af.done() and not df.done() and not uf.done()
        router.stop(drain=False, timeout=TIMEOUT)
        for f in (af, df, uf):
            with pytest.raises(RuntimeError, match="no replica completed"):
                f.result(timeout=5.0)   # resolves promptly, typed — not a hang
        assert {r.version for r in reps} == {0}, "cancelled mutation applied"
    finally:
        router.stop(drain=False, timeout=TIMEOUT)


def test_router_frees_its_replicas_without_the_cyclic_collector(base):
    """Nothing the router makes keeps its replicas alive after ``with
    Router(...)`` exits: no reference cycle runs through the router, its
    write barriers or its requests, so with Python's cyclic collector off
    the replicas (on a card, their copied pools) are freed as soon as the
    caller drops them — after searches, an add barrier and a killed
    replica whose requests were re-dispatched."""
    import gc
    import weakref

    grow = synthetic.make_corpus(m=2, d=16, avg_tokens=8, max_tokens=12,
                                 n_centers=24, seed=31)
    q = _ragged_query(6, base.cfg.d, seed=4)
    gc.collect()
    gc.disable()
    try:
        reps = clone_replicas(base, 2)
        refs = [weakref.ref(r) for r in reps]
        with Router(reps, ladder=BucketLadder((8,), 2),
                    stall_timeout_s=30.0) as router:
            futs = [router.submit(q) for _ in range(8)]
            assert router.add(grow.doc_tokens, grow.doc_mask).result(
                timeout=TIMEOUT) == base.m + 2
            router.servers[1].pause()
            futs += [router.submit(q) for _ in range(4)]
            router.kill_replica(1)
            for f in futs:
                f.result(timeout=TIMEOUT)
        router_ref = weakref.ref(router)
        del router, reps, futs, f
        assert router_ref() is None, "a reference cycle holds the router"
        assert [ref() for ref in refs] == [None, None], \
            "a reference cycle holds a replica"
    finally:
        gc.enable()


def test_stalled_replica_quarantined_and_requests_rehomed(base):
    reps = clone_replicas(base, 2)
    ladder = BucketLadder((8,), 2)
    warm_replicas(reps, ladder, base.cfg.d)
    q = _ragged_query(6, base.cfg.d, seed=6)
    with Router(reps, ladder=ladder, max_wait_us=200,
                stall_timeout_s=0.3, health_interval_s=0.05) as router:
        for _ in range(4):
            router.search(q, timeout=TIMEOUT)
        router.servers[0].pause()
        futs = [router.submit(q) for _ in range(8)]
        want = _direct(base, q, None)[1]
        for f in futs:   # stalled replica's share re-dispatched to replica 1
            assert np.array_equal(f.result(timeout=TIMEOUT)[1], want)
        deadline = time.monotonic() + 10
        while 0 not in router.quarantined() and time.monotonic() < deadline:
            time.sleep(0.05)
        assert router.quarantined() == [0], router.events()
        ev = [e for e in router.events() if e["replica"] == 0]
        assert ev and "no progress" in ev[0]["reason"]
        assert router.stats.n_redispatched > 0
        assert router.stats.n_completed == 12


# --------------------------------------------------------------------------
# SLO controller
# --------------------------------------------------------------------------

def test_build_rungs_walks_nprobe_and_k_prime(base):
    r = base.with_backend("ivf", generator=gen(1))
    rungs = build_rungs(r, n_rungs=3)
    assert len(rungs) == 3
    assert rungs[0] == r.resolve(None)
    for a, b in zip(rungs, rungs[1:]):
        assert b.k_prime == max(a.k_prime // 2, max(a.k, 8))
        assert b.backend.nprobe == max(a.backend.nprobe // 2, 1)
        assert b.k == a.k, "rungs must not change the response contract"
    # the ladder saturates at the floors instead of emitting duplicates
    assert len(build_rungs(r, n_rungs=50)) < 50
    # backends without an nprobe knob still degrade via k_prime
    rungs_bf = build_rungs(base, n_rungs=2)
    assert rungs_bf[1].k_prime == rungs_bf[0].k_prime // 2


def test_slo_controller_downshift_and_hysteretic_recovery():
    rungs = ["full", "half", "quarter"]
    slo = SLOController(rungs, target_p99_ms=10.0, window=8, min_window=4,
                        eval_every=4, recover_frac=0.7, hold=3)
    assert slo.params() == "full"
    # sustained breach: one rung down per evaluation, never past the floor
    for _ in range(4):
        slo.observe(0.050)          # 50ms >> 10ms target
    assert slo.rung == 1
    for _ in range(4):
        slo.observe(0.050)
    assert slo.rung == 2 and slo.params() == "quarter"
    for _ in range(8):
        slo.observe(0.050)
    assert slo.rung == 2, "stepped past the last rung"
    # mid-band latencies (between recover_frac*target and target): hold
    for _ in range(16):
        slo.observe(0.009)          # 9ms: below target, above 7ms recover
    assert slo.rung == 2, "recovered without clearing the hysteresis band"
    # clean latencies: recovery needs `hold` consecutive clean evaluations
    # over an all-clean window
    for _ in range(8):
        slo.observe(0.001)
    assert slo.rung == 2
    for _ in range(8):
        slo.observe(0.001)          # 3rd clean evaluation -> step up
    assert slo.rung == 1
    for tr in slo.transitions:
        if tr.direction == "down":
            assert tr.p99_ms > tr.target_ms
        else:
            assert tr.p99_ms < 0.7 * tr.target_ms
    downs = [t for t in slo.transitions if t.direction == "down"]
    ups = [t for t in slo.transitions if t.direction == "up"]
    assert len(downs) == 2 and len(ups) == 1


def test_slo_window_cleared_on_transition():
    slo = SLOController([0, 1], target_p99_ms=10.0, min_window=4,
                        eval_every=4)
    for _ in range(4):
        slo.observe(0.050)
    assert slo.rung == 1
    assert np.isnan(slo.windowed_p99_ms()), (
        "stale pre-transition samples survived the downshift")


def test_router_slo_downshift_under_breach_and_recovery(base):
    """Fleet integration: a breached target walks dispatch down one rung
    (observable on future.params), a cleared target walks it back up."""
    r = base.with_backend("ivf", generator=gen(1))
    reps = clone_replicas(r, 2)
    rungs = build_rungs(reps[0], n_rungs=2)
    ladder = BucketLadder((8,), 2)
    warm_replicas(reps, ladder, base.cfg.d, params_list=rungs)
    slo = SLOController(rungs, target_p99_ms=1e-6, window=32, min_window=4,
                        eval_every=4, hold=2)
    q = _ragged_query(6, base.cfg.d, seed=8)
    with Router(reps, ladder=ladder, max_wait_us=200, slo=slo,
                stall_timeout_s=30.0) as router:
        futs = [router.submit(q) for _ in range(8)]
        for f in futs:
            f.result(timeout=TIMEOUT)
        assert slo.rung == 1, "SLO never downshifted under a breached target"
        assert futs[0].params == rungs[0]
        # dispatch now rides the degraded rung, with parity at that rung
        f = router.submit(q)
        _, ids = f.result(timeout=TIMEOUT)
        assert f.params == rungs[1]
        assert np.array_equal(ids, _direct(r, q, rungs[1])[1])
        # clear the target: hysteretic recovery back to rung 0
        slo.target_p99_ms = 1e9
        for _ in range(16):
            router.search(q, timeout=TIMEOUT)
        assert slo.rung == 0
        assert router.submit(q).params == rungs[0]
        downs = [t for t in slo.transitions if t.direction == "down"]
        assert downs and all(t.p99_ms > t.target_ms for t in downs)


# --------------------------------------------------------------------------
# fleet overload: typed rejects, nothing lost
# --------------------------------------------------------------------------

def test_fleet_overload_every_request_accounted(base):
    reps = clone_replicas(base, 2)
    ladder = BucketLadder((8,), 2)
    warm_replicas(reps, ladder, base.cfg.d)
    q = _ragged_query(6, base.cfg.d, seed=9)
    with Router(reps, ladder=ladder, max_wait_us=200, max_queue_depth=6,
                stall_timeout_s=30.0) as router:
        for srv in router.servers:
            srv.pause()
        futs = [router.submit(q) for _ in range(32)]
        for srv in router.servers:
            srv.resume()
        outcomes = {"ok": 0, "rejected": 0}
        for f in futs:
            try:
                f.result(timeout=TIMEOUT)
                outcomes["ok"] += 1
            except Overloaded:
                outcomes["rejected"] += 1
        assert outcomes["ok"] + outcomes["rejected"] == 32, "requests lost"
        assert outcomes["ok"] == 6 and outcomes["rejected"] == 26
        assert router.stats.n_rejected == 26
        # rejected requests never reached any replica queue
        served = sum(s.stats.summary()["n_requests"] for s in router.servers)
        assert served == 6


def test_router_submit_thread_safety(base):
    """Concurrent submitters: ids stay unique, every future resolves."""
    reps = clone_replicas(base, 2)
    ladder = BucketLadder((8,), 4)
    warm_replicas(reps, ladder, base.cfg.d)
    with Router(reps, ladder=ladder, max_wait_us=500,
                stall_timeout_s=30.0) as router:
        futs: list = []
        lock = threading.Lock()

        def client(seed):
            for i in range(8):
                f = router.submit(_ragged_query(4, base.cfg.d,
                                                seed=seed * 100 + i))
                with lock:
                    futs.append(f)

        threads = [threading.Thread(target=client, args=(s,))
                   for s in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for f in futs:
            f.result(timeout=TIMEOUT)
        rids = [f.request_id for f in futs]
        assert len(set(rids)) == len(rids) == 32


# --------------------------------------------------------------------------
# bounded observability state (a long-lived fleet must not leak)
# --------------------------------------------------------------------------

def test_router_event_log_bounded_with_dropped_counter(base):
    reps = clone_replicas(base, 1)
    with Router(reps, ladder=BucketLadder((8,), 2), stall_timeout_s=30.0,
                event_log_size=4) as router:
        assert router.events_dropped == 0
        with router._lock:
            for i in range(9):
                router._record_event(t=float(i), event="test", seq=i)
        evs = router.events()
        assert len(evs) == 4, "event ring exceeded its bound"
        assert [e["seq"] for e in evs] == [5, 6, 7, 8], "ring kept oldest"
        assert router.events_dropped == 5


def test_fleet_stats_latency_windows_bounded():
    from repro_torch.fleet.router import FleetStats

    st = FleetStats(window=8)
    for i in range(100):
        st.record_completed(0.001 * (i + 1), 0.001 * (i + 1), float(i))
    s = st.summary()
    assert s["n_requests"] == 100           # counters stay exact totals
    # percentile state only ever sees the window tail
    assert st._lat.maxlen == 8 and len(st._lat) == 8
    assert st._submit_lat.maxlen == 8 and len(st._submit_lat) == 8


# --------------------------------------------------------------------------
# SLO floor-rung edge: breach with nothing left to shed
# --------------------------------------------------------------------------

def test_slo_floor_breach_no_spurious_transition_and_recovery():
    """A sustained breach AT the floor rung must not clear the window or
    record same-rung transitions — and once load drops, the normal
    recovery hysteresis must still engage from real samples."""
    slo = SLOController([0, 1], target_p99_ms=10.0, window=8, min_window=4,
                        eval_every=4, recover_frac=0.7, hold=2)
    for _ in range(4):
        slo.observe(0.050)
    assert slo.rung == 1                    # at the floor now
    n_tr = len(slo.transitions)
    for _ in range(40):
        slo.observe(0.050)                  # sustained breach at the floor
    assert slo.rung == 1
    assert len(slo.transitions) == n_tr, (
        "breach at the floor recorded a spurious transition")
    assert slo.n_floor_breaches == 10       # every evaluation counted
    assert not np.isnan(slo.windowed_p99_ms()), (
        "floor breach cleared the latency window")
    # load drops: recovery must work exactly as from any other rung
    for _ in range(16):
        slo.observe(0.001)
    assert slo.rung == 0, "recovery hysteresis broken after floor breaches"


def test_slo_floor_breach_resets_clear_streak():
    """A breach evaluation at the floor interrupts a recovery streak: the
    controller must demand `hold` CONSECUTIVE clean evaluations again."""
    slo = SLOController([0, 1], target_p99_ms=10.0, window=4, min_window=4,
                        eval_every=4, recover_frac=0.7, hold=2)
    for _ in range(4):
        slo.observe(0.050)
    assert slo.rung == 1
    for _ in range(4):
        slo.observe(0.001)                  # clean eval #1 (streak 1/2)
    for _ in range(4):
        slo.observe(0.050)                  # breach at floor: streak reset
    for _ in range(4):
        slo.observe(0.001)                  # clean again: streak 1/2 only
    assert slo.rung == 1, "recovered without `hold` consecutive clean evals"
    for _ in range(4):
        slo.observe(0.001)                  # streak 2/2
    assert slo.rung == 0
