"""The port's learned-index lifecycle (``repro_torch.lifecycle``), the twin
of ``tests/test_lifecycle.py`` on port-built retrievers on the CPU.

Contracts hardened here:

* **Mutation tap.**  ``core.pages`` notifies registered taps on add/delete
  with host payloads; a broken tap can never corrupt a mutation.
* **Drift signal.**  In-distribution adds keep the monitor quiet; a
  distribution shift (new topic centers) trips the typed ``DriftReport``.
  Fleet dedupe: two replicas applying the same logical add are counted once.
* **Refresh determinism + efficacy.**  ``build_refresh`` is bit-reproducible
  given (snapshot, seed); installing it recovers the exact-scan recall a
  drifted corpus lost, to within 2% of a from-scratch rebuild.
* **Install validation.**  Corrupt rebuilds (backend mismatch, bad shape,
  NaNs, truncated ann) raise ``CorruptIndexError`` with the served snapshot
  provably untouched.
* **Swap/search interleaving bit-identity.**  Random interleavings of
  ``submit``/``add``/``delete``/warm swap through the server resolve every
  future bit-identical to a direct search against a REPLAY of the exact
  snapshot version stamped on it — fp32 and SQ8.  Every shape here is one
  bucket (Tq 32, batch 1 … 4), which the replay serves at batch 1: the ids
  are bit-identical, the scores to rtol 1e-5 / atol 1e-6 as in the JAX
  suite.

This file imports no JAX (``tests/test_torch_lifecycle_parity.py`` holds
the port to the JAX package).  Every wait carries a timeout so a wedged
barrier fails, not hangs.
"""
import sys
import threading
import time

import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro_torch.core import maxsim as mx
from repro_torch.core import pages
from repro_torch.core.config import LemurConfig
from repro_torch.data import synthetic
from repro_torch.lifecycle import (ChaosInjector, DriftMonitor, LifecycleManager,
                                   RefreshCompleted, SwapCompleted, build_refresh)
from repro_torch.lifecycle.events import EventLog, LifecycleEvent
from repro_torch.retriever import (CorruptIndexError, IVFBackendConfig,
                                   LemurRetriever, SearchParams)
from repro_torch.retriever.facade import search_pipeline
from repro_torch.serving import BucketLadder, RetrieverServer

TIMEOUT = 120.0
PARAMS = SearchParams(k=5, k_prime=60)


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


def _in_dist(n, seed=0, skip=300):
    """Docs from the SAME topic centers as tiny_corpus (seed 0)."""
    big = synthetic.make_corpus(m=skip + n, d=16, avg_tokens=8, max_tokens=12,
                                n_centers=24, seed=seed)
    return big.doc_tokens[skip:], big.doc_mask[skip:]


def _shifted(n, seed=777, strength=4.0):
    """Docs from DIFFERENT, strongly-expressed topic centers — a topic
    burst the frozen quantizer has never seen (the drift scenario)."""
    c = synthetic.make_corpus(m=n, d=16, avg_tokens=8, max_tokens=12,
                              n_centers=6, topic_strength=strength, seed=seed)
    return c.doc_tokens, c.doc_mask


def _query(tq, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((tq, 16)).astype(np.float32)
    return q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-9)


# --------------------------------------------------------------------------
# mutation tap
# --------------------------------------------------------------------------

def test_mutation_tap_payloads_and_isolation(base):
    r = base.clone()
    seen = []

    def tap(kind, ids, **payload):
        seen.append((kind, np.asarray(ids).copy(), set(payload)))

    def broken(kind, ids, **payload):
        raise RuntimeError("observer bug")

    pages.register_mutation_tap(tap)
    pages.register_mutation_tap(broken)
    try:
        toks, mask = _in_dist(4)
        r.add(toks, mask)               # broken tap must not break the add
        r.delete(r.last_added_ids[:2])
    finally:
        pages.unregister_mutation_tap(tap)
        pages.unregister_mutation_tap(broken)
    kinds = [s[0] for s in seen]
    assert kinds == ["add", "delete"]
    assert seen[0][2] == {"doc_tokens", "doc_mask", "w"}
    np.testing.assert_array_equal(seen[1][1], r.last_added_ids[:2])
    # unregistered: further mutations are silent
    n = len(seen)
    r.add(toks, mask)
    assert len(seen) == n


# --------------------------------------------------------------------------
# drift monitor
# --------------------------------------------------------------------------

def test_drift_monitor_quiet_in_distribution(base):
    r = base.clone()
    with DriftMonitor(r, reservoir=128, probes=64, seed=1) as mon:
        toks, mask = _in_dist(96)
        r.add(toks, mask)
        rep = mon.report()
    assert rep.n_reservoir == 96
    assert not rep.triggered, rep
    assert rep.fidelity_drop < 0.10
    assert rep.skew <= 0.25
    assert rep.coverage_ratio >= 0.35   # well clear of the 0.25 trigger


def test_drift_monitor_triggers_on_shift(base):
    r = base.clone()
    with DriftMonitor(r, reservoir=128, probes=64, seed=1) as mon:
        assert mon.maybe_report(min_reservoir=8) is None  # empty reservoir
        toks, mask = _shifted(96)
        r.add(toks, mask)
        r.delete(np.arange(0, 60))      # and the fit loses its support
        rep = mon.maybe_report(min_reservoir=8)
    assert rep is not None and rep.triggered, rep
    assert "coverage" in rep.reason
    assert rep.n_reservoir == 96


def test_drift_monitor_baseline_docs(base):
    """``baseline_docs`` sets how many alive docs the baseline measures
    (64 by default, as in the JAX package), at attach and at reset, so a
    baseline can be taken over as many docs as a full reservoir's report."""
    r = base.clone()
    for n, want in ((None, 64), (128, 128), (10_000, r.n_alive)):
        kw = {} if n is None else {"baseline_docs": n}
        mon = DriftMonitor(r, reservoir=128, probes=64, seed=1, **kw)
        seen = []
        fid = mon._fidelity
        mon._fidelity = lambda ids, t, m: seen.append(len(ids)) or fid(ids, t, m)
        with mon:
            mon.reset()
        assert seen == [want, want], (n, seen)


def test_drift_monitor_dedupes_fleet_replicas(base):
    r1, r2 = base.clone(), base.clone()
    with DriftMonitor(r1, reservoir=64, seed=1) as mon:
        toks, mask = _in_dist(8)
        r1.add(toks, mask)              # same logical mutation, two replicas
        r2.add(toks, mask)
        assert mon.n_mutations == 1
        assert mon.n_reservoir == 8
        r1.delete(r1.last_added_ids[:3])
        r2.delete(r2.last_added_ids[:3])
        assert mon.n_mutations == 2
        assert mon.n_reservoir == 5


# --------------------------------------------------------------------------
# refresh + install
# --------------------------------------------------------------------------

def _drift(r, *, n_add=96, n_del=60, seed=777):
    toks, mask = _shifted(n_add, seed=seed)
    r.add(toks, mask)
    if n_del:
        r.delete(np.arange(n_del))
    return r


def test_build_refresh_deterministic(base):
    r = _drift(base.clone())
    a = build_refresh(r, seed=3)
    b = build_refresh(r, seed=3)
    assert a.m0 == b.m0 and a.version == b.version
    assert torch.equal(a.W, b.W)
    assert torch.equal(a.ann.centroids, b.ann.centroids)
    assert torch.equal(a.ann.ids, b.ann.ids)


def _exact_recall(r, q, qm, truth, k=5):
    p = SearchParams(k=k, k_prime=64, use_ann=False)
    _, ids = r.search(q, qm, p)
    return float(mx.recall_at(ids, truth).mean())


def test_install_refresh_recovers_recall(base, tiny_corpus):
    """The acceptance gate in miniature: post-swap exact-scan recall within
    2% of a from-scratch rebuild on the same final corpus."""
    r = _drift(base.clone())
    res = build_refresh(r, seed=3)
    toks_extra, mask_extra = _shifted(16, seed=888)
    r.add(toks_extra, mask_extra)       # post-snapshot adds -> catch-up path
    v0 = r.version
    r.install_refresh(res)
    assert r.version == v0 + 1
    assert r._last_refresh_caught_up == 16

    # truth on the final live corpus
    alive = torch.nonzero(r.index.store.alive[:r.m]).flatten()
    dt, dm = pages.gather_docs(r.index.store, alive)
    q = torch.as_tensor(synthetic.queries_held_out(
        synthetic.make_corpus(m=8, d=16, avg_tokens=8, max_tokens=12,
                              n_centers=6, topic_strength=4.0, seed=777),
        32, q_tokens=4, topic_strength=4.0, seed=9))
    qm = torch.ones(q.shape[:2], dtype=torch.bool)
    _, t_ids = mx.true_topk(q, qm, dt, dm, 5)
    truth = alive[t_ids.long()].to(torch.int32)

    swapped = _exact_recall(r, q, qm, truth)
    # from-scratch rebuild on the final live corpus
    live = synthetic.MultiVectorCorpus(dt.numpy(), dm.numpy(),
                                       np.zeros((len(alive), 1), np.int32),
                                       np.zeros((1, 16), np.float32))
    fresh = LemurRetriever.build(live, base.cfg, generator=gen(0), device="cpu")
    f_ids = fresh.search(q, qm, SearchParams(k=5, k_prime=64,
                                             use_ann=False))[1]
    f_truth = mx.true_topk(q, qm, dt, dm, 5)[1]
    rebuild = float(mx.recall_at(f_ids, f_truth).mean())
    assert swapped >= rebuild - 0.02, (swapped, rebuild)


def _set(t: torch.Tensor, where, value) -> torch.Tensor:
    """A copy of ``t`` with ``t[where] = value`` (JAX's ``.at[].set``)."""
    out = t.clone()
    out[where] = value
    return out


def test_install_refresh_rejects_corrupt(base):
    r = _drift(base.clone())
    res = build_refresh(r, seed=3)
    snap, ver, solver = r.snapshot(), r.version, r._solver
    for broken in [
        res._replace(backend="muvera"),
        res._replace(m0=r.m + 7),
        res._replace(W=res.W[:-1]),
        res._replace(W=_set(res.W, (0, 0), float("nan"))),
        res._replace(solver={"chol": res.solver["chol"]}),
        res._replace(ann=res.ann._replace(
            ids=torch.full_like(res.ann.ids, 10 ** 6))),   # out-of-range candidates
    ]:
        with pytest.raises(CorruptIndexError):
            r.install_refresh(broken)
        assert r.snapshot() is snap          # provably untouched
        assert r.version == ver and r._solver is solver
    r.install_refresh(res)                   # the pristine result still lands
    assert r.version == ver + 1


def test_event_log_bounded():
    log = EventLog(maxlen=4)
    for i in range(7):
        log.append(LifecycleEvent(t=float(i)))
    assert len(log) == 4
    assert log.dropped == 3
    assert [e.t for e in log.events()] == [3.0, 4.0, 5.0, 6.0]


def test_chaos_injector_arms_once():
    ch = ChaosInjector()
    ch.fail_at("p", times=2)
    for _ in range(2):
        with pytest.raises(Exception):
            ch.check("p")
    ch.check("p")                            # disarmed after `times` fires
    assert ch.fired("p") == 2


# --------------------------------------------------------------------------
# warm swap through the server: FIFO barrier + replay bit-identity
# --------------------------------------------------------------------------

def _replay(base, log, upto):
    """Rebuild the exact snapshot after the first ``upto`` mutations."""
    r = base.clone()
    for op in log[:upto]:
        if op[0] == "add":
            r.add(op[1], op[2], seed=op[3])
        elif op[0] == "delete":
            r.delete(op[1])
        else:
            r.install_refresh(op[1])
    return r


def _check_interleaving(base, seed, n_ops=18):
    rng = np.random.default_rng(seed)
    serve_r = base.clone()
    v0 = serve_r.version
    mlog = []           # ordered mutation log, exact payloads
    searches = []       # (future, q, qm)
    ladder = BucketLadder((32,), max_batch=4)
    with RetrieverServer(serve_r, ladder=ladder, max_wait_us=200,
                         default_params=PARAMS) as srv:
        mut_futs = []
        for k in range(n_ops):
            roll = rng.random()
            if roll < 0.45:
                q = _query(int(rng.integers(2, 10)), seed=1000 * seed + k)
                qm = np.ones(q.shape[0], bool)
                searches.append((srv.submit(q, qm), q, qm))
            elif roll < 0.65:
                toks, mask = _in_dist(int(rng.integers(2, 6)),
                                      seed=int(rng.integers(1, 10)))
                s = int(rng.integers(0, 100))
                mlog.append(("add", toks, mask, s))
                mut_futs.append(srv.add(toks, mask, seed=s))
            elif roll < 0.8 and mlog:
                # delete something known-alive: replay the log so far
                ref = _replay(base, mlog, len(mlog))
                alive = np.flatnonzero(ref.index.store.alive.numpy())
                pick = rng.choice(alive, size=min(2, alive.size),
                                  replace=False).astype(np.int32)
                mlog.append(("delete", pick))
                mut_futs.append(srv.delete(pick))
            else:
                for f in mut_futs:
                    f.result(timeout=TIMEOUT)   # settle, then snapshot
                res = build_refresh(serve_r, seed=int(rng.integers(100)))
                mlog.append(("swap", res))
                mut_futs.append(srv.apply(
                    lambda r, res=res: r.install_refresh(res)))
        for f in mut_futs:
            f.result(timeout=TIMEOUT)
    # every resolved search: bit-identical to a replay of its stamped version
    assert len(mlog) == serve_r.version - v0
    for fut, q, qm in searches:
        s, ids = fut.result(timeout=TIMEOUT)
        v = fut.snapshot_version
        assert v is not None
        rep = _replay(base, mlog, v - v0)
        assert rep.version == v
        ws, wi = rep.search(q[None], qm[None], PARAMS)
        np.testing.assert_array_equal(ids, wi[0].numpy())
        np.testing.assert_allclose(s, ws[0].numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_swap_interleaving_bit_identity_fp32(base, seed):
    _check_interleaving(base, seed)


def test_swap_interleaving_bit_identity_sq8(base):
    cfg = base.cfg.replace(anns="ivf", ivf=IVFBackendConfig(sq8=True,
                                                            nprobe=16))
    sq8 = base.with_backend("ivf", generator=gen(1), cfg=cfg)
    _check_interleaving(sq8, 2)


@settings(deadline=None, max_examples=4)
@given(seed=st.integers(10, 10_000))
def test_swap_interleaving_bit_identity_random(base, seed):
    _check_interleaving(base, seed, n_ops=12)


def test_server_swap_is_fifo_barrier(base):
    """Searches enqueued before the swap resolve at the old version, after
    at the new — regardless of when results are awaited."""
    serve_r = base.clone()
    res = build_refresh(serve_r, seed=5)
    q = _query(4, seed=0)
    qm = np.ones(4, bool)
    with RetrieverServer(serve_r, ladder=BucketLadder((32,), max_batch=2),
                         max_wait_us=100, default_params=PARAMS) as srv:
        srv.pause()
        before = [srv.submit(q, qm) for _ in range(3)]
        swap = srv.apply(lambda r: r.install_refresh(res))
        after = [srv.submit(q, qm) for _ in range(3)]
        srv.resume()
        swap.result(timeout=TIMEOUT)
        v1 = serve_r.version
        for f in after:
            f.result(timeout=TIMEOUT)
            assert f.snapshot_version == v1
        for f in before:
            f.result(timeout=TIMEOUT)
            assert f.snapshot_version == v1 - 1


def test_lifecycle_manager_closes_the_loop(base):
    """Server + manager, manual drive: drift -> refresh -> swap with typed
    events and a version bump; monitor recalibrated afterwards."""
    serve_r = base.clone()
    with RetrieverServer(serve_r, ladder=BucketLadder((32,), max_batch=4),
                         max_wait_us=200, default_params=PARAMS) as srv:
        mon = DriftMonitor(serve_r, reservoir=128, probes=64, seed=1)
        mgr = LifecycleManager(srv, monitor=mon, seed=3, cooldown_s=0.0,
                               min_reservoir=8)
        mgr.start(auto=False)
        try:
            toks, mask = _shifted(96)
            srv.add(toks, mask).result(timeout=TIMEOUT)
            srv.delete(np.arange(60)).result(timeout=TIMEOUT)
            v0 = serve_r.version
            assert mgr.poll_once()          # triggered -> refresh -> swap
            assert serve_r.version == v0 + 1
            assert mgr.n_swaps == 1
            assert mgr.events(RefreshCompleted)
            done = mgr.events(SwapCompleted)
            assert done and done[-1].version == serve_r.version
            assert mon.n_reservoir == 0     # reset after swap
            # post-swap: a search still answers
            srv.search(_query(4, 1), np.ones(4, bool), timeout=TIMEOUT)
        finally:
            mgr.stop()


# --------------------------------------------------------------------------
# threads: readers beside the mutating worker see whole versions
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["locked", "snapshot"])
def test_snapshot_race_readers_see_whole_versions(base, kind):
    """The facade writes its index in place, so a reader on another thread
    than the server's worker either holds ``r.lock`` for its whole reading
    (``locked``: no snapshot is taken, so every mutation writes in place)
    or reads a ``snapshot()`` taken under it (``snapshot``: the mutations
    copy what they write).  Ten reader threads do so over and over while
    the worker applies a seeded schedule of adds and deletes (switch
    interval shortened to interleave them finely); every reading must equal
    a direct search of a REPLAY of the version it recorded, and so must
    every served search."""
    rng = np.random.default_rng(11)
    serve_r = base.clone()
    v0, m = serve_r.version, serve_r.m
    resolved = serve_r.resolve(PARAMS)
    queries = [_query(int(rng.integers(2, 10)), seed=500 + i) for i in range(4)]
    queries = [(q, np.ones(q.shape[0], bool)) for q in queries]
    mlog, alive = [], set(range(m))
    for _ in range(48):
        if rng.random() < 0.5:
            toks, mask = _in_dist(int(rng.integers(2, 6)), seed=int(rng.integers(1, 10)))
            s = int(rng.integers(0, 100))
            mlog.append(("add", toks, mask, s))
            alive.update(range(m, m + len(toks)))
            m += len(toks)
        else:
            pick = rng.choice(sorted(alive), size=2, replace=False).astype(np.int32)
            mlog.append(("delete", pick))
            alive.difference_update(pick.tolist())

    readings = []            # (version, query index, scores, ids)
    lock = threading.Lock()
    stop = threading.Event()

    def reader(k: int) -> None:
        i = 0
        while not stop.is_set():
            qi = (k + i) % len(queries)
            q, qm = queries[qi]
            if kind == "snapshot":
                with serve_r.lock:          # the snapshot and its version together
                    idx, v = serve_r.snapshot(), serve_r.version
                s, ids = search_pipeline(idx, torch.as_tensor(q[None]),
                                         torch.as_tensor(qm[None]), resolved)
            else:
                with serve_r.lock:          # the whole reading under the lock
                    v = serve_r.version
                    s, ids = serve_r.search(q[None], qm[None], PARAMS)
            with lock:
                readings.append((v, qi, s[0].numpy(), ids[0].numpy()))
            i += 1
    old_switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=reader, args=(k,), daemon=True) for k in range(10)]
    try:
        served = []
        with RetrieverServer(serve_r, ladder=BucketLadder((32,), max_batch=4),
                             max_wait_us=200, default_params=PARAMS) as srv:
            for t in threads:
                t.start()
            futs = []
            for k, op in enumerate(mlog):
                q, qm = queries[k % len(queries)]
                served.append((srv.submit(q, qm), k % len(queries)))
                if op[0] == "add":
                    futs.append(srv.add(op[1], op[2], seed=op[3]))
                else:
                    futs.append(srv.delete(op[1]))
            for f in futs:
                f.result(timeout=TIMEOUT)
            time.sleep(0.05)                # readings of the last version too
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=TIMEOUT)
        sys.setswitchinterval(old_switch)
    assert not any(t.is_alive() for t in threads), "a reader hung"
    assert serve_r.version == v0 + len(mlog) and set(
        np.flatnonzero(serve_r.index.store.alive.numpy()).tolist()) == alive
    for f, qi in served:
        s, ids = f.result(timeout=TIMEOUT)
        readings.append((f.snapshot_version, qi, s, ids))
    versions = {v for v, *_ in readings}
    assert len(versions) >= 3, f"readers saw only versions {versions}"
    want = {}
    for v in sorted(versions):
        rep = _replay(base, mlog, v - v0)
        want[v] = [rep.search(q[None], qm[None], PARAMS) for q, qm in queries]
    for v, qi, s, ids in readings:
        ws, wi = want[v][qi]
        np.testing.assert_array_equal(ids, wi[0].numpy(), err_msg=f"version {v}")
        np.testing.assert_allclose(s, ws[0].numpy(), rtol=1e-5, atol=1e-6)
