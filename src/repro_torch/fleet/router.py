"""Fleet router: N replicated retriever servers behind one serving surface
(twin of ``repro/fleet/router.py``).

Topology (see README "Fleet serving")::

    client -> Router.submit --+--> RetrieverServer[0] -> retriever.clone()
              (admission,     +--> RetrieverServer[1] -> retriever.clone()
               deadlines,     +--> ...
               least-outstanding dispatch, SLO rung selection)

Semantics the router guarantees (each asserted in ``tests/test_fleet.py``
and its twin ``tests/test_torch_fleet.py``):

* **Least-outstanding dispatch.**  Every search goes to the healthy
  replica with the fewest outstanding requests — queue depth stays
  balanced without any shared queue.
* **Exactly-once resolution.**  Every accepted request resolves exactly
  once — a result, a typed :class:`DeadlineExceeded`, or a typed
  :class:`Overloaded` — never a silent drop, never a duplicate, even
  across replica failure and re-dispatch.  ``future.request_id`` is the
  fleet-level id; ``future.replica`` says which replica answered.
* **Snapshot-consistent add.**  ``add()`` fans out to every healthy
  replica under the dispatch lock (so it lands at a consistent queue
  position fleet-wide) and returns a write-barrier future that resolves
  only when EVERY replica has applied the growth and landed on the same
  ``snapshot_version`` — after the barrier resolves, no search can observe
  the old corpus on any replica.  Quarantined replicas are excused; a
  replica whose add fails is quarantined (it diverged).
* **Admission control.**  When total outstanding requests reach
  ``max_queue_depth`` the submitted future resolves with
  :class:`Overloaded` — rejected requests are never dispatched, so they
  can never consume a micro-batch slot on any replica.
* **Health / quarantine.**  A replica with outstanding work whose server
  stops making progress for ``stall_timeout_s`` is quarantined: it stops
  receiving traffic, its in-flight requests are re-dispatched to healthy
  replicas (stale attempts are fenced by future identity, so a wedged
  replica that later revives cannot double-resolve), and pending write
  barriers excuse it.  ``kill_replica`` is quarantine + server teardown —
  the chaos hook the mid-replay-kill tests drive.
* **SLO adaptation.**  With an :class:`~repro_torch.fleet.slo.SLOController`
  attached, submits that don't pin ``params`` are dispatched at the
  controller's active rung; the controller walks the pre-warmed
  nprobe/k' ladder down on windowed-p99 breach and back up hysteretically.
"""
from __future__ import annotations

import collections
import dataclasses
import logging
import threading
import time
import weakref
from concurrent.futures import Future

import numpy as np

from repro_torch.serving.buckets import BucketLadder
from repro_torch.serving.server import DeadlineExceeded, Overloaded, RetrieverServer

log = logging.getLogger("repro_torch.fleet.router")


# --------------------------------------------------------------------------
# stats
# --------------------------------------------------------------------------

class FleetStats:
    """Fleet-level request accounting (thread-safe), mirroring
    :class:`~repro_torch.serving.server.ServerStats`'s summary contract so the
    shared replay loop works unchanged over a Router."""

    def __init__(self, window: int = 100_000):
        self._lock = threading.Lock()
        self._lat: collections.deque[float] = collections.deque(maxlen=window)
        self._submit_lat: collections.deque[float] = collections.deque(
            maxlen=window)
        self._n_completed = 0
        self._n_rejected = 0
        self._n_expired = 0
        self._n_redispatched = 0
        self._n_failed = 0
        self._t_first: float | None = None
        self._t_last: float | None = None

    def record_completed(self, arrival_lat_s: float, submit_lat_s: float,
                         t_done: float) -> None:
        with self._lock:
            self._lat.append(arrival_lat_s)
            self._submit_lat.append(submit_lat_s)
            self._n_completed += 1
            if self._t_first is None:
                self._t_first = t_done
            self._t_last = t_done

    def record_rejected(self, n: int = 1) -> None:
        with self._lock:
            self._n_rejected += n

    def record_expired(self, n: int = 1) -> None:
        with self._lock:
            self._n_expired += n

    def record_redispatched(self, n: int = 1) -> None:
        with self._lock:
            self._n_redispatched += n

    def record_failed(self, n: int = 1) -> None:
        with self._lock:
            self._n_failed += n

    @property
    def n_completed(self) -> int:
        with self._lock:
            return self._n_completed

    @property
    def n_rejected(self) -> int:
        with self._lock:
            return self._n_rejected

    @property
    def n_expired(self) -> int:
        with self._lock:
            return self._n_expired

    @property
    def n_redispatched(self) -> int:
        with self._lock:
            return self._n_redispatched

    def summary(self) -> dict:
        with self._lock:
            lat = np.fromiter(self._lat, np.float64)
            sub = np.fromiter(self._submit_lat, np.float64)
            n = self._n_completed
            span = ((self._t_last - self._t_first)
                    if (self._t_first is not None and n > 1) else 0.0)
            counters = {
                "n_rejected": self._n_rejected,
                "n_expired": self._n_expired,
                "n_redispatched": self._n_redispatched,
                "n_failed": self._n_failed,
            }
        pct = ({f"p{q}_ms": float(np.percentile(lat, q) * 1e3)
                for q in (50, 95, 99)} if lat.size else
               {f"p{q}_ms": float("nan") for q in (50, 95, 99)})
        sub_pct = ({f"submit_p{q}_ms": float(np.percentile(sub, q) * 1e3)
                    for q in (50, 95, 99)} if sub.size else
                   {f"submit_p{q}_ms": float("nan") for q in (50, 95, 99)})
        return {
            "n_requests": n,
            "mean_ms": float(np.mean(lat) * 1e3) if lat.size else float("nan"),
            **pct,
            **sub_pct,
            "qps": n / span if span > 0 else float("nan"),
            **counters,
        }


# --------------------------------------------------------------------------
# request + write barrier
# --------------------------------------------------------------------------

@dataclasses.dataclass
class _FleetRequest:
    rid: int
    q: np.ndarray
    qm: np.ndarray | None
    params: object            # resolved SearchParams this request runs at
    deadline: float | None    # absolute — preserved across re-dispatch
    t_arrival: float
    t_submit: float
    future: Future
    attempts: int = 0
    resolved: bool = False    # set under the router lock, exactly once
    current: Future | None = None  # the live replica attempt; fences stale
                                   # callbacks after re-dispatch


class _AddBarrier:
    """Write barrier over one mutation fan-out (``add``/``delete``/
    ``update``): resolves the aggregate future only when every armed
    replica has applied the mutation and landed on the same
    ``snapshot_version``.  ``excuse(i)`` drops a quarantined
    replica from the wait set; a replica whose add fails triggers
    ``on_fail`` (the router quarantines it).  All future resolution and
    the ``on_fail`` hook run OUTSIDE the barrier lock — the router may
    call ``excuse`` while holding its own lock, so the barrier must never
    call back into the router while holding its lock.  ``on_fail`` is held
    weakly (a ``weakref.WeakMethod``): the router keeps its barriers, and a
    strong reference back would make a cycle that keeps the router, its
    servers and their replicas' device memory alive until Python's cyclic
    collector runs."""

    def __init__(self, agg: Future, on_fail: weakref.WeakMethod):
        self._lock = threading.Lock()
        self._agg = agg
        self._on_fail = on_fail
        self._waiting: dict[int, Future] = {}
        self._versions: dict[int, int | None] = {}
        # typed rejections (exc.preserves_replica_state): the replica
        # REFUSED the mutation and provably kept its last-good snapshot —
        # e.g. ``CorruptIndexError`` from warm-swap validation.  Not a
        # replica failure: no quarantine, the aggregate carries the
        # rejection instead.
        self._rejections: dict[int, BaseException] = {}
        self._m: int | None = None
        self._sealed = False
        self.done = False

    def arm(self, i: int, rep_fut: Future) -> None:
        with self._lock:
            self._waiting[i] = rep_fut
        rep_fut.add_done_callback(lambda f, i=i: self._one_done(i, f))

    def seal(self) -> None:
        """Call after every arm(): enables completion (handles the
        all-replicas-already-done race)."""
        with self._lock:
            self._sealed = True
            fire = self._ready_locked()
        if fire is not None:
            self._finish(*fire)

    def excuse(self, i: int) -> None:
        with self._lock:
            if self.done:
                return
            self._waiting.pop(i, None)
            self._versions.pop(i, None)
            self._rejections.pop(i, None)
            fire = self._ready_locked()
        if fire is not None:
            self._finish(*fire)

    def _one_done(self, i: int, f: Future) -> None:
        fail = None
        fire = None
        with self._lock:
            if self.done or i not in self._waiting:
                return
            del self._waiting[i]
            if f.cancelled():
                fail = (i, RuntimeError("replica mutation cancelled"))
            elif f.exception() is not None:
                exc = f.exception()
                if getattr(exc, "preserves_replica_state", False):
                    self._rejections[i] = exc
                    fire = self._ready_locked()
                else:
                    fail = (i, exc)
            else:
                self._versions[i] = getattr(f, "snapshot_version", None)
                self._m = f.result()
                fire = self._ready_locked()
        if fail is not None:
            # the replica diverged from the fleet snapshot — quarantine it,
            # which excuses it from this (and every other) barrier
            on_fail = self._on_fail()
            if on_fail is not None:
                on_fail(fail[0], fail[1])
            with self._lock:
                fire = self._ready_locked()
        if fire is not None:
            self._finish(*fire)

    def _ready_locked(self):
        if self._sealed and not self._waiting and not self.done:
            self.done = True
            return dict(self._versions), self._m, dict(self._rejections)
        return None

    def _finish(self, versions: dict, m, rejections: dict) -> None:
        if rejections and not versions:
            # every surviving replica typed-rejected with state intact —
            # deterministic transforms land here (e.g. SwapAborted); the
            # fleet is still fully healthy on the last-good snapshot
            self._agg.set_exception(next(iter(rejections.values())))
            return
        if rejections:
            # some replicas applied, some rejected: genuine divergence
            self._agg.set_exception(RuntimeError(
                f"mutation divergence: replicas {sorted(rejections)} "
                f"rejected while {sorted(versions)} applied"))
            return
        if not versions:
            self._agg.set_exception(RuntimeError(
                "mutation failed: no replica completed the barrier"))
            return
        vs = set(versions.values())
        if len(vs) != 1:
            self._agg.set_exception(RuntimeError(
                f"snapshot divergence across replicas: {versions}"))
            return
        self._agg.snapshot_version = vs.pop()
        self._agg.set_result(m)


# --------------------------------------------------------------------------
# the router
# --------------------------------------------------------------------------

class Router:
    """Replicated serving fleet (see module docstring).

    ``replicas`` is a list of independent retriever replicas (from
    :func:`repro_torch.fleet.replica.clone_replicas`); the router owns one
    :class:`RetrieverServer` per replica.  Use as a context manager::

        reps = clone_replicas(retriever, 3)
        with Router(reps, ladder=ladder, max_queue_depth=256) as router:
            fut = router.submit(q_tokens, deadline_s=0.5)
            scores, ids = fut.result(timeout=30)
            router.add(new_tokens, new_mask).result(timeout=60)
    """

    def __init__(self, replicas, *, ladder: BucketLadder | None = None,
                 max_wait_us: int = 2000,
                 max_queue_depth: int | None = 128,
                 default_deadline_s: float | None = None,
                 default_params=None, slo=None,
                 stall_timeout_s: float = 1.0,
                 health_interval_s: float = 0.05,
                 event_log_size: int = 4096):
        if not replicas:
            raise ValueError("need at least one replica")
        self._ladder = ladder or BucketLadder()
        self._servers = [RetrieverServer(rep, ladder=self._ladder,
                                         max_wait_us=max_wait_us,
                                         default_params=default_params)
                         for rep in replicas]
        self._default_params = default_params
        self._max_queue_depth = max_queue_depth
        self._default_deadline_s = default_deadline_s
        self._slo = slo
        self._stall_timeout = float(stall_timeout_s)
        self._health_interval = float(health_interval_s)
        # RLock: barrier/quarantine paths re-enter from callbacks that can
        # run synchronously on the dispatching thread
        self._lock = threading.RLock()
        self._healthy = [True] * len(replicas)
        self._outstanding = [0] * len(replicas)
        self._inflight: list[dict[int, _FleetRequest]] = [
            {} for _ in replicas]
        self._barriers: list[_AddBarrier] = []
        # bounded audit ring: a long-running fleet must not grow without
        # limit; truncation is observable via ``events_dropped``
        self._events: collections.deque[dict] = collections.deque(
            maxlen=int(event_log_size))
        self._events_dropped = 0
        self._stats = FleetStats()
        self._rid = 0
        self._stopping = False
        self._stop_evt = threading.Event()
        self._monitor: threading.Thread | None = None

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "Router":
        for srv in self._servers:
            srv.start()
        self._stop_evt.clear()
        self._monitor = threading.Thread(target=self._monitor_loop,
                                         name="lemur-fleet-monitor",
                                         daemon=True)
        self._monitor.start()
        return self

    def stop(self, *, drain: bool = True, timeout: float | None = None) -> bool:
        with self._lock:
            self._stopping = True
        self._stop_evt.set()
        if self._monitor is not None:
            self._monitor.join(timeout=5.0)
            self._monitor = None
        ok = True
        for i, srv in enumerate(self._servers):
            if self._healthy[i]:
                ok &= srv.stop(drain=drain, timeout=timeout)
            else:
                # quarantined replicas may be wedged — never drain them
                srv.stop(drain=False, timeout=1.0)
        return ok

    def __enter__(self) -> "Router":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop(drain=exc == (None, None, None))

    # -- introspection ------------------------------------------------------

    @property
    def servers(self) -> list[RetrieverServer]:
        return list(self._servers)

    @property
    def ladder(self) -> BucketLadder:
        return self._ladder

    @property
    def stats(self) -> FleetStats:
        return self._stats

    @property
    def slo(self):
        return self._slo

    def reset_stats(self) -> FleetStats:
        old, self._stats = self._stats, FleetStats()
        return old

    @property
    def n_replicas(self) -> int:
        return len(self._servers)

    @property
    def n_healthy(self) -> int:
        with self._lock:
            return sum(self._healthy)

    def quarantined(self) -> list[int]:
        with self._lock:
            return [i for i, h in enumerate(self._healthy) if not h]

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    @property
    def events_dropped(self) -> int:
        """Audit-ring truncations: events evicted from the bounded
        ``events()`` buffer since construction."""
        with self._lock:
            return self._events_dropped

    def _record_event(self, **ev) -> None:
        # callers hold self._lock (RLock makes double-entry safe anyway)
        if len(self._events) == self._events.maxlen:
            self._events_dropped += 1
        self._events.append(ev)

    def pending(self) -> int:
        with self._lock:
            return sum(self._outstanding[i]
                       for i in range(len(self._servers)) if self._healthy[i])

    @property
    def m(self) -> int:
        return self._first_healthy_server().retriever.m

    @property
    def version(self) -> int:
        return self._first_healthy_server().retriever.version

    def trace_count(self, params=None) -> int:
        return sum(srv.trace_count(params) for srv in self._servers)

    def trace_shapes(self):
        out: dict[tuple, int] = {}
        for srv in self._servers:
            for shape, n in srv.trace_shapes().items():
                out[shape] = out.get(shape, 0) + n
        return out

    def compile_bound(self, n_param_sets: int = 1) -> int:
        """Fleet-wide compile bound: every replica accounts its own bucketed
        shapes (``trace_count`` sums over replicas the same way)."""
        return len(self._servers) * self._ladder.compile_bound(n_param_sets)

    def _first_healthy_server(self) -> RetrieverServer:
        with self._lock:
            for i, srv in enumerate(self._servers):
                if self._healthy[i]:
                    return srv
        raise RuntimeError("no healthy replicas")

    # -- client surface -----------------------------------------------------

    def submit(self, q_tokens, q_mask=None, params=None, *,
               deadline_s: float | None = None,
               deadline_at: float | None = None,
               t_arrival: float | None = None) -> Future:
        """Admit + dispatch one ragged query.  Always returns a future:
        on admission reject it resolves with :class:`Overloaded` (typed,
        async — unlike the single server's synchronous raise, so open-loop
        replays over a fleet never branch on submit).  ``params=None``
        dispatches at the SLO controller's active rung (when attached);
        the future carries ``params`` (which rung answered),
        ``request_id``, and — once resolved — ``replica`` and
        ``snapshot_version``."""
        now = time.perf_counter()
        arrival = now if t_arrival is None else float(t_arrival)
        dls = deadline_s if deadline_s is not None else self._default_deadline_s
        deadline = (float(deadline_at) if deadline_at is not None
                    else arrival + dls if dls is not None else None)
        fut: Future = Future()
        reject = None
        with self._lock:
            if self._stopping:
                raise RuntimeError("router is stopped")
            self._rid += 1
            fut.request_id = self._rid
            if params is None and self._slo is not None:
                resolved = self._slo.params()
            else:
                resolved = self._servers[0].retriever.resolve(
                    params if params is not None else self._default_params)
            fut.params = resolved
            total = sum(self._outstanding[i]
                        for i in range(len(self._servers)) if self._healthy[i])
            if (self._max_queue_depth is not None
                    and total >= self._max_queue_depth):
                self._stats.record_rejected()
                reject = Overloaded(
                    f"fleet outstanding {total} at bound "
                    f"{self._max_queue_depth}")
            else:
                req = _FleetRequest(self._rid, q_tokens, q_mask, resolved,
                                    deadline, arrival, now, fut)
                if not self._dispatch_locked(req):
                    req.resolved = True
                    reject = RuntimeError("no healthy replicas")
        if reject is not None:
            fut.set_exception(reject)
        return fut

    def search(self, q_tokens, q_mask=None, params=None,
               timeout: float | None = 60.0, **submit_kw):
        """Blocking convenience wrapper: ``submit(...).result(timeout)``."""
        return self.submit(q_tokens, q_mask, params,
                           **submit_kw).result(timeout)

    def add(self, doc_tokens, doc_mask, *, seed: int = 0) -> Future:
        """Snapshot-consistent growth fan-out (see module docstring).  The
        returned future resolves to the grown corpus size once EVERY
        healthy replica has landed on the same ``snapshot_version`` (also
        stamped on the future); until then no search observes the new docs
        on any replica, and per-replica FIFO barriers mean no search can
        ever observe them on one replica but not another in submit order."""
        return self._mutate(lambda srv: srv.add(doc_tokens, doc_mask,
                                                seed=seed))

    def delete(self, doc_ids) -> Future:
        """Snapshot-consistent tombstone fan-out: every healthy replica
        deletes the same stable external ids under its FIFO barrier and
        must land on the same ``snapshot_version``.  Resolves to the
        surviving live-doc count ``n_alive``."""
        return self._mutate(lambda srv: srv.delete(doc_ids))

    def update(self, doc_ids, doc_tokens, doc_mask, *, seed: int = 0) -> Future:
        """Snapshot-consistent replace fan-out (delete+add, ONE version
        bump per replica).  Resolves to the NEW external ids — identical on
        every replica because the shared OLS solver makes ``fit_docs``
        deterministic and slot allocation is deterministic."""
        return self._mutate(lambda srv: srv.update(doc_ids, doc_tokens,
                                                   doc_mask, seed=seed))

    def apply(self, fn) -> Future:
        """Snapshot-consistent generic transform fan-out — the warm-swap
        path.  ``fn(retriever)`` runs inside every healthy replica's FIFO
        mutation barrier (``RetrieverServer.apply``); the fleet barrier then
        requires all replicas to land on the same ``snapshot_version``,
        which a deterministic transform (e.g. ``install_refresh`` of one
        shared ``RefreshResult``) guarantees.  A replica that fails its arm
        is quarantined and excused; if validation rejects the transform on
        every replica identically (e.g. ``CorruptIndexError``), the
        aggregate future carries that exception and every replica keeps its
        last-good snapshot."""
        return self._mutate(lambda srv: srv.apply(fn))

    def _mutate(self, enqueue) -> Future:
        """Fan one mutation out to every healthy replica under an
        :class:`_AddBarrier` (a failed/cancelled replica arm quarantines
        that replica and is excused — the barrier resolves typed either
        way, never hangs)."""
        agg: Future = Future()
        barrier = _AddBarrier(agg, weakref.WeakMethod(self._on_add_fail))
        arms: list[tuple[int, Future]] = []
        with self._lock:
            if self._stopping:
                raise RuntimeError("router is stopped")
            self._barriers = [b for b in self._barriers if not b.done]
            self._barriers.append(barrier)
            for i, srv in enumerate(self._servers):
                if not self._healthy[i]:
                    continue
                try:
                    arms.append((i, enqueue(srv)))
                except RuntimeError:
                    continue  # raced teardown — health sweep will quarantine
            if not arms:
                raise RuntimeError("no healthy replicas")
            for i, f in arms:
                barrier.arm(i, f)
        barrier.seal()
        return agg

    # -- dispatch + completion ----------------------------------------------

    def _dispatch_locked(self, req: _FleetRequest) -> bool:
        """Least-outstanding dispatch; bookkeeping is recorded BEFORE the
        replica submit so a synchronously-firing completion callback finds
        it consistent.  Returns False when no healthy replica accepts."""
        while True:
            cands = [i for i in range(len(self._servers)) if self._healthy[i]]
            if not cands:
                return False
            i = min(cands, key=lambda j: self._outstanding[j])
            self._outstanding[i] += 1
            self._inflight[i][req.rid] = req
            req.attempts += 1
            try:
                rep_fut = self._servers[i].submit(
                    req.q, req.qm, req.params,
                    deadline_at=req.deadline, t_arrival=req.t_arrival)
            except Exception:  # noqa: BLE001 — replica refused: not healthy
                self._inflight[i].pop(req.rid, None)
                self._outstanding[i] -= 1
                self._healthy[i] = False
                self._record_event(t=time.perf_counter(),
                                   event="quarantine", replica=i,
                                   reason="submit refused")
                continue
            req.current = rep_fut
            rep_fut.add_done_callback(
                lambda f, i=i, req=req: self._on_replica_done(i, req, f))
            return True

    def _on_replica_done(self, i: int, req: _FleetRequest, f: Future) -> None:
        outcome = None   # ("result", v) | ("exc", e) | ("cancel", None)
        lat = None
        with self._lock:
            if f is not req.current:
                return  # stale attempt — the request was re-dispatched
            if self._inflight[i].pop(req.rid, None) is not None:
                self._outstanding[i] -= 1
            if req.resolved:
                return
            t_done = time.perf_counter()
            if f.cancelled():
                # the replica was torn down mid-service without quarantine
                # having re-homed this request (e.g. direct server stop)
                if not self._stopping:
                    req.current = None
                    self._stats.record_redispatched()
                    if self._dispatch_locked(req):
                        return
                req.resolved = True
                outcome = ("cancel", None)
            else:
                exc = f.exception()
                req.resolved = True
                if exc is None:
                    req.future.snapshot_version = getattr(
                        f, "snapshot_version", None)
                    req.future.replica = i
                    lat = t_done - req.t_arrival
                    self._stats.record_completed(lat, t_done - req.t_submit,
                                                 t_done)
                    outcome = ("result", f.result())
                elif isinstance(exc, DeadlineExceeded):
                    lat = t_done - req.t_arrival
                    self._stats.record_expired()
                    outcome = ("exc", DeadlineExceeded(req.rid, lat))
                else:
                    self._stats.record_failed()
                    outcome = ("exc", exc)
            # the attempt's callback holds ``req`` and ``req.current`` the
            # attempt: drop the attempt once resolved, so no cycle keeps the
            # router (and its replicas) alive past its last reference
            req.current = None
        # resolve + SLO feedback outside the lock (client callbacks on the
        # fleet future must not run under the dispatch lock)
        kind, val = outcome
        if kind == "result":
            req.future.set_result(val)
        elif kind == "exc":
            req.future.set_exception(val)
        else:
            req.future.cancel()
        if lat is not None and self._slo is not None:
            # expiries feed the controller too — under total overload every
            # request can expire, and the SLO must still see the breach
            self._slo.observe(lat, t_done)

    # -- health -------------------------------------------------------------

    def quarantine(self, i: int, reason: str = "") -> int:
        """Take replica ``i`` out of rotation: stop dispatching to it,
        re-dispatch its in-flight requests to healthy replicas (stale
        attempts are fenced via ``req.current``), and excuse it from every
        pending write barrier.  Idempotent; returns how many requests were
        re-homed."""
        orphans: list[_FleetRequest] = []
        with self._lock:
            if not self._healthy[i]:
                return 0
            self._healthy[i] = False
            self._record_event(t=time.perf_counter(),
                               event="quarantine", replica=i,
                               reason=reason)
            log.warning("quarantining replica %d: %s", i, reason)
            reqs = [r for r in self._inflight[i].values() if not r.resolved]
            self._inflight[i].clear()
            self._outstanding[i] = 0
            for req in reqs:
                req.current = None  # fence: the old attempt can no longer win
                self._stats.record_redispatched()
                if not self._dispatch_locked(req):
                    req.resolved = True
                    orphans.append(req)
            barriers = [b for b in self._barriers if not b.done]
        for b in barriers:
            b.excuse(i)
        for req in orphans:
            req.future.set_exception(RuntimeError(
                f"no healthy replicas (request {req.rid})"))
        return len(reqs)

    def kill_replica(self, i: int, *, timeout: float = 5.0) -> int:
        """Chaos hook: quarantine + tear the replica's server down
        (cancelling whatever it still holds).  Every request it was serving
        is re-dispatched first, so nothing is dropped."""
        n = self.quarantine(i, reason="killed")
        self._servers[i].stop(drain=False, timeout=timeout)
        return n

    def _on_add_fail(self, i: int, exc: BaseException | None) -> None:
        self.quarantine(i, reason=f"mutation failed: {exc!r}")

    def _monitor_loop(self) -> None:
        while not self._stop_evt.wait(self._health_interval):
            now = time.perf_counter()
            with self._lock:
                stalled = [
                    i for i in range(len(self._servers))
                    if self._healthy[i] and self._outstanding[i] > 0
                    and now - self._servers[i].progress_time
                    > self._stall_timeout]
            for i in stalled:
                self.quarantine(
                    i, reason=f"no progress for > {self._stall_timeout:.2f}s "
                              f"with outstanding work")


__all__ = ["FleetStats", "Router"]
