"""RetrieverServer: the online serving runtime in front of the facade (twin
of ``repro/serving/server.py``).

Offline serving feeds fixed-shape query slabs to ``LemurRetriever.search``.
Real traffic is ragged single queries arriving asynchronously — this module
turns the facade (or its sharded twin) into an online service:

* **Dynamic micro-batching.**  ``submit()`` enqueues a request and returns
  a future; a single worker thread coalesces in-flight requests that share
  a (Tq bucket, resolved ``SearchParams``) group into one micro-batch, up
  to ``max_batch`` requests or ``max_wait_us`` of head-of-line waiting,
  whichever comes first.
* **Shape bucketing.**  Requests are padded per :class:`~repro_torch.
  serving.buckets.BucketLadder` so the served shapes stay bounded by
  ``ladder.compile_bound()`` regardless of traffic shape churn (padded
  token rows are exact no-ops; padded batch rows are sliced away).  The
  padded slab goes to the retriever's device in one copy, and each
  micro-batch's real rows come back to the host in one copy (which also
  waits for the device).  Returned top-k ids equal those of a direct
  ``retriever.search()`` of the raw ragged query, up to near-ties where the
  padded shape sums in another order (a relative score gap under 1e-5);
  scores match to float-reduction tolerance.
* **Streaming mutation.**  ``add()`` / ``delete()`` / ``update()`` enqueue
  corpus mutations that act as queue barriers: searches submitted before
  one complete against the old snapshot, the worker then applies the
  retriever mutation between micro-batches (the worker is the only thread
  that mutates the retriever; the facade holds its lock across the
  mutation, so a reader on another thread that takes it, or a
  ``snapshot()``, sees a whole index), and every later search sees the
  mutated corpus.  Every barrier future resolves — drained, failed typed,
  or cancelled on a non-drain stop — never leaked.
* **Deadlines.**  ``submit(..., deadline_s=...)`` bounds how long a request
  may wait for service: a request whose deadline has passed when the worker
  would admit it to a micro-batch resolves with a typed
  :class:`DeadlineExceeded` (a ``TimeoutError`` subclass carrying the
  request id) instead of being served late — expired requests never occupy
  a micro-batch slot and are never silently dropped.  Deadlines gate batch
  ADMISSION: a request that expires while its batch is already executing
  still resolves with its (late) result — launched kernels are not
  preempted.
* **Admission control.**  ``max_queue_depth`` bounds the queue: when full,
  ``submit()`` raises a typed :class:`Overloaded` instead of accepting
  unbounded latency.  Rejected requests are never enqueued, so they can
  never consume a micro-batch slot.  ``add()`` is exempt — growth ops must
  land on every replica for fleet snapshot consistency.
* **Observability.**  :class:`ServerStats` tracks per-request latency
  percentiles (p50/p95/p99) measured from each request's *scheduled arrival*
  (``t_arrival``, free of coordinated omission under open-loop replay) with
  the submit-call-relative twins alongside (``submit_p*_ms``), QPS over the
  serving window, micro-batch occupancy and bucket histograms, and
  rejected/expired counters; ``trace_count()``/``trace_shapes()`` pass
  through to the underlying retriever.

The server works over any object with the facade serving surface
(``search``/``add``/``resolve``/``trace_count``) — both ``LemurRetriever``
and ``ShardedLemurRetriever`` — on whatever device it serves from.
``pause()``/``resume()`` wedge the worker without losing queue state — the
chaos hook the fleet router's health monitor and the drain-ordering tests
are built on.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Any

import numpy as np
import torch

from repro_torch.serving.buckets import BucketLadder


# --------------------------------------------------------------------------
# typed serving outcomes
# --------------------------------------------------------------------------

class DeadlineExceeded(TimeoutError):
    """A request's deadline expired before it was admitted to a micro-batch.

    Set as the future's exception (never a silent drop), so callers always
    observe a typed timeout.  ``request_id`` identifies the request."""

    def __init__(self, request_id: int | None = None, waited_s: float = 0.0):
        self.request_id = request_id
        self.waited_s = waited_s
        super().__init__(
            f"request {request_id} deadline exceeded after {waited_s*1e3:.1f}ms")


class Overloaded(RuntimeError):
    """Admission control rejected a request: the queue (or the fleet) is at
    its depth bound.  Raised synchronously by ``RetrieverServer.submit`` and
    set as the future's exception by the fleet ``Router`` — either way the
    request never consumes a micro-batch slot."""


# --------------------------------------------------------------------------
# stats
# --------------------------------------------------------------------------

class ServerStats:
    """Per-request latency + micro-batch shape accounting (thread-safe).

    Latencies are kept in a bounded sliding window (``window`` most recent
    requests) so a long-lived server never grows without bound; counters
    (requests, batches, occupancy/bucket histograms) are exact totals."""

    def __init__(self, window: int = 100_000):
        self._lock = threading.Lock()
        # primary latencies: from each request's scheduled ARRIVAL time
        # (t_arrival; == the submit call unless the submitter passes the
        # scheduled offset) — the coordinated-omission-free measurement
        self._latencies: collections.deque[float] = collections.deque(
            maxlen=window)
        # submit-call-relative twins: the pre-fix optimistic measurement,
        # kept so replays can assert the two diverge under submit-side stall
        self._submit_lat: collections.deque[float] = collections.deque(
            maxlen=window)
        self._occupancy = collections.Counter()   # n_real per micro-batch
        self._buckets = collections.Counter()     # (batch_bucket, tq_bucket)
        self._n_requests = 0
        self._n_batches = 0
        self._n_rejected = 0
        self._n_expired = 0
        self._t_first: float | None = None
        self._t_last: float | None = None

    def record_batch(self, latencies_s, submit_latencies_s, n_real: int,
                     batch_bucket: int, tq_bucket: int, t_done: float) -> None:
        with self._lock:
            self._latencies.extend(latencies_s)
            self._submit_lat.extend(submit_latencies_s)
            self._n_requests += len(latencies_s)
            self._occupancy[n_real] += 1
            self._buckets[(batch_bucket, tq_bucket)] += 1
            self._n_batches += 1
            if self._t_first is None:
                self._t_first = t_done
            self._t_last = t_done

    def record_rejected(self, n: int = 1) -> None:
        with self._lock:
            self._n_rejected += n

    def record_expired(self, n: int = 1) -> None:
        with self._lock:
            self._n_expired += n

    @property
    def n_rejected(self) -> int:
        with self._lock:
            return self._n_rejected

    @property
    def n_expired(self) -> int:
        with self._lock:
            return self._n_expired

    @property
    def n_requests(self) -> int:
        with self._lock:
            return self._n_requests

    @property
    def n_batches(self) -> int:
        with self._lock:
            return self._n_batches

    def percentiles(self, qs=(50, 95, 99)) -> dict[str, float]:
        """Latency percentiles in milliseconds, ``{"p50": …, …}``."""
        with self._lock:
            lat = np.fromiter(self._latencies, np.float64)
        if lat.size == 0:
            return {f"p{q}": float("nan") for q in qs}
        return {f"p{q}": float(np.percentile(lat, q) * 1e3) for q in qs}

    def summary(self) -> dict:
        """One JSON-able dict: percentiles, QPS over the serving window,
        occupancy/bucket histograms, reject/expiry counters.  ``p*_ms`` are
        measured from scheduled arrival; ``submit_p*_ms`` from the (possibly
        delayed) submit call — under open-loop backlog only the former is
        honest (coordinated omission)."""
        pct = self.percentiles()
        with self._lock:
            n = self._n_requests
            span = ((self._t_last - self._t_first)
                    if (self._t_first is not None and self._n_batches > 1)
                    else 0.0)
            occ = dict(sorted(self._occupancy.items()))
            buckets = {f"{b}x{t}": c
                       for (b, t), c in sorted(self._buckets.items())}
            n_batches = self._n_batches
            mean_ms = (float(np.mean(np.fromiter(self._latencies,
                                                 np.float64)) * 1e3)
                       if self._latencies else float("nan"))
            sub = np.fromiter(self._submit_lat, np.float64)
            sub_pct = ({f"submit_p{q}_ms": float(np.percentile(sub, q) * 1e3)
                        for q in (50, 95, 99)} if sub.size else
                       {f"submit_p{q}_ms": float("nan") for q in (50, 95, 99)})
            n_rejected, n_expired = self._n_rejected, self._n_expired
        return {
            "n_requests": n,
            "n_batches": n_batches,
            "n_rejected": n_rejected,
            "n_expired": n_expired,
            "mean_ms": mean_ms,
            **{f"{k}_ms": v for k, v in pct.items()},
            **sub_pct,
            "qps": n / span if span > 0 else float("nan"),
            "mean_occupancy": n / max(n_batches, 1),
            "occupancy_hist": occ,
            "bucket_hist": buckets,
        }


# --------------------------------------------------------------------------
# queue ops
# --------------------------------------------------------------------------

def _payload(x):
    """A mutation's docs as given when they are a tensor (on any device: the
    facade moves them once), else as a numpy array."""
    return x if isinstance(x, torch.Tensor) else np.asarray(x)


def _ids(x) -> np.ndarray:
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x, np.int32)


@dataclasses.dataclass
class _Search:
    rid: int
    q: np.ndarray            # (Tq, d) fp32
    qm: np.ndarray           # (Tq,) bool
    params: object           # resolved SearchParams (hashable group key)
    future: Future
    t_submit: float          # when submit() was called
    t_arrival: float         # scheduled arrival (== t_submit unless passed)
    deadline: float | None   # absolute perf_counter bound, or None


@dataclasses.dataclass
class _Mutation:
    """A FIFO-barrier corpus mutation: ``add``, ``delete``, ``update``, or a
    generic ``apply``.  All share the same queue semantics — searches
    submitted earlier run against the old snapshot, the worker applies the
    mutation atomically between micro-batches, later searches see the new
    corpus."""
    kind: str                            # "add" | "delete" | "update" | "apply"
    future: Future
    doc_tokens: np.ndarray | torch.Tensor | None = None
    doc_mask: np.ndarray | torch.Tensor | None = None
    doc_ids: np.ndarray | None = None
    seed: int = 0
    fn: Any = None                       # "apply": fn(retriever) -> result


# --------------------------------------------------------------------------
# the server
# --------------------------------------------------------------------------

class RetrieverServer:
    """Online micro-batching server over a retriever (see module docstring).

    Use as a context manager, or ``start()``/``stop()`` explicitly::

        with RetrieverServer(r, ladder=BucketLadder((32, 64), 8)) as srv:
            fut = srv.submit(q_tokens)            # (Tq, d) ragged
            scores, ids = fut.result(timeout=30)
            srv.add(new_tokens, new_mask).result(timeout=60)
    """

    def __init__(self, retriever, *, ladder: BucketLadder | None = None,
                 max_wait_us: int = 2000, default_params=None,
                 max_queue_depth: int | None = None):
        self._retriever = retriever
        self._ladder = ladder or BucketLadder()
        self._max_wait_s = max_wait_us / 1e6
        self._default_params = default_params
        self._max_queue_depth = max_queue_depth
        self._queue: collections.deque = collections.deque()
        self._cond = threading.Condition()
        self._stats = ServerStats()
        self._rid = 0
        self._stopping = False
        self._drain = True
        self._paused = False
        self._progress_t = time.perf_counter()
        self._worker: threading.Thread | None = None

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "RetrieverServer":
        if self._worker is not None:
            raise RuntimeError("server already started")
        self._stopping = False
        self._worker = threading.Thread(target=self._serve_loop,
                                        name="lemur-retriever-server",
                                        daemon=True)
        self._worker.start()
        return self

    def stop(self, *, drain: bool = True, timeout: float | None = None) -> bool:
        """Stop the worker.  ``drain=True`` (default) serves every queued
        request first; ``drain=False`` cancels pending requests.  Returns
        ``True`` once the worker has exited; ``False`` if ``timeout``
        expired with the worker still draining — the server stays stopped
        (submits raise) and ``start()`` keeps refusing until a later
        ``stop()`` observes the exit, so a second worker can never race
        the first on the queue."""
        with self._cond:
            self._stopping = True
            self._drain = drain
            self._cond.notify_all()
        if self._worker is not None:
            self._worker.join(timeout)
            if self._worker.is_alive():
                return False
            self._worker = None
        return True

    def __enter__(self) -> "RetrieverServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop(drain=exc == (None, None, None))

    # -- introspection ------------------------------------------------------

    @property
    def retriever(self):
        return self._retriever

    @property
    def ladder(self) -> BucketLadder:
        return self._ladder

    @property
    def stats(self) -> ServerStats:
        return self._stats

    def reset_stats(self) -> ServerStats:
        """Swap in a fresh :class:`ServerStats` window (e.g. between replay
        phases) and return the old one.  Trace counts are NOT reset — they
        belong to the retriever's compile accounting, not the serving window."""
        old, self._stats = self._stats, ServerStats()
        return old

    def pending(self) -> int:
        with self._cond:
            return len(self._queue)

    @property
    def progress_time(self) -> float:
        """perf_counter of the worker's last sign of life: a batch or add
        completing, or the queue observed empty.  Enqueues also stamp it, so
        a stall window always starts at the oldest unserved work — the fleet
        router's health monitor quarantines a replica whose queue is
        non-empty but whose ``progress_time`` is stale."""
        return self._progress_t

    def pause(self) -> None:
        """Wedge the worker at its loop top WITHOUT losing queue state — a
        chaos/test hook simulating a replica that stops draining.  Queued
        requests stay queued; ``submit()`` keeps accepting."""
        with self._cond:
            self._paused = True
            self._cond.notify_all()

    def resume(self) -> None:
        with self._cond:
            self._paused = False
            self._cond.notify_all()

    def trace_count(self, params=None) -> int:
        return self._retriever.trace_count(params)

    def trace_shapes(self):
        return self._retriever.trace_shapes()

    def compile_bound(self, n_param_sets: int = 1) -> int:
        return self._ladder.compile_bound(n_param_sets)

    # -- client surface -----------------------------------------------------

    def submit(self, q_tokens, q_mask=None, params=None, *,
               deadline_s: float | None = None,
               deadline_at: float | None = None,
               t_arrival: float | None = None) -> Future:
        """Enqueue one ragged query — ``q_tokens: (Tq, d)`` (a leading
        singleton batch axis is accepted and squeezed).  Returns a future
        resolving to ``(scores (k,), ids (k,))`` with ``future.request_id``
        set; FIFO submission order is preserved relative to ``add()``.

        ``t_arrival`` is the request's scheduled arrival (perf_counter
        offset) — open-loop replays pass it so latency is measured from the
        schedule, not the (possibly delayed) submit call.  ``deadline_s`` is
        relative to the arrival; ``deadline_at`` (absolute) takes precedence
        and lets the fleet router preserve a deadline across re-dispatch.
        Raises :class:`Overloaded` when ``max_queue_depth`` is hit — the
        rejected request never consumes a micro-batch slot."""
        q = np.asarray(q_tokens, np.float32)
        if q.ndim == 3 and q.shape[0] == 1:
            q = q[0]
            if q_mask is not None:
                q_mask = np.asarray(q_mask)[0]
        if q.ndim != 2:
            raise ValueError(f"submit takes one (Tq, d) query, got {q.shape}")
        qm = (np.ones(q.shape[0], bool) if q_mask is None
              else np.asarray(q_mask, bool))
        if qm.shape != (q.shape[0],):
            raise ValueError(f"mask {qm.shape} does not match query {q.shape}")
        resolved = self._retriever.resolve(
            params if params is not None else self._default_params)
        now = time.perf_counter()
        arrival = now if t_arrival is None else float(t_arrival)
        deadline = (float(deadline_at) if deadline_at is not None
                    else arrival + deadline_s if deadline_s is not None
                    else None)
        fut: Future = Future()
        with self._cond:
            if self._stopping:
                raise RuntimeError("server is stopped")
            if (self._max_queue_depth is not None
                    and len(self._queue) >= self._max_queue_depth):
                self._stats.record_rejected()
                raise Overloaded(
                    f"queue depth {len(self._queue)} at bound "
                    f"{self._max_queue_depth}")
            self._rid += 1
            fut.request_id = self._rid
            self._queue.append(_Search(self._rid, q, qm, resolved, fut,
                                       now, arrival, deadline))
            self._progress_t = max(self._progress_t, now)
            self._cond.notify_all()
        return fut

    def search(self, q_tokens, q_mask=None, params=None,
               timeout: float | None = 60.0, **submit_kw):
        """Blocking convenience wrapper: ``submit(...).result(timeout)``."""
        return self.submit(q_tokens, q_mask, params,
                           **submit_kw).result(timeout)

    def add(self, doc_tokens, doc_mask, *, seed: int = 0) -> Future:
        """Enqueue streaming growth.  Acts as a FIFO barrier: earlier
        searches run against the old snapshot, the swap happens atomically
        between micro-batches, later searches see the new docs.  The future
        resolves to the grown corpus size ``m`` (and carries
        ``added_ids`` + ``snapshot_version``)."""
        return self._enqueue_mutation(_Mutation(
            "add", Future(), doc_tokens=_payload(doc_tokens),
            doc_mask=_payload(doc_mask), seed=seed))

    def delete(self, doc_ids) -> Future:
        """Enqueue a tombstone delete (same FIFO-barrier semantics as
        :meth:`add`).  The future resolves to the surviving live-doc count
        ``n_alive``; unknown/already-deleted ids resolve it with the
        retriever's ``ValueError``."""
        return self._enqueue_mutation(_Mutation(
            "delete", Future(), doc_ids=_ids(doc_ids)))

    def update(self, doc_ids, doc_tokens, doc_mask, *, seed: int = 0) -> Future:
        """Enqueue a replace (delete+add under ONE snapshot version — the
        facade's ``update``).  The future resolves to the NEW external ids
        of the replacement docs."""
        return self._enqueue_mutation(_Mutation(
            "update", Future(), doc_tokens=_payload(doc_tokens),
            doc_mask=_payload(doc_mask), doc_ids=_ids(doc_ids), seed=seed))

    def apply(self, fn) -> Future:
        """Enqueue a generic retriever transform behind the same FIFO
        barrier as :meth:`add`: ``fn(retriever)`` runs atomically between
        micro-batches on the worker thread — earlier searches resolve
        against the old snapshot, later ones see whatever ``fn`` installed.
        This is the warm-swap entry point (``lifecycle`` passes
        ``lambda r: r.install_refresh(result)``); if ``fn`` raises (e.g.
        ``CorruptIndexError`` from install validation) the retriever is
        whatever ``fn`` left behind — install validation guarantees that is
        the untouched last-good snapshot — and the future carries the
        exception."""
        return self._enqueue_mutation(_Mutation("apply", Future(), fn=fn))

    def _enqueue_mutation(self, op: _Mutation) -> Future:
        with self._cond:
            if self._stopping:
                raise RuntimeError("server is stopped")
            self._queue.append(op)
            self._cond.notify_all()
        return op.future

    # -- worker -------------------------------------------------------------

    def _serve_loop(self) -> None:
        # the finally clause is the no-leak guarantee: HOWEVER the worker
        # exits (drain, cancel, or an unexpected crash), every future still
        # in the queue resolves — cancelled on a non-drain stop, failed with
        # the worker's exception on a crash — so a caller blocked on
        # ``.result(timeout=...)`` always observes a typed outcome, never a
        # hang until timeout
        try:
            self._serve_loop_inner()
        except BaseException as e:  # noqa: BLE001 — resolve then re-raise
            with self._cond:
                pending = list(self._queue)
                self._queue.clear()
            for op in pending:
                if not op.future.done():
                    op.future.set_exception(
                        RuntimeError(f"server worker died: {e!r}"))
            raise

    def _serve_loop_inner(self) -> None:
        while True:
            batch: list[_Search] = []
            mut_op: _Mutation | None = None
            expired: list[_Search] = []
            with self._cond:
                # wedge while paused (unless a non-drain stop must cancel),
                # or while idle; an idle queue is a sign of life
                while ((self._paused
                        and not (self._stopping and not self._drain))
                       or (not self._queue and not self._stopping)):
                    if not self._queue and not self._paused:
                        self._progress_t = time.perf_counter()
                    self._cond.wait(timeout=0.05 if self._paused else None)
                if not self._queue and self._stopping:
                    return
                if self._stopping and not self._drain:
                    # cancel-don't-leak: every queued future (searches AND
                    # mutation barriers) resolves with CancelledError to its
                    # waiters — Future.cancel() on a pending future always
                    # succeeds here because the worker (sole executor) is
                    # the one abandoning it
                    for op in self._queue:
                        op.future.cancel()
                    self._queue.clear()
                    return
                # deadline sweep: pull expired searches out of the queue now,
                # resolve them typed once the lock is dropped
                now = time.perf_counter()
                expired = [op for op in self._queue
                           if isinstance(op, _Search)
                           and op.deadline is not None and now > op.deadline]
                if expired:
                    gone = set(map(id, expired))
                    kept = [op for op in self._queue if id(op) not in gone]
                    self._queue.clear()
                    self._queue.extend(kept)
                if self._queue:
                    if self._stopping and self._drain:
                        # drain ordering guarantee: pending mutation barriers
                        # are flushed BEFORE the remaining searches are
                        # served, so drained results reflect the final
                        # snapshot version
                        muts = [op for op in self._queue
                                if isinstance(op, _Mutation)]
                        if muts and not isinstance(self._queue[0], _Mutation):
                            rest = [op for op in self._queue
                                    if not isinstance(op, _Mutation)]
                            self._queue.clear()
                            self._queue.extend(muts + rest)
                    head = self._queue[0]
                    if isinstance(head, _Mutation):
                        mut_op = self._queue.popleft()
                    else:
                        batch = self._collect_batch(head)
            if expired:
                self._resolve_expired(expired)
            if mut_op is not None:
                self._apply_mutation(mut_op)
            elif batch:
                self._run_batch(batch)

    def _resolve_expired(self, expired: list[_Search]) -> None:
        """Resolve swept requests with a typed :class:`DeadlineExceeded` —
        never a silent drop.  Called without the lock held."""
        now = time.perf_counter()
        self._stats.record_expired(len(expired))
        for op in expired:
            if not op.future.cancelled():
                op.future.set_exception(
                    DeadlineExceeded(op.rid, now - op.t_arrival))

    def _collect_batch(self, head: _Search) -> list[_Search]:
        """Coalesce queue entries sharing head's (Tq bucket, params) group,
        up to ``max_batch`` / ``max_wait_us``.  Called with the lock held;
        removes the collected entries from the queue."""
        key = (self._ladder.tq_bucket(head.q.shape[0]), head.params)
        deadline = head.t_submit + self._max_wait_s

        def matching() -> list[_Search]:
            out = []
            now = time.perf_counter()
            for op in self._queue:
                if isinstance(op, _Mutation):
                    break  # mutations are barriers: never batch across one
                if op.deadline is not None and now > op.deadline:
                    continue  # expired: swept at loop top, never takes a slot
                if (self._ladder.tq_bucket(op.q.shape[0]), op.params) == key:
                    out.append(op)
                    if len(out) == self._ladder.max_batch:
                        break
            return out

        batch = matching()
        while (len(batch) < self._ladder.max_batch and not self._stopping
               and not self._paused):
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            self._cond.wait(timeout=remaining)
            batch = matching()
        got = set(id(op) for op in batch)
        kept = [op for op in self._queue if id(op) not in got]
        self._queue.clear()
        self._queue.extend(kept)
        return batch

    def _run_batch(self, batch: list[_Search]) -> None:
        # last-chance expiry filter: a request whose deadline passed during
        # collection resolves typed and never occupies a micro-batch slot
        now = time.perf_counter()
        stale = [op for op in batch
                 if op.deadline is not None and now > op.deadline]
        if stale:
            self._resolve_expired(stale)
            gone = set(map(id, stale))
            batch = [op for op in batch if id(op) not in gone]
            if not batch:
                return
        # a batch entering execution is progress too: without this stamp a
        # long batch (e.g. a kernel's first launch, which builds it) looks
        # like a stall
        self._progress_t = time.perf_counter()
        try:
            q, qm, n_real = self._ladder.pad_batch(
                [op.q for op in batch], [op.qm for op in batch])
            scores, ids = self._retriever.search(q, qm, batch[0].params)
            # the real rows only, one copy each; .cpu() waits for the device
            scores = scores[:n_real].cpu().numpy()
            ids = ids[:n_real].cpu().numpy()
        except Exception as e:  # noqa: BLE001 — the request owns the error
            for op in batch:
                op.future.set_exception(e)
            return
        t_done = time.perf_counter()
        self._progress_t = t_done
        # record stats BEFORE resolving any future: a client unblocked by the
        # last result may immediately read/reset the stats window, and this
        # batch must already be in it
        self._stats.record_batch([t_done - op.t_arrival for op in batch],
                                 [t_done - op.t_submit for op in batch],
                                 n_real, q.shape[0], q.shape[1], t_done)
        version = getattr(self._retriever, "version", None)
        for i, op in enumerate(batch):
            # which corpus snapshot answered (facade.version, bumped per add)
            op.future.snapshot_version = version
            op.future.set_result((scores[i], ids[i]))

    def _apply_mutation(self, op: _Mutation) -> None:
        self._progress_t = time.perf_counter()
        r = self._retriever
        try:
            if op.kind == "add":
                r.add(op.doc_tokens, op.doc_mask, seed=op.seed)
                result = r.m
                op.future.added_ids = np.asarray(
                    getattr(r, "last_added_ids", np.empty(0, np.int32)))
            elif op.kind == "delete":
                r.delete(op.doc_ids)
                result = r.n_alive
            elif op.kind == "apply":
                result = op.fn(r)
            else:  # update
                result = np.asarray(r.update(op.doc_ids, op.doc_tokens,
                                             op.doc_mask, seed=op.seed))
        except Exception as e:  # noqa: BLE001
            op.future.set_exception(e)
            return
        self._progress_t = time.perf_counter()
        # which snapshot this barrier produced — the fleet write barrier
        # asserts every replica lands on the same version — and what the
        # mutation logically wrote (the add-amortization bench reads it off
        # the future so churn needn't serialize on the worker)
        op.future.snapshot_version = getattr(r, "version", None)
        op.future.mutation_bytes = getattr(r, "last_mutation_bytes", 0)
        op.future.set_result(result)


__all__ = ["RetrieverServer", "ServerStats", "DeadlineExceeded", "Overloaded"]
