"""LifecycleManager: the drift -> refresh -> warm-swap control loop (twin of
``repro/lifecycle/manager.py``).

One daemon thread owns the whole closed loop so serving never pays for it:

* poll the :class:`~repro_torch.lifecycle.drift.DriftMonitor` (cheap; only
  measures once enough recent mutations accumulated);
* on a triggered report, run :func:`~repro_torch.lifecycle.refresh.build_refresh`
  on THIS thread against a snapshot taken under the facade's lock (the
  worker's next write to each tensor copies it first) — the server worker
  keeps batching searches and applying mutations the whole time;
* install the result through the target's ``apply()`` FIFO barrier
  (``RetrieverServer.apply`` locally, ``Router.apply`` fleet-wide): earlier
  searches resolve against the old snapshot, later ones see the refit index,
  zero requests dropped — the same guarantee add/delete already have.

Every transition lands in a bounded :class:`~repro_torch.lifecycle.events.EventLog`
as a typed event; failures degrade, never propagate:

====================  =====================================================
event                 meaning / operator action
====================  =====================================================
``DriftDetected``     staleness signal crossed threshold; refresh imminent
``RefreshStarted``    background rebuild running; serving unaffected
``RefreshFailed``     rebuild crashed (phase recorded); last-good serving —
                      retried after ``cooldown_s``
``RefreshCompleted``  rebuilt index ready; swap being installed
``SwapCompleted``     fleet serving the refit index at the new version
``SwapAborted``       install validation rejected the rebuild
                      (``CorruptIndexError``) or the barrier could not
                      complete; last-good serving everywhere
====================  =====================================================
"""
from __future__ import annotations

import threading
import time

from repro_torch.lifecycle.drift import DriftMonitor
from repro_torch.lifecycle.events import (DriftDetected, EventLog, RefreshCompleted,
                                          RefreshFailed, RefreshStarted, SwapAborted,
                                          SwapCompleted)
from repro_torch.lifecycle.refresh import RefreshResult, build_refresh


def _target_retriever(target):
    """The retriever to monitor/snapshot: a server's, or the first healthy
    replica's for a fleet router (all replicas are bit-identical between
    barriers, so any healthy one represents the fleet snapshot)."""
    first = getattr(target, "_first_healthy_server", None)
    if first is not None:
        return first().retriever
    return target.retriever


class LifecycleManager:
    """Drives drift detection, background refresh, and warm swap against a
    ``RetrieverServer`` or fleet ``Router`` (anything with ``apply(fn)``).

    ``start()`` launches the polling thread (``auto=True``); with
    ``auto=False`` nothing runs until :meth:`refresh_now` — the manual mode
    benchmarks and chaos tests drive.  Use as a context manager.
    """

    def __init__(self, target, *, monitor: DriftMonitor | None = None,
                 seed: int = 0, chaos=None,
                 poll_interval_s: float = 0.05,
                 cooldown_s: float = 1.0,
                 min_reservoir: int = 16,
                 swap_timeout_s: float = 300.0,
                 event_log_size: int = 1024,
                 on_event=None):
        self._target = target
        self._monitor = monitor or DriftMonitor(_target_retriever(target),
                                                seed=seed)
        self._seed = seed
        self._chaos = chaos
        self._poll_s = float(poll_interval_s)
        self._cooldown_s = float(cooldown_s)
        self._min_reservoir = int(min_reservoir)
        self._swap_timeout_s = float(swap_timeout_s)
        self._log = EventLog(event_log_size)
        self._on_event = on_event
        self._stop_evt = threading.Event()
        self._thread: threading.Thread | None = None
        self._refresh_lock = threading.Lock()   # one refresh at a time
        self._last_attempt_t = -float("inf")
        self.last_refresh_result: RefreshResult | None = None
        self.n_refreshes = 0
        self.n_swaps = 0

    # -- lifecycle ----------------------------------------------------------

    @property
    def monitor(self) -> DriftMonitor:
        return self._monitor

    def start(self, *, auto: bool = True) -> "LifecycleManager":
        self._monitor.attach()
        if auto:
            self._stop_evt.clear()
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="lemur-lifecycle")
            self._thread.start()
        return self

    def stop(self, timeout: float | None = 30.0) -> None:
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        self._monitor.detach()

    def __enter__(self) -> "LifecycleManager":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def events(self, kind: type | None = None):
        return self._log.events(kind)

    def _emit(self, ev) -> None:
        self._log.append(ev)
        if self._on_event is not None:
            try:
                self._on_event(ev)
            except Exception:
                pass

    # -- control loop -------------------------------------------------------

    def _loop(self) -> None:
        while not self._stop_evt.wait(self._poll_s):
            try:
                self.poll_once()
            except Exception:
                # the loop must never die silently mid-deployment; failures
                # are already recorded as typed events by refresh_now
                pass

    def poll_once(self) -> bool:
        """One drift check; kicks a refresh when triggered (respecting the
        cooldown).  Returns True only when a triggered refresh completed
        its swap — a crashed rebuild or aborted install returns False (with
        the typed event recorded) so callers can observe the failure."""
        now = time.perf_counter()
        if now - self._last_attempt_t < self._cooldown_s:
            return False
        report = self._monitor.maybe_report(self._min_reservoir)
        if report is None or not report.triggered:
            return False
        self._emit(DriftDetected(t=now, coverage=report.coverage,
                                 baseline_coverage=report.baseline_coverage,
                                 fidelity=report.fidelity,
                                 baseline_fidelity=report.baseline_fidelity,
                                 skew=report.skew,
                                 n_reservoir=report.n_reservoir,
                                 reason=report.reason))
        return self.refresh_now(reason=report.reason)

    def refresh_now(self, reason: str = "manual") -> bool:
        """Run the full rebuild + warm swap once.  Returns True on a
        completed swap; every failure path leaves a typed event and the
        last-good snapshot serving."""
        with self._refresh_lock:
            self._last_attempt_t = time.perf_counter()
            retriever = _target_retriever(self._target)
            self._emit(RefreshStarted(t=time.perf_counter(),
                                      m0=retriever.m,
                                      version=retriever.version,
                                      reason=reason))
            try:
                result = build_refresh(retriever, seed=self._seed,
                                       chaos=self._chaos)
            except Exception as e:
                self._emit(RefreshFailed(
                    t=time.perf_counter(),
                    phase=getattr(e, "lifecycle_phase", "unknown"),
                    error=repr(e)))
                return False
            self.last_refresh_result = result
            self.n_refreshes += 1
            self._emit(RefreshCompleted(t=time.perf_counter(), m0=result.m0,
                                        wall_s=result.wall_s))
            return self._install(result)

    def _install(self, result: RefreshResult) -> bool:
        try:
            fut = self._target.apply(lambda r: r.install_refresh(result))
            fut.result(timeout=self._swap_timeout_s)
        except Exception as e:
            # CorruptIndexError (validation), barrier failure, timeout —
            # in every case install validation ran before any mutation, so
            # each replica still serves its last-good snapshot
            self._emit(SwapAborted(t=time.perf_counter(), error=repr(e)))
            return False
        retriever = _target_retriever(self._target)
        self._emit(SwapCompleted(
            t=time.perf_counter(),
            version=getattr(fut, "snapshot_version", retriever.version),
            m=retriever.m,
            caught_up=getattr(retriever, "_last_refresh_caught_up", 0)))
        self.n_swaps += 1
        # recalibrate against the NEW fit: the next drift report measures
        # post-swap staleness, not the drift the swap just repaired
        self._monitor.reset()
        return True


__all__ = ["LifecycleManager"]
