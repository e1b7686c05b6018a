"""Typed lifecycle health events — the failure taxonomy the runbook keys on
(twin of ``repro/lifecycle/events.py``).

Every state transition of the learned-index lifecycle (drift detection,
background refresh, warm swap) is recorded as one frozen dataclass below,
never a log line alone: chaos tests and the lifecycle bench assert on the
TYPES (a crashed refresh must leave a ``RefreshFailed``, a rejected rebuilt
index a ``SwapAborted``) so "degraded gracefully to the last-good snapshot"
is machine-checkable, not an operator's impression.

Events carry plain JSON-able payloads (no live index state) so an event log
can be shipped off-box verbatim.  ``EventLog`` is the bounded ring buffer
every lifecycle component appends to — same no-unbounded-growth contract as
``ServerStats``' latency windows, with a dropped counter so truncation is
observable.
"""
from __future__ import annotations

import collections
import dataclasses
import threading


@dataclasses.dataclass(frozen=True)
class LifecycleEvent:
    """Base: ``t`` is a perf_counter-domain timestamp (monotonic, comparable
    with server/router event times)."""
    t: float

    @property
    def kind(self) -> str:
        return type(self).__name__


@dataclasses.dataclass(frozen=True)
class DriftDetected(LifecycleEvent):
    """The monitor's staleness signal crossed its trigger threshold."""
    coverage: float          # reservoir first-stage self-retrieval rate
    baseline_coverage: float
    fidelity: float          # latent score fidelity on recent mutations
    baseline_fidelity: float
    skew: float              # excess centroid-assignment TV vs sampling null
    n_reservoir: int
    reason: str


@dataclasses.dataclass(frozen=True)
class RefreshStarted(LifecycleEvent):
    m0: int                  # slot high-water mark the rebuild snapshotted
    version: int             # snapshot version the rebuild started from
    reason: str


@dataclasses.dataclass(frozen=True)
class RefreshFailed(LifecycleEvent):
    """The background rebuild died (crash, injected fault, ...).  Serving
    was never touched — the last-good snapshot keeps answering."""
    phase: str               # which rebuild phase raised ("solver"/"refit"/...)
    error: str


@dataclasses.dataclass(frozen=True)
class RefreshCompleted(LifecycleEvent):
    m0: int
    wall_s: float


@dataclasses.dataclass(frozen=True)
class SwapCompleted(LifecycleEvent):
    """The rebuilt index is installed fleet-wide behind the FIFO barrier."""
    version: int             # snapshot version AFTER the swap
    m: int
    caught_up: int           # docs added during the rebuild, re-fit at install


@dataclasses.dataclass(frozen=True)
class SwapAborted(LifecycleEvent):
    """Install-time validation rejected the rebuilt index (corrupt W, bad
    candidate ids, ...) — the last-good snapshot stays installed on every
    replica; nothing is torn."""
    error: str


class EventLog:
    """Thread-safe bounded event ring (newest kept; drops counted)."""

    def __init__(self, maxlen: int = 1024):
        self._lock = threading.Lock()
        self._events: collections.deque[LifecycleEvent] = collections.deque(
            maxlen=maxlen)
        self._dropped = 0

    def append(self, ev: LifecycleEvent) -> None:
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self._dropped += 1
            self._events.append(ev)

    def events(self, kind: type | None = None) -> list[LifecycleEvent]:
        with self._lock:
            evs = list(self._events)
        if kind is not None:
            evs = [e for e in evs if isinstance(e, kind)]
        return evs

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)


__all__ = [
    "DriftDetected",
    "EventLog",
    "LifecycleEvent",
    "RefreshCompleted",
    "RefreshFailed",
    "RefreshStarted",
    "SwapAborted",
    "SwapCompleted",
]
