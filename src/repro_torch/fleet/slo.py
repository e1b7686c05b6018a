"""SLO-adaptive search: walk ``SearchParams`` down a pre-warmed ladder (twin
of ``repro/fleet/slo.py``).

Under overload, a fixed operating point has only one failure mode —
unbounded latency (or rejects).  LEMUR's first stage exposes two graceful
quality/latency knobs that do NOT change the bucketed shape ladder:
``nprobe`` (IVF/token-pruning probe count) and ``k_prime`` (rerank
candidate budget).  :func:`build_rungs` pre-resolves a small ladder of
``SearchParams`` — rung 0 is the configured operating point, each further
rung halves ``nprobe`` (when the backend has one) and ``k_prime`` — and
:class:`SLOController` walks down one rung when the windowed p99 breaches
the target, recovering hysteretically (windowed p99 must clear
``recover_frac * target`` for ``hold`` consecutive evaluations) so the
controller never flaps at the boundary.

Every rung is a distinct resolved ``SearchParams``, so a fleet serving the
whole ladder counts ``BucketLadder.compile_bound(n_rungs)`` served shapes —
the rungs must be warmed up-front (``fleet.replica.warm_replicas``) so a
downshift never pays a first launch in the latency path.

Transitions are recorded as :class:`RungTransition` rows (and logged), so
benchmarks and CI can assert the controller engaged exactly when the SLO
was breached.
"""
from __future__ import annotations

import collections
import dataclasses
import logging
import threading

import numpy as np

from repro_torch.retriever.params import SearchParams

log = logging.getLogger("repro_torch.fleet.slo")


@dataclasses.dataclass(frozen=True)
class RungTransition:
    """One controller step, recorded at the moment it happened."""
    t: float                 # perf_counter-domain timestamp of the decision
    from_rung: int
    to_rung: int
    p99_ms: float            # the windowed p99 that triggered the step
    target_ms: float

    @property
    def direction(self) -> str:
        return "down" if self.to_rung > self.from_rung else "up"


def build_rungs(retriever, params: SearchParams | None = None,
                n_rungs: int = 3, *, nprobe_floor: int = 1,
                k_prime_floor: int | None = None) -> list[SearchParams]:
    """Pre-resolve the degradation ladder for ``retriever``.

    Rung 0 is ``params`` resolved against the build config; rung ``i+1``
    halves the backend ``nprobe`` (when the backend params carry one) and
    ``k_prime``, floored at ``nprobe_floor`` / ``k_prime_floor`` (default:
    ``max(k, 8)`` so the rerank can always fill the top-k).  Rungs that
    stop changing are dropped, so the list can be shorter than
    ``n_rungs`` — every entry is a distinct operating point."""
    base = retriever.resolve(params)
    if k_prime_floor is None:
        k_prime_floor = max(int(base.k), 8)
    rungs = [base]
    cur = base
    for _ in range(n_rungs - 1):
        k_prime = max(int(cur.k_prime) // 2, k_prime_floor, int(base.k))
        bp = cur.backend
        if bp is not None and getattr(bp, "nprobe", None) is not None:
            bp = dataclasses.replace(
                bp, nprobe=max(int(bp.nprobe) // 2, nprobe_floor))
        nxt = retriever.resolve(dataclasses.replace(
            cur, k_prime=k_prime, backend=bp))
        if nxt == cur:
            break  # both knobs hit their floors — ladder is exhausted
        rungs.append(nxt)
        cur = nxt
    return rungs


class SLOController:
    """Hysteretic p99 controller over a pre-warmed rung ladder.

    ``observe(latency_s, t)`` feeds one completed request; every
    ``eval_every`` observations the controller evaluates the windowed p99:

    * **breach** (``p99 > target``): step DOWN one rung (cheaper params).
    * **clear** (``p99 < recover_frac * target`` for ``hold`` consecutive
      evaluations): step UP one rung (back toward full quality).

    The window is cleared on every transition so the next decision is based
    purely on the new rung's latencies — without this, pre-transition
    samples would keep the controller oscillating.  Thread-safe: the router
    calls ``observe`` from replica-completion callbacks and ``params()``
    from the submit path concurrently."""

    def __init__(self, rungs, target_p99_ms: float, *, window: int = 128,
                 min_window: int = 20, eval_every: int = 16,
                 recover_frac: float = 0.7, hold: int = 3):
        if not rungs:
            raise ValueError("need at least one rung")
        self._rungs = list(rungs)
        self.target_p99_ms = float(target_p99_ms)
        self._window: collections.deque[float] = collections.deque(
            maxlen=int(window))
        self._min_window = int(min_window)
        self._eval_every = int(eval_every)
        self._recover_frac = float(recover_frac)
        self._hold = int(hold)
        self._lock = threading.Lock()
        self._rung = 0
        self._since_eval = 0
        self._clear_streak = 0
        self._transitions: list[RungTransition] = []
        self._n_floor_breaches = 0

    # -- read side -----------------------------------------------------------

    @property
    def rungs(self) -> list[SearchParams]:
        return list(self._rungs)

    @property
    def rung(self) -> int:
        with self._lock:
            return self._rung

    def params(self) -> SearchParams:
        """The active rung's resolved SearchParams (what submit dispatches)."""
        with self._lock:
            return self._rungs[self._rung]

    @property
    def transitions(self) -> list[RungTransition]:
        with self._lock:
            return list(self._transitions)

    def windowed_p99_ms(self) -> float:
        with self._lock:
            lat = np.fromiter(self._window, np.float64)
        return float(np.percentile(lat, 99) * 1e3) if lat.size else float("nan")

    @property
    def n_floor_breaches(self) -> int:
        """Evaluations that breached the target while already at the floor
        rung — nothing left to shed; the fleet needs more replicas, not a
        cheaper operating point.  These must NOT clear the window or record
        a transition: the window keeps accumulating so the moment load
        drops, recovery hysteresis starts from real samples instead of an
        empty window."""
        with self._lock:
            return self._n_floor_breaches

    # -- write side ----------------------------------------------------------

    def observe(self, latency_s: float, t: float = 0.0) -> int:
        """Feed one completed (or expired) request latency; returns the
        active rung after any transition this observation triggered."""
        with self._lock:
            self._window.append(float(latency_s))
            self._since_eval += 1
            if (self._since_eval < self._eval_every
                    or len(self._window) < self._min_window):
                return self._rung
            self._since_eval = 0
            p99 = float(np.percentile(
                np.fromiter(self._window, np.float64), 99) * 1e3)
            if p99 > self.target_p99_ms:
                if self._rung < len(self._rungs) - 1:
                    self._step(self._rung + 1, p99, t)
                else:
                    # breach at the floor: no rung left to shed.  Do NOT
                    # clear the window and do NOT record a transition —
                    # recovery hysteresis must judge real samples the
                    # moment load drops (see n_floor_breaches)
                    self._n_floor_breaches += 1
                    self._clear_streak = 0
            elif p99 < self._recover_frac * self.target_p99_ms and self._rung > 0:
                self._clear_streak += 1
                if self._clear_streak >= self._hold:
                    self._step(self._rung - 1, p99, t)
            else:
                self._clear_streak = 0
            return self._rung

    def _step(self, to_rung: int, p99_ms: float, t: float) -> None:
        # lock held by observe()
        if to_rung == self._rung:
            return  # guard: a same-rung "step" would spuriously clear state
        tr = RungTransition(t, self._rung, to_rung, p99_ms, self.target_p99_ms)
        self._transitions.append(tr)
        log.info("SLO %s: rung %d -> %d (windowed p99 %.1fms, target %.1fms)",
                 tr.direction, tr.from_rung, tr.to_rung, p99_ms,
                 self.target_p99_ms)
        self._rung = to_rung
        self._clear_streak = 0
        self._window.clear()  # judge the new rung on its own samples only
        self._since_eval = 0


__all__ = ["RungTransition", "build_rungs", "SLOController"]
