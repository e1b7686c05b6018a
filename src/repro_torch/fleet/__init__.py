"""Fleet serving of the port: a replicated router over the online serving
runtime (twin of ``repro/fleet``).

The production operating point above :mod:`repro_torch.serving`'s
single-worker ``RetrieverServer``:

* :mod:`repro_torch.fleet.replica` — replica factory (``retriever.clone()``
  per replica: shared index tensors + OLS solver, copied on a replica's
  first write, private compile accounting) and ladder×rung warmup.
* :mod:`repro_torch.fleet.router` — :class:`Router`: least-outstanding
  dispatch over N replicas, fleet admission control (typed
  :class:`Overloaded`), per-request deadlines (typed
  :class:`DeadlineExceeded`), health monitoring with quarantine +
  exactly-once re-dispatch, and the snapshot-consistent write barrier.
* :mod:`repro_torch.fleet.slo` — :class:`SLOController`: windowed-p99
  breach → walk ``SearchParams`` down the pre-warmed nprobe/k' rung ladder,
  hysteretic recovery; :func:`build_rungs` builds the ladder.
"""
from repro_torch.fleet.replica import clone_replicas, warm_replicas
from repro_torch.fleet.router import FleetStats, Router
from repro_torch.fleet.slo import RungTransition, SLOController, build_rungs
from repro_torch.serving.server import DeadlineExceeded, Overloaded

__all__ = [
    "DeadlineExceeded",
    "FleetStats",
    "Overloaded",
    "Router",
    "RungTransition",
    "SLOController",
    "build_rungs",
    "clone_replicas",
    "warm_replicas",
]
