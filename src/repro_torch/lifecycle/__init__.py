"""Learned-index lifecycle of the port: drift detection, background
refresh, warm swap (twin of ``repro/lifecycle``).

LEMUR's first stage is a *trained* reduction — a mutable corpus silently
degrades it.  This package closes the loop:

    from repro_torch.lifecycle import DriftMonitor, LifecycleManager

    with RetrieverServer(r, ladder=ladder) as srv:
        with LifecycleManager(srv, seed=0) as mgr:   # monitors, refreshes,
            ...                                      # and warm-swaps alone

See :mod:`repro_torch.lifecycle.manager` for the event taxonomy and
``tests/test_torch_lifecycle_chaos.py`` for the fault-injection proof.
"""
from repro_torch.lifecycle.chaos import ChaosError, ChaosInjector
from repro_torch.lifecycle.drift import DriftMonitor, DriftReport
from repro_torch.lifecycle.events import (
    DriftDetected,
    EventLog,
    LifecycleEvent,
    RefreshCompleted,
    RefreshFailed,
    RefreshStarted,
    SwapAborted,
    SwapCompleted,
)
from repro_torch.lifecycle.manager import LifecycleManager
from repro_torch.lifecycle.refresh import RefreshResult, Refresher, build_refresh

__all__ = [
    "ChaosError",
    "ChaosInjector",
    "DriftDetected",
    "DriftMonitor",
    "DriftReport",
    "EventLog",
    "LifecycleEvent",
    "LifecycleManager",
    "RefreshCompleted",
    "RefreshFailed",
    "RefreshResult",
    "RefreshStarted",
    "Refresher",
    "SwapAborted",
    "SwapCompleted",
    "build_refresh",
]
