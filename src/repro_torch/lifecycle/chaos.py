"""Fault injection for the index lifecycle (twin of
``repro/lifecycle/chaos.py``).

The chaos harness is deliberately dumb: a registry of named checkpoints
(``refresh:solver``, ``refresh:refit``, ``refresh:recluster``, ...) that the
real code calls ``check()`` at, plus an optional hook that corrupts a
finished :class:`~repro_torch.lifecycle.refresh.RefreshResult` before install.
Tests arm specific failures; production code runs with ``chaos=None`` and
pays one ``is None`` branch per checkpoint.

Scenarios this enables (see ``tests/test_torch_lifecycle_chaos.py``):

* kill the refresh mid-train          -> ``RefreshFailed``, serving untouched
* hand install a corrupted index      -> ``SwapAborted``, last-good kept
* crash a replica mid-swap            -> barrier excuses it, swap completes
"""
from __future__ import annotations

import threading


class ChaosError(RuntimeError):
    """Raised by an armed chaos checkpoint — a stand-in for OOM, preemption,
    or a worker segfault at that point in the lifecycle."""


class ChaosInjector:
    """Arm named failure points; ``check(point)`` raises once per arming.

    ``fail_at(point, times=n)`` makes the next ``n`` ``check(point)`` calls
    raise :class:`ChaosError`.  ``corrupt_results(fn)`` installs a transform
    applied to refresh results via :meth:`maybe_corrupt` (used to hand the
    swap path a poisoned index).  Thread-safe: refreshes run on worker
    threads.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._armed: dict[str, int] = {}
        self._fired: dict[str, int] = {}
        self._corrupt = None

    def fail_at(self, point: str, times: int = 1) -> None:
        with self._lock:
            self._armed[point] = self._armed.get(point, 0) + int(times)

    def check(self, point: str) -> None:
        with self._lock:
            left = self._armed.get(point, 0)
            if left <= 0:
                return
            self._armed[point] = left - 1
            self._fired[point] = self._fired.get(point, 0) + 1
        err = ChaosError(f"chaos: injected failure at {point!r}")
        err.point = point
        raise err

    def corrupt_results(self, fn) -> None:
        """``fn(result) -> result`` applied to every refresh result."""
        with self._lock:
            self._corrupt = fn

    def maybe_corrupt(self, result):
        with self._lock:
            fn = self._corrupt
        if fn is None:
            return result
        with self._lock:
            self._fired["corrupt"] = self._fired.get("corrupt", 0) + 1
        return fn(result)

    def fired(self, point: str) -> int:
        with self._lock:
            return self._fired.get(point, 0)


__all__ = ["ChaosError", "ChaosInjector"]
