"""Fault-tolerant training loop (twin of ``repro/train/trainer.py``).

* checkpoint/restart — ``CheckpointManager`` (atomic, async); ``try_restore``
  restores the newest committed step, so a crashed or pre-empted job
  resumes where it left off.  A restore puts each leaf on the device and
  dtype of the loop's own state.
* step retry — a step that raises is retried up to ``max_retries`` times
  from the last good in-memory state; when the last attempt fails too, the
  loop re-restores from disk and goes on, or raises when there is no
  checkpoint.  ``fault_hook`` injects faults in tests.
* straggler accounting — a step slower than ``straggler_factor`` x the EMA
  of step time is logged and counted.
* NaN guard — a non-finite loss skips the update: the new params and
  optimizer state are swapped in only after the step is validated, which
  holds because steps are functional (they return new trees and leave their
  inputs as they were).

The JAX twin's module docstring names a ``wrap_grads`` hook for the int8
error-feedback reduction; neither its ``TrainLoop`` nor its step makers
take one, and the port's do not either (``optim.compress.ef_int8_allreduce``
is there for a step that wants it; ROADMAP Queue 3).
"""
from __future__ import annotations

import dataclasses
import math
import os
import tempfile
import time
from typing import Any, Callable, Iterable

from repro_torch.checkpoint import CheckpointManager
from repro_torch.common.config import ConfigBase


@dataclasses.dataclass(frozen=True)
class TrainerConfig(ConfigBase):
    total_steps: int = 100
    checkpoint_every: int = 50
    checkpoint_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    keep_last: int = 3
    max_retries: int = 2
    straggler_factor: float = 3.0
    log_every: int = 10


class TrainLoop:
    def __init__(
        self,
        cfg: TrainerConfig,
        step_fn: Callable,          # (params, opt_state, batch) -> (params, opt, metrics)
        params: Any,
        opt_state: Any,
        *,
        fault_hook: Callable[[int], None] | None = None,
        logger: Callable[[str], None] = print,
    ):
        self.cfg = cfg
        self.step_fn = step_fn
        self.params = params
        self.opt_state = opt_state
        self.fault_hook = fault_hook
        self.log = logger
        self.ckpt = CheckpointManager(cfg.checkpoint_dir, keep_last=cfg.keep_last)
        self.step = 0
        self.stats = {"retries": 0, "nan_skips": 0, "stragglers": 0, "restores": 0}
        self._ema_step_time: float | None = None

    # -- fault tolerance ----------------------------------------------------

    def try_restore(self) -> bool:
        latest = self.ckpt.latest_step()
        if latest is None:
            return False
        (self.params, self.opt_state), step = self.ckpt.restore_latest(
            (self.params, self.opt_state)
        )
        self.step = step
        self.stats["restores"] += 1
        self.log(f"[trainer] restored checkpoint @ step {step}")
        return True

    def _run_one(self, batch):
        if self.fault_hook is not None:
            self.fault_hook(self.step)  # may raise (test injection)
        new_params, new_opt, metrics = self.step_fn(self.params, self.opt_state, batch)
        loss = float(metrics.get("loss", 0.0))
        if not math.isfinite(loss):
            self.stats["nan_skips"] += 1
            self.log(f"[trainer] step {self.step}: non-finite loss {loss}, skipping update")
            return metrics
        self.params, self.opt_state = new_params, new_opt
        return metrics

    def run(self, batches: Iterable[Any]) -> dict:
        cfg = self.cfg
        history = []
        it = iter(batches)
        while self.step < cfg.total_steps:
            try:
                batch = next(it)
            except StopIteration:
                break
            t0 = time.time()
            metrics = None
            for attempt in range(cfg.max_retries + 1):
                try:
                    metrics = self._run_one(batch)
                    break
                except Exception as e:  # noqa: BLE001 (transient runtime faults)
                    self.stats["retries"] += 1
                    self.log(f"[trainer] step {self.step} attempt {attempt} failed: {e!r}")
                    if attempt == cfg.max_retries:
                        # final fallback: restore from disk and surface
                        if self.ckpt.latest_step() is not None:
                            self.try_restore()
                        else:
                            raise
            dt = time.time() - t0
            if self._ema_step_time is not None and dt > cfg.straggler_factor * self._ema_step_time:
                self.stats["stragglers"] += 1
                self.log(f"[trainer] step {self.step}: straggler ({dt:.2f}s vs "
                         f"EMA {self._ema_step_time:.2f}s)")
            self._ema_step_time = dt if self._ema_step_time is None else (
                0.9 * self._ema_step_time + 0.1 * dt
            )
            self.step += 1
            if metrics is not None:
                history.append({k: float(v) for k, v in metrics.items()})
            if cfg.log_every and self.step % cfg.log_every == 0 and metrics is not None:
                self.log(f"[trainer] step {self.step}: "
                         + " ".join(f"{k}={float(v):.5f}" for k, v in metrics.items()))
            if cfg.checkpoint_every and self.step % cfg.checkpoint_every == 0:
                self.ckpt.save_async(self.step, (self.params, self.opt_state))
        self.ckpt.wait()
        self.ckpt.save_async(self.step, (self.params, self.opt_state))
        self.ckpt.wait()
        return {"history": history, **self.stats, "final_step": self.step}
