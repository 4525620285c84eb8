"""Fault-tolerant training loop (PyTorch port of
``repro.runtime.train_loop``).

Composes the substrates: the train step, the deterministic data pipeline,
async policy-protected checkpoints, straggler monitoring, and failure
handling.  Failure semantics (single-process simulation of the multi-host
runtime):

  * ``inject_failure(step)`` simulates losing storage nodes and/or compute
    devices at a step;
  * on compute loss: restore the last checkpoint onto the trainer's device
    -> replay the data pipeline from the restored step (deterministic
    resume);
  * on storage loss: checkpoints keep working in degraded mode (EC).

The trainer's device is its params' device.  A restored leaf is a fresh
tensor on that device (the manager restores onto the host).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import DataPipeline
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.runtime.straggler import StragglerMonitor


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 100
    checkpoint_every: int = 25
    log_every: int = 10


class Trainer:
    def __init__(
        self,
        step_fn: Callable,                    # (params, opt, batch) -> (p', o', metrics)
        params: Any,
        opt_state: Any,
        pipeline: DataPipeline,
        ckpt: CheckpointManager | None = None,
        cfg: TrainLoopConfig | None = None,
    ):
        self.step_fn = step_fn
        self.params = params
        self.opt_state = opt_state
        self.pipeline = pipeline
        self.ckpt = ckpt
        self.cfg = cfg or TrainLoopConfig()
        self.device = tree_leaves(params)[0].device
        self.monitor = StragglerMonitor()
        self.step = 0
        self.history: list[dict] = []
        self.restarts = 0

    # -- checkpoint/restore ----------------------------------------------------

    def _state(self) -> dict:
        return {"params": self.params, "opt": self.opt_state,
                "step": torch.tensor(self.step, dtype=torch.int64)}

    def _save(self, blocking: bool = False) -> None:
        if self.ckpt is None:
            return
        self.ckpt.save(self.step, self._state(), blocking=blocking)

    def restore_latest(self) -> None:
        if self.ckpt is None:
            raise RuntimeError("restore_latest needs a CheckpointManager")
        state = self.ckpt.restore(treedef=self._state())

        def on_device(x: torch.Tensor) -> torch.Tensor:
            return x.to(self.device, copy=True)

        self.params = tree_map(on_device, state["params"])
        self.opt_state = tree_map(on_device, state["opt"])
        self.step = int(state["step"])
        self.pipeline.seek(self.step)
        self.restarts += 1

    # -- main loop ---------------------------------------------------------------

    def run(
        self,
        inject_failure: Callable[[int, "Trainer"], bool] | None = None,
    ) -> list[dict]:
        """Returns per-step metric history.  ``inject_failure(step, self)``
        may mutate state (fail storage nodes, drop devices); returning True
        means "compute failure: restore + restart step"."""
        if self.ckpt is not None and self.ckpt.latest_step() is None:
            self._save()  # step-0 snapshot: a restore target always exists
        data = iter(self.pipeline)
        while self.step < self.cfg.total_steps:
            if inject_failure is not None and inject_failure(self.step, self):
                self.restore_latest()
                data = iter(self.pipeline)
                continue
            batch = next(data)
            t0 = time.time()
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch
            )
            loss = float(metrics["loss"])
            dt = time.time() - t0
            ev = self.monitor.record(self.step, dt)
            self.step += 1
            rec = {"step": self.step, "loss": loss, "dt": dt,
                   "straggler": bool(ev)}
            self.history.append(rec)
            if self.step % self.cfg.checkpoint_every == 0:
                self._save()
            if self.monitor.should_mitigate:
                rec["mitigation"] = "backup-dispatch"
        self._save(blocking=True)
        return self.history
