"""Runtime: the fault-tolerant training loop
(:mod:`repro_torch.runtime.train_loop`), the serving loop
(:mod:`repro_torch.runtime.serve_loop`), the straggler monitor
(:mod:`repro_torch.runtime.straggler`, copied from ``repro.runtime``) and
elastic resharding (:mod:`repro_torch.runtime.elastic`)."""

from repro_torch.runtime.elastic import build_mesh, grow, reshard_state, shrink
from repro_torch.runtime.serve_loop import Request, ServeLoop
from repro_torch.runtime.straggler import StragglerMonitor
from repro_torch.runtime.train_loop import Trainer, TrainLoopConfig

__all__ = ["Request", "ServeLoop", "StragglerMonitor", "Trainer", "TrainLoopConfig",
           "build_mesh", "grow", "reshard_state", "shrink"]
