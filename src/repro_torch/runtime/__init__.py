"""Runtime: the fault-tolerant training loop
(:mod:`repro_torch.runtime.train_loop`), the serving loop
(:mod:`repro_torch.runtime.serve_loop`) and the straggler monitor
(:mod:`repro_torch.runtime.straggler`, copied from ``repro.runtime``).
Elastic resharding waits for the sharding slice of the port."""

from repro_torch.runtime.serve_loop import Request, ServeLoop
from repro_torch.runtime.straggler import StragglerMonitor
from repro_torch.runtime.train_loop import Trainer, TrainLoopConfig

__all__ = ["Request", "ServeLoop", "StragglerMonitor", "Trainer", "TrainLoopConfig"]
