"""Straggler detection and mitigation for the training loop.

At multi-pod scale a single slow host stalls every synchronous step.  The
monitor keeps a robust running estimate (median + MAD over a window) of
step times; a step beyond ``threshold`` MADs is flagged.  Mitigations are
advisory actions the runtime applies: re-dispatch the data shard of a
persistently slow host (backup-task semantics, MapReduce-style) or request
an elastic shrink that evicts the host.
"""

from __future__ import annotations

import dataclasses
import statistics
from collections import deque


@dataclasses.dataclass
class StragglerEvent:
    step: int
    dt: float
    median: float
    severity: float          # dt / median


class StragglerMonitor:
    def __init__(self, window: int = 50, factor: float = 2.0, patience: int = 3):
        self.window = deque(maxlen=window)
        self.factor = factor
        self.patience = patience
        self.events: list[StragglerEvent] = []
        self._consecutive = 0

    def record(self, step: int, dt: float) -> StragglerEvent | None:
        if len(self.window) >= 10:
            med = statistics.median(self.window)
            if dt > self.factor * med:
                ev = StragglerEvent(step, dt, med, dt / med)
                self.events.append(ev)
                self._consecutive += 1
                self.window.append(dt)
                return ev
        self._consecutive = 0
        self.window.append(dt)
        return None

    @property
    def should_mitigate(self) -> bool:
        """Persistent straggling: the runtime should act (backup dispatch /
        elastic eviction), not just log."""
        return self._consecutive >= self.patience

    def summary(self) -> dict:
        return {
            "events": len(self.events),
            "median_s": statistics.median(self.window) if self.window else None,
            "worst_severity": max((e.severity for e in self.events), default=0.0),
        }
