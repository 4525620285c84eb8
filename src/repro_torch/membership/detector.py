"""Timeout / phi-accrual-lite failure detection from heartbeat arrivals.

The detector is clock-agnostic: every method takes ``now`` as a float in
whatever unit the caller's clock uses (nanoseconds in the timed sim,
steps in the functional harness).  Each monitored node keeps an EWMA of
its heartbeat inter-arrival gap; the effective timeout base is
``max(interval, ewma)`` so jittery-but-alive nodes (stragglers, lossy
links) stretch their own thresholds instead of tripping them — the
phi-accrual idea with a two-level verdict instead of a continuous phi.

Verdicts are monotone per node: alive -> suspect -> dead.  A heartbeat
from a suspect revokes the suspicion (counted in ``false_suspects`` —
the measured false-positive channel); a heartbeat from a dead node is
counted (``late_heartbeats``) but does not resurrect it, because the
view manager has already removed it and rejoin is the repair plane's
job, not the detector's.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Iterable

ALIVE = "alive"
SUSPECT = "suspect"
DEAD = "dead"

_EWMA_GAIN = 0.2


@dataclasses.dataclass(frozen=True)
class MembershipConfig:
    """Shared knobs for detection and leasing (units = caller's clock).

    ``interval``      heartbeat emission period;
    ``suspect_after`` silence threshold in multiples of the effective
                      interval before a node is suspected;
    ``dead_after``    ditto for the dead verdict (> suspect_after);
    ``lease``         lease duration granted per heartbeat (defaults to
                      the dead timeout, which keeps the wait-out argument
                      tight: a falsely removed node's lease expires no
                      later than its dead verdict);
    ``adaptive``      enable the EWMA inter-arrival adaptation.
    """

    interval: float = 10_000.0
    suspect_after: float = 3.0
    dead_after: float = 5.0
    lease: float | None = None
    adaptive: bool = True

    def __post_init__(self) -> None:
        if self.interval <= 0:
            raise ValueError(f"interval must be > 0, got {self.interval}")
        if not 0 < self.suspect_after < self.dead_after:
            raise ValueError(
                f"need 0 < suspect_after < dead_after, got "
                f"{self.suspect_after} / {self.dead_after}")
        if self.lease is not None and self.lease <= 0:
            raise ValueError(f"lease must be > 0, got {self.lease}")

    @property
    def dead_timeout(self) -> float:
        return self.dead_after * self.interval

    @property
    def lease_span(self) -> float:
        return self.lease if self.lease is not None else self.dead_timeout


class FailureDetector:
    def __init__(self, nodes: Iterable[int], cfg: MembershipConfig,
                 now: float = 0.0):
        self.cfg = cfg
        nodes = list(nodes)
        self.last = {n: now for n in nodes}
        self.ewma = {n: cfg.interval for n in nodes}
        self.state = {n: ALIVE for n in nodes}
        self.false_suspects = 0
        self.late_heartbeats = 0
        # (now, node, new_state) for every transition, including revokes
        self.transitions: list[tuple[float, int, str]] = []

    def record(self, node: int, now: float) -> None:
        """A heartbeat from ``node`` arrived at ``now``."""
        if self.state[node] == DEAD:
            self.late_heartbeats += 1
            return
        gap = now - self.last[node]
        if self.cfg.adaptive and gap > 0:
            self.ewma[node] += _EWMA_GAIN * (gap - self.ewma[node])
        self.last[node] = now
        if self.state[node] == SUSPECT:
            self.state[node] = ALIVE
            self.false_suspects += 1
            self.transitions.append((now, node, ALIVE))

    def effective_interval(self, node: int) -> float:
        if self.cfg.adaptive:
            return max(self.cfg.interval, self.ewma[node])
        return self.cfg.interval

    def silence(self, node: int, now: float) -> float:
        return now - self.last[node]

    def poll(self, now: float) -> list[tuple[int, str]]:
        """Advance verdicts to ``now``; returns new (node, state) pairs."""
        out: list[tuple[int, str]] = []
        for node, st in self.state.items():
            if st == DEAD:
                continue
            eff = self.effective_interval(node)
            silent = now - self.last[node]
            if st == ALIVE and silent >= self.cfg.suspect_after * eff:
                self.state[node] = st = SUSPECT
                self.transitions.append((now, node, SUSPECT))
                out.append((node, SUSPECT))
            if st == SUSPECT and silent >= self.cfg.dead_after * eff:
                self.state[node] = DEAD
                self.transitions.append((now, node, DEAD))
                out.append((node, DEAD))
        return out
