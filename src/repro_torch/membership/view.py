"""Lease-based view management over the failure detector.

A :class:`View` is a monotonically numbered membership snapshot; the
member tuple preserves the original chain order, so a chain's head/tail
under view v are ``members[0]`` / ``members[-1]``.

Safety argument (single shared clock, as both planes have one): every
heartbeat grants its sender a lease of ``cfg.lease_span``; a replica
serves only while its lease is unexpired and its epoch matches.  When
the detector declares a member dead the manager stops renewing that
lease and *waits it out* — the successor view activates strictly after
the removed node's last granted lease has expired.  A falsely-removed
node (alive but partitioned from the monitor) therefore self-fences by
lease expiry before the new view can commit conflicting writes.  With
the default ``lease == dead_timeout`` the wait is usually already over
when the verdict lands, so the unavailability window ~= detection time.
Clock drift between replicas is assumed zero (the sim clock is global);
a real deployment would pad the wait by the drift bound.

Removed nodes never rejoin: re-admission after repair is the repair
plane's job and would need state transfer this subsystem does not model.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable, Iterable

from repro_torch.membership.detector import DEAD, FailureDetector, MembershipConfig


@dataclasses.dataclass(frozen=True)
class View:
    number: int
    members: tuple[int, ...]

    def __contains__(self, node: int) -> bool:
        return node in self.members


class ViewManager:
    def __init__(self, members: Iterable[int], cfg: MembershipConfig,
                 now: float = 0.0):
        members = tuple(members)
        self.cfg = cfg
        self.detector = FailureDetector(members, cfg, now=now)
        self.lease_span = cfg.lease_span
        self.view = View(1, members)
        # bootstrap grant: everyone is leased at construction time
        self.lease_until = {n: now + self.lease_span for n in members}
        self.removed: set[int] = set()
        self.dead_log: list[tuple[float, int]] = []   # (detected_at, node)
        self.view_log: list[tuple[float, View]] = [(now, self.view)]
        self.on_change: list[Callable[[View], None]] = []

    def record_heartbeat(self, node: int, now: float) -> View:
        """Heartbeat arrival: renew the lease unless already removed."""
        if node in self.removed or node not in self.lease_until:
            self.detector.late_heartbeats += 1
            return self.view
        self.detector.record(node, now)
        self.lease_until[node] = now + self.lease_span
        return self.view

    def activation_at(self) -> float | None:
        """When the pending view (if any) may activate: the latest lease
        expiry among removed-but-still-listed members."""
        gone = [n for n in self.view.members if n in self.removed]
        if not gone:
            return None
        return max(self.lease_until[n] for n in gone)

    def pending_change(self) -> bool:
        return self.activation_at() is not None

    def poll(self, now: float) -> View | None:
        """Advance detection and view state; returns a newly activated
        view, or None."""
        for node, state in self.detector.poll(now):
            if state == DEAD and node in self.view.members:
                self.removed.add(node)
                self.dead_log.append((now, node))
        at = self.activation_at()
        if at is None or now <= at:
            return None
        members = tuple(n for n in self.view.members
                        if n not in self.removed)
        self.view = View(self.view.number + 1, members)
        self.view_log.append((now, self.view))
        for fn in self.on_change:
            fn(self.view)
        return self.view

    def alive(self) -> set[int]:
        """Members of the active view minus pending removals — the node
        set a placement decision may target right now (a suspect whose
        lease is still being waited out is already excluded)."""
        return {n for n in self.view.members if n not in self.removed}

    def detected_at(self, node: int) -> float | None:
        for t, n in self.dead_log:
            if n == node:
                return t
        return None
