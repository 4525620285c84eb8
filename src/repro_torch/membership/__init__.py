"""Failure detection, leases, and view-change reconfiguration.

The subsystem that retires omniscient failure handling: nodes emit
periodic heartbeats, a phi-accrual-lite :class:`FailureDetector` turns
missed heartbeats into suspect/dead verdicts, and a lease-based
:class:`ViewManager` issues monotonically numbered views that drive
chain/ABD reconfiguration on both planes.  Clients retry with capped
exponential backoff + seeded jitter (:class:`RetryPolicy`) and carry the
view number as an epoch so requests straddling a view change are fenced.

All clocks are caller-supplied floats: nanoseconds in the timed sim,
harness steps in the functional plane.
"""

from repro_torch.membership.detector import (ALIVE, DEAD, SUSPECT,
                                       FailureDetector, MembershipConfig)
from repro_torch.membership.heartbeat import (HB_WIRE, MONITOR, HeartbeatService,
                                        attach_membership)
from repro_torch.membership.retry import RetryExhausted, RetryPolicy
from repro_torch.membership.view import View, ViewManager

__all__ = [
    "ALIVE",
    "SUSPECT",
    "DEAD",
    "FailureDetector",
    "MembershipConfig",
    "View",
    "ViewManager",
    "RetryPolicy",
    "RetryExhausted",
    "HeartbeatService",
    "attach_membership",
    "HB_WIRE",
    "MONITOR",
]
