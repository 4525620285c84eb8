"""Failure detection, leases, and view-change reconfiguration.

The port holds the detector, the retry policy and the view manager that
the functional DFS node uses.  The heartbeat service runs in the timed
simulator, which is not ported.
"""

from repro_torch.membership.detector import (ALIVE, DEAD, SUSPECT,
                                             FailureDetector, MembershipConfig)
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
]
