"""Verification plane: protocol-history checkers.

The consistency axis of the policy engine (``repro_torch.policy.spec.Chain`` /
``Quorum``) is *proven*, not just exercised: the functional plane logs
every operation's invoke/response (``repro_torch.core.handlers.HistoryLog``)
and :mod:`repro_torch.verify.linearize` decides whether the history is
linearizable, producing a minimal counterexample when it is not.
"""

from repro_torch.verify.linearize import (  # noqa: F401
    CheckResult,
    Operation,
    check_history,
    check_records,
    operations_from_records,
)
