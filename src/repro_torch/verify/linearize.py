"""Linearizability checking for register histories (Wing & Gong).

A history is a list of :class:`Operation` intervals — reads and writes
against per-key registers, with invoke/response timestamps from
:class:`repro_torch.core.handlers.HistoryLog`.  The history is linearizable iff
every operation can be assigned a linearization point inside its interval
such that the resulting sequential register history is legal (every read
returns the most recently written value, or the initial value).

The checker is the classic Wing–Gong recursion with the Lowe memoization:
at each step pick a *minimal* operation (one whose invoke precedes every
unlinearized response — no other completed operation finished before it
started), apply it to the register, recurse; memoize on (frozenset of
linearized op ids, register value) so equivalent interleavings are
explored once.  Keys are independent registers, so the history is
partitioned per key and each sub-history checked alone — this is what
makes the search tractable.

Incomplete operations (crashes, message loss, run cutoff): a pending
*write* may or may not have taken effect, so it is linearized optionally
and may also be dropped; a pending *read* returned nothing and constrains
nothing, so it is discarded.

On failure the result carries a counterexample: the longest partial
linearization found, plus, for every minimal candidate at the stuck
frontier, the expected register value versus what the operation observed
— the artifact a protocol author reads to locate the bug.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

#: registers start at 0 (the harness writes strictly positive values)
INITIAL_VALUE = 0


@dataclasses.dataclass(frozen=True)
class Operation:
    """One operation interval.  ``response is None`` == never completed."""

    op_id: int
    client: int
    kind: str           # "read" | "write"
    key: int
    value: int          # written value, or the value the read returned
    invoke: int
    response: int | None

    @property
    def pending(self) -> bool:
        return self.response is None


@dataclasses.dataclass
class CheckResult:
    ok: bool
    #: operations checked (completed + retained pending writes)
    checked: int = 0
    #: key the violation was found on (None when ok)
    key: int | None = None
    #: longest partial linearization (operation ids, in order)
    partial: tuple[int, ...] = ()
    #: per-candidate explanation at the stuck frontier
    frontier: tuple[str, ...] = ()

    def explain(self) -> str:
        if self.ok:
            return f"linearizable ({self.checked} operations)"
        lines = [f"NOT linearizable (key {self.key}):",
                 f"  longest partial linearization: "
                 f"{list(self.partial) or '[]'}",
                 "  stuck frontier (minimal candidates):"]
        lines += [f"    {f}" for f in self.frontier]
        return "\n".join(lines)


def operations_from_records(records: Iterable[dict]) -> list[Operation]:
    """Pair the invoke/ok records of a :class:`HistoryLog` into
    :class:`Operation` intervals (one per ``(client, op)``)."""
    open_ops: dict[tuple[int, int], dict] = {}
    ops: list[Operation] = []
    for r in records:
        ck = (r["client"], r["op"])
        if r["ev"] == "invoke":
            open_ops[ck] = r
        else:
            inv = open_ops.pop(ck)
            value = inv["value"] if inv["kind"] == "write" else r["value"]
            ops.append(Operation(inv["op"], inv["client"], inv["kind"],
                                 inv["key"], value, inv["ts"], r["ts"]))
    for inv in open_ops.values():
        ops.append(Operation(inv["op"], inv["client"], inv["kind"],
                             inv["key"], inv["value"], inv["ts"], None))
    return ops


def check_records(records: Iterable[dict]) -> CheckResult:
    """Check a :class:`HistoryLog`'s records for linearizability."""
    return check_history(operations_from_records(records))


def check_history(ops: list[Operation]) -> CheckResult:
    """Check a multi-key register history.  Keys partition the search."""
    by_key: dict[int, list[Operation]] = {}
    for o in ops:
        if o.pending and o.kind == "read":
            continue  # a pending read constrains nothing
        by_key.setdefault(o.key, []).append(o)
    checked = sum(len(v) for v in by_key.values())
    for key in sorted(by_key):
        res = _check_register(by_key[key])
        if not res.ok:
            res.key = key
            res.checked = checked
            return res
    return CheckResult(ok=True, checked=checked)


def _check_register(ops: list[Operation]) -> CheckResult:
    """Wing–Gong search over one register's history."""
    ops = sorted(ops, key=lambda o: o.invoke)
    completed = [o for o in ops if not o.pending]
    pending_writes = [o for o in ops if o.pending]
    need = frozenset(o.op_id for o in completed)

    seen: set[tuple[frozenset[int], int]] = set()
    best_partial: list[int] = []
    best_frontier: list[str] = []

    def minimal(done: frozenset[int]) -> list[Operation]:
        """Operations whose invoke precedes every unlinearized completed
        response — the only legal next linearization points."""
        horizon = min((o.response for o in completed
                       if o.op_id not in done), default=None)
        out = []
        for o in ops:
            if o.op_id in done:
                continue
            if horizon is not None and o.invoke > horizon:
                break  # ops is invoke-sorted; nothing later qualifies
            out.append(o)
        return out

    def search(done: frozenset[int], value: int,
               order: tuple[int, ...]) -> bool:
        nonlocal best_partial, best_frontier
        if need <= done:
            return True
        state = (done, value)
        if state in seen:
            return False
        seen.add(state)
        cands = minimal(done)
        stuck: list[str] = []
        for o in cands:
            if o.kind == "read":
                if o.value != value:
                    stuck.append(
                        f"read op {o.op_id} (client {o.client}) returned "
                        f"{o.value}, register holds {value}")
                    continue
                if search(done | {o.op_id}, value, order + (o.op_id,)):
                    return True
            else:
                if search(done | {o.op_id}, o.value, order + (o.op_id,)):
                    return True
                stuck.append(
                    f"write op {o.op_id} (client {o.client}) value "
                    f"{o.value}: no extension linearizes")
        if len(order) >= len(best_partial):
            best_partial = list(order)
            best_frontier = stuck or ["no minimal candidate (real-time "
                                      "order admits no next operation)"]
        return False

    # pending writes may additionally be skipped entirely: model the skip
    # by allowing the search to finish while they stay unlinearized —
    # `need` only contains completed ops, so that is already the case.
    if search(frozenset(), INITIAL_VALUE, ()):
        return CheckResult(ok=True, checked=len(ops))
    # name the pending writes in the explanation when they exist: their
    # optionality was already explored, so the failure is genuine.
    frontier = list(best_frontier)
    if pending_writes:
        frontier.append(
            "pending writes considered (applied or dropped): "
            + str([o.op_id for o in pending_writes]))
    return CheckResult(ok=False, checked=len(ops),
                       partial=tuple(best_partial),
                       frontier=tuple(frontier))
