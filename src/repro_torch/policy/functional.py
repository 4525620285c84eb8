"""Functional-plane compiler: :class:`PolicySpec` -> handler pipeline plan.

The byte-accurate plane (``repro_torch.core.handlers``) runs Listing 1 of the
paper: HH validates (section IV), PHs store/forward/encode (sections V and
VI), CH finalizes.  This module is the bridge from the declarative spec to
that plane:

  * :func:`write_plan` lowers a write spec to the wire-visible knobs the
    DFS client and node share (resiliency, strategy, EC geometry, and the
    encode locus — per-packet on the "NIC" vs batched on the client);
  * :func:`payload_stages` assembles the *payload-handler pipeline* a node
    runs for a request — the DFSNode executes exactly these stages, in
    this order, so the policy engine's composition is data, not branches.

The checkpoint plane (``repro_torch.checkpoint``) lowers its
``CheckpointPolicy`` through the same functions, which is what routes its
shard encoding to ``RSCode.encode_stripes`` (``RS(engine='client')``).
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.packets import ReplStrategy, Resiliency, WriteRequestHeader
from repro_torch.policy.spec import Chain, Flat, PolicySpec, Quorum, RS, Tree


@dataclasses.dataclass(frozen=True)
class WritePlan:
    """Wire-visible lowering of a write policy.

    ``kind``: "plain" (one target), "flat" (k independent plain writes),
    "tree" (durable ring/PBT forwarding), "ec-nic" (streaming per-packet
    encode at the nodes), "ec-client" (batched host encode via
    ``RSCode.encode_stripes`` + authenticated plain shard writes).
    """

    kind: str
    resiliency: Resiliency
    strategy: ReplStrategy = ReplStrategy.RING
    k: int = 1
    m: int = 0


def write_plan(spec: PolicySpec) -> WritePlan:
    """Lower a write :class:`PolicySpec` for the functional plane."""
    if spec.op != "write":
        raise ValueError(f"write_plan needs a write policy, got op={spec.op!r}")
    if spec.erasure is not None:
        e: RS = spec.erasure
        kind = "ec-client" if e.engine == "client" else "ec-nic"
        return WritePlan(kind, Resiliency.ERASURE_CODING, k=e.k, m=e.m)
    if isinstance(spec.replication, Flat):
        return WritePlan("flat", Resiliency.NONE, k=spec.replication.k)
    if isinstance(spec.replication, Tree):
        r = spec.replication
        return WritePlan("tree", Resiliency.REPLICATION, r.strategy, k=r.k)
    return WritePlan("plain", Resiliency.NONE)


@dataclasses.dataclass(frozen=True)
class ConsistencyPlan:
    """Functional-plane lowering of the consistency axis.

    ``kind``: "chain" (chain replication with CRAQ-style reads when
    ``dirty_read``) or "abd" (quorum read/write register).  The plan is
    what :class:`repro_torch.core.handlers.ReplicationHarness` executes over
    real :class:`~repro_torch.core.handlers.Router` nodes, logging every
    operation for the linearizability checker
    (:mod:`repro_torch.verify.linearize`)."""

    kind: str
    k: int
    dirty_read: bool = True


def consistency_plan(spec: PolicySpec) -> ConsistencyPlan:
    """Lower the consistency axis of ``spec`` for the functional plane."""
    c = spec.consistency
    if c is None:
        raise ValueError("consistency_plan needs a spec with a consistency "
                         "stage (Chain or Quorum)")
    if isinstance(c, Chain):
        return ConsistencyPlan("chain", c.k, c.dirty_read)
    assert isinstance(c, Quorum)
    return ConsistencyPlan("abd", c.n)


#: payload-handler stage names understood by ``DFSNode`` (executed in
#: order; see ``DFSNode.PAYLOAD_STAGES``).
STORE = "store"
FORWARD = "forward"
EMIT_PARITY = "emit_parity"
AGGREGATE = "aggregate"


def payload_stages(wrh: WriteRequestHeader) -> tuple[str, ...]:
    """The payload-handler pipeline a node runs for this request.

    Section map: ``store`` = the storage target write; ``forward`` =
    section V child forwarding; ``emit_parity`` / ``aggregate`` = the
    section VI data-node / parity-node roles of streaming EC."""
    if wrh.resiliency == Resiliency.ERASURE_CODING:
        if wrh.ec_index >= wrh.ec_k:
            return (AGGREGATE,)
        return (STORE, EMIT_PARITY)
    if wrh.resiliency == Resiliency.REPLICATION:
        return (STORE, FORWARD)
    return (STORE,)
