"""Functional sPIN handler layer: Listing 1 of the paper, executable.

This module is the *functional* (untimed) realization of the NIC-offloaded
DFS: an in-process cluster of :class:`DFSNode` objects connected by a
:class:`Router`, each running the header/payload/completion handler pipeline
of Listing 1 on incoming packets:

  * HH  -> ``DFS_request_init``: capability validation (section IV), request
    table allocation (deny-on-full), recording of WRH info needed by PHs;
  * PH  -> ``DFS_request_process_pkt``: store payload to the storage target,
    forward to broadcast children (section V), or produce/aggregate
    intermediate erasure-coding parities (section VI);
  * CH  -> ``DFS_request_fini``: request finalization and acknowledgement.

sPIN's ordering guarantees are preserved structurally: the router delivers
the header packet first and the completion packet last; PHs of a message run
only after its HH completed (enforced by the per-request ``accept`` flag).

Write acknowledgements implement *durable replication*: a node acks its
parent only after its local write and all children acks arrived, so the
client's WRITE_ACK means the data reached every replica — the semantics a
checkpoint manager needs.  The timed model of the same dataflow lives in
``repro_torch.sim``; this layer backs integration tests and the checkpoint plane.
"""

from __future__ import annotations

import dataclasses
import random
from collections import defaultdict
from typing import Callable

import numpy as np

from repro_torch.core import erasure, gf256
from repro_torch.core.auth import CapabilityAuthority, Rights
from repro_torch.core.packets import (
    DEFAULT_MTU,
    RDMA_HEADER_SIZE,
    DFSHeader,
    OpType,
    Packet,
    ReplicaCoord,
    ReplStrategy,
    Resiliency,
    WriteRequestHeader,
    packetize_write,
)
from repro_torch.core.packets import ReadRequestHeader
from repro_torch.core.replication import children_of
from repro_torch.core.state import RequestEntry, RequestTable
from repro_torch.membership.detector import MembershipConfig
from repro_torch.membership.retry import RetryExhausted, RetryPolicy
from repro_torch.membership.view import ViewManager

# NB: repro_torch.policy.functional is imported lazily (function scope) — the
# policy package imports repro_torch.core.packets, so a module-level import here
# would make `import repro_torch.policy` circular.


class StorageTarget:
    """Byte-addressable storage medium (the paper assumes it ingests at
    line rate; we model it as host memory, as NVMM-backed DFSs do)."""

    def __init__(self, size: int = 1 << 24):
        self.mem = np.zeros(size, dtype=np.uint8)
        self.bytes_written = 0

    def write(self, addr: int, data: np.ndarray) -> None:
        data = np.asarray(data, dtype=np.uint8)
        if addr < 0 or addr + data.size > self.mem.size:
            raise ValueError(f"write [{addr}, {addr + data.size}) out of bounds")
        self.mem[addr : addr + data.size] = data
        self.bytes_written += int(data.size)

    def read(self, addr: int, size: int) -> np.ndarray:
        return self.mem[addr : addr + size].copy()


@dataclasses.dataclass
class Event:
    """Handler -> host-software event queue entry (section III-C)."""

    kind: str
    greq_id: int
    detail: str = ""


class Router:
    """Synchronous in-process packet delivery between nodes.

    Uses a FIFO work queue (not recursion) so deep replica chains and
    interleaved EC streams process in arrival order, mirroring a network
    that delivers header-first / completion-last per message.
    """

    def __init__(self):
        self.nodes: dict[int, "DFSNode"] = {}
        self.client_acks: dict[int, list[Packet]] = defaultdict(list)
        self._queue: list[tuple[int, Packet]] = []
        self._draining = False
        self.packets_delivered = 0
        self.packets_dropped = 0
        self.failed: set[int] = set()
        self.loss: dict[int, float] = {}
        self._loss_rng = random.Random(0)
        #: optional reachability oracle ``(src, dst) -> bool`` consulted
        #: for sends that carry a source (partition/flap injection); the
        #: harness installs a closure over its fault schedule + step clock
        self.unreachable: Callable[[int, int], bool] | None = None

    def register(self, node: "DFSNode") -> None:
        self.nodes[node.node_id] = node

    def fail(self, node_id: int) -> None:
        """Crash a node: packets towards it are blackholed (counted),
        so reads/writes against it time out at the caller instead of
        silently succeeding."""
        self.failed.add(node_id)

    def heal(self, node_id: int) -> None:
        self.failed.discard(node_id)

    def set_loss(self, loss: dict[int, float] | None, seed: int = 0) -> None:
        """Lossy links: packets towards node ``n`` are dropped with
        probability ``loss[n]`` (seeded, deterministic; counted in
        ``packets_dropped``) — the functional-plane mirror of the timed
        network's :class:`repro_torch.policy.FailureModel` loss axis.  Callers
        that must make progress under loss retry with a bounded budget
        (``StorageCluster.read_objects``)."""
        self.loss = dict(loss or {})
        self._loss_rng = random.Random(seed)

    def send(self, dest: int, pkt: Packet, src: int | None = None) -> None:
        if (src is not None and self.unreachable is not None
                and self.unreachable(src, dest)):
            self.packets_dropped += 1
            return
        p = self.loss.get(dest, 0.0)
        if p > 0.0 and self._loss_rng.random() < p:
            self.packets_dropped += 1
            return
        self._queue.append((dest, pkt))
        if not self._draining:
            self._drain()

    def send_to_client(self, client_id: int, pkt: Packet) -> None:
        self.client_acks[client_id].append(pkt)

    def _drain(self) -> None:
        self._draining = True
        try:
            while self._queue:
                dest, pkt = self._queue.pop(0)
                if dest in self.failed:
                    self.packets_dropped += 1
                    continue
                self.packets_delivered += 1
                self.nodes[dest].handle_packet(pkt)
        finally:
            self._draining = False


@dataclasses.dataclass
class _ReqState:
    accept: bool
    wrh: WriteRequestHeader | None
    client_id: int
    children: list[int]
    local_done: bool = False
    child_acks: int = 0
    parent: int | None = None  # node id to ack (None => ack the client)
    acked: bool = False
    #: payload-handler pipeline for this request, assembled from the policy
    #: carried by the WRH (repro_torch.policy.functional.payload_stages)
    stages: tuple[str, ...] = ()


class DFSNode:
    """One storage node: NIC-offloaded policy engine + storage target."""

    def __init__(
        self,
        node_id: int,
        router: Router,
        authority: CapabilityAuthority,
        storage_size: int = 1 << 24,
        req_table_capacity: int | None = None,
        accumulator_pool: int = 256,
        mtu: int = DEFAULT_MTU,
        now_fn: Callable[[], int] = lambda: 0,
    ):
        self.node_id = node_id
        self.router = router
        self.authority = authority
        self.storage = StorageTarget(storage_size)
        self.req_table = RequestTable(req_table_capacity)
        self.mtu = mtu
        self.now_fn = now_fn
        self.events: list[Event] = []
        self._reqs: dict[int, _ReqState] = {}
        self._parents: dict[int, int | None] = {}
        # EC aggregation state: greq -> (pool, seq->done-count bookkeeping)
        self._acc_pool = erasure.AccumulatorPool(accumulator_pool, mtu)
        self._ec_agg: dict[int, dict] = {}
        router.register(self)

    # -- Listing 1: header handler ------------------------------------------

    def _header_handler(self, pkt: Packet) -> None:
        dfs, wrh = pkt.dfs, pkt.wrh
        assert dfs is not None and wrh is not None
        accept = self._request_init(dfs, wrh)
        children: list[int] = []
        parent: int | None = None
        if accept and wrh.resiliency == Resiliency.REPLICATION and wrh.replicas:
            k = len(wrh.replicas)
            children = children_of(wrh.virtual_rank, k, wrh.strategy)
            if wrh.virtual_rank > 0:
                parent = self._parent_node(wrh)
        entry_ok = accept and self.req_table.insert(
            RequestEntry(dfs.greq_id, accept)
        )
        if accept and not entry_ok:
            accept = False  # table full: deny, client retries (section III-B2)
            self.events.append(Event("deny_full", dfs.greq_id))
        from repro_torch.policy.functional import payload_stages

        self._reqs[dfs.greq_id] = _ReqState(
            accept=accept,
            wrh=wrh,
            client_id=dfs.client_id,
            children=children,
            parent=parent,
            stages=payload_stages(wrh),
        )
        if not accept:
            self._nack(dfs.greq_id, dfs.client_id)

    def _parent_node(self, wrh: WriteRequestHeader) -> int | None:
        k = len(wrh.replicas)
        r = wrh.virtual_rank
        if r == 0:
            return None
        pr = r - 1 if wrh.strategy == ReplStrategy.RING else (r - 1) // 2
        return wrh.replicas[pr].node

    def _request_init(self, dfs: DFSHeader, wrh: WriteRequestHeader) -> bool:
        """Capability check: signature, expiry, rights, extent (section IV)."""
        return self.authority.verify(
            dfs.capability,
            now=self.now_fn(),
            op_rights=Rights.WRITE,
            offset=wrh.addr,
            length=wrh.size,
            client_id=dfs.client_id,
        )

    # -- Listing 1: payload handler -----------------------------------------

    def _payload_handler(self, pkt: Packet) -> None:
        st = self._reqs.get(pkt.greq_id)
        if st is None or not st.accept:
            return  # packet dropped (Listing 1 else-branch)
        for stage in st.stages:
            self.PAYLOAD_STAGES[stage](self, pkt, st)

    # Payload-pipeline stages (policy building blocks; the pipeline for a
    # request is assembled at header time by repro_torch.policy.functional):

    def _stage_store(self, pkt: Packet, st: _ReqState) -> None:
        """Store to the local target."""
        assert st.wrh is not None
        self.storage.write(st.wrh.addr + pkt.payload_offset, pkt.payload)

    def _stage_forward(self, pkt: Packet, st: _ReqState) -> None:
        """Replication: forward to children (per-packet, before host
        memory) — section V."""
        for child_rank in st.children:
            self._forward_to_child(pkt, st, child_rank)

    def _stage_emit_parity(self, pkt: Packet, st: _ReqState) -> None:
        """EC data node: emit intermediate parities — section VI."""
        self._emit_intermediate_parities(pkt, st)

    def _stage_aggregate(self, pkt: Packet, st: _ReqState) -> None:
        """EC parity node: XOR-aggregate intermediate parities."""
        self._aggregate_parity(pkt, st)

    # keys are the stage names of repro_torch.policy.functional (STORE, FORWARD,
    # EMIT_PARITY, AGGREGATE) — literals here to keep the import lazy
    PAYLOAD_STAGES = {
        "store": _stage_store,
        "forward": _stage_forward,
        "emit_parity": _stage_emit_parity,
        "aggregate": _stage_aggregate,
    }

    def _forward_to_child(self, pkt: Packet, st: _ReqState, child_rank: int) -> None:
        wrh = st.wrh
        assert wrh is not None
        coord = wrh.replicas[child_rank]
        if pkt.is_header:
            child_wrh = dataclasses.replace(
                wrh, virtual_rank=child_rank, addr=coord.addr
            )
            fwd = dataclasses.replace(pkt, wrh=child_wrh)
        else:
            fwd = pkt
        self.router.send(coord.node, fwd)

    def _emit_intermediate_parities(self, pkt: Packet, st: _ReqState) -> None:
        wrh = st.wrh
        assert wrh is not None
        code = erasure.RSCode(wrh.ec_k, wrh.ec_m)
        coeffs = code.parity_matrix[:, wrh.ec_index]
        seq = pkt.pkt_index
        # One broadcast LUT multiply produces the payloads for all m parity
        # targets (the batched data-plane idiom; see kernels/ops.py for the
        # stripe-batched kernel the whole-stripe paths use).
        encs = gf256.gf_mul_vec(pkt.payload[None, :], coeffs[:, None])
        for i in range(wrh.ec_m):
            coord = wrh.replicas[i]  # parity coordinates (section VI)
            enc = encs[i]
            # NB: wrh.seq (the stripe id) is preserved — the parity node
            # aggregates across the k streams of the stripe by this id;
            # the aggregation sequence index travels in pkt_index.
            ip_wrh = dataclasses.replace(
                wrh,
                addr=coord.addr,
                ec_index=wrh.ec_k + i,
                replicas=(),
            )
            ip = Packet(
                greq_id=pkt.greq_id,
                pkt_index=seq,
                is_header=pkt.is_header,
                is_completion=pkt.is_completion,
                dfs=pkt.dfs if pkt.is_header else None,
                wrh=ip_wrh,
                rrh=None,
                payload=enc,
                payload_offset=pkt.payload_offset,
                wire_size=pkt.wire_size,
            )
            self.router.send(coord.node, ip)

    def _aggregate_parity(self, pkt: Packet, st: _ReqState) -> None:
        """Parity-node PH: XOR k intermediate parities per aggregation
        sequence (accumulator pool + on-NIC hash table, section VI-B3).

        The k data-node streams of one stripe share ``wrh.seq`` (stripe id);
        aggregation sequence i completes when all k intermediate parities of
        packet i have been XORed.  The stripe acks the client once every
        sequence is done and all k streams completed.
        """
        wrh = st.wrh
        assert wrh is not None
        stripe = wrh.seq
        agg = self._ec_agg.setdefault(
            stripe,
            {
                "table": {},
                "done": 0,
                "expected": None,
                "streams_done": 0,
                "client_id": st.client_id,
                "stream_greqs": [],
            },
        )
        key = pkt.pkt_index  # aggregation sequence id i (paper Fig. 14)
        idx = agg["table"].get(key)
        if idx is None:
            idx = self._acc_pool.allocate()
            if idx is None:
                self.events.append(Event("ec_cpu_fallback", pkt.greq_id))
                return
            agg["table"][key] = idx
        count = self._acc_pool.xor_into(idx, pkt.payload)
        if count == wrh.ec_k:
            final = self._acc_pool.release(idx)[: pkt.payload_size]
            del agg["table"][key]
            self.storage.write(wrh.addr + pkt.payload_offset, final)
            agg["done"] += 1
        if pkt.is_completion:
            agg["streams_done"] += 1
            agg["expected"] = pkt.pkt_index + 1
            agg["stream_greqs"].append(pkt.greq_id)
        if (
            agg["streams_done"] == wrh.ec_k
            and agg["expected"] is not None
            and agg["done"] == agg["expected"]
            and not agg["table"]
        ):
            for g in agg["stream_greqs"]:
                self.req_table.remove(g)
                self._reqs.pop(g, None)
            del self._ec_agg[stripe]
            self.router.send_to_client(
                agg["client_id"], _control_packet(stripe, OpType.WRITE_ACK)
            )
            self.events.append(Event("parity_done", stripe))

    # -- Listing 1: completion handler ----------------------------------------

    def _completion_handler(self, pkt: Packet) -> None:
        st = self._reqs.get(pkt.greq_id)
        if st is None or not st.accept:
            return
        if "aggregate" in st.stages:
            return  # parity streams ack at stripe granularity (_aggregate_parity)
        st.local_done = True
        self._maybe_ack(pkt.greq_id)

    def _maybe_ack(self, greq_id: int) -> None:
        st = self._reqs[greq_id]
        if st.acked or not st.local_done or st.child_acks < len(st.children):
            return
        st.acked = True
        self.req_table.remove(greq_id)
        ack = _control_packet(greq_id, OpType.WRITE_ACK)
        if st.parent is None:
            self.router.send_to_client(st.client_id, ack)
        else:
            self.router.send(st.parent, ack)
        self.events.append(Event("write_done", greq_id))

    def _on_child_ack(self, greq_id: int) -> None:
        st = self._reqs.get(greq_id)
        if st is None:
            return
        st.child_acks += 1
        self._maybe_ack(greq_id)

    def _nack(self, greq_id: int, client_id: int) -> None:
        self.router.send_to_client(client_id, _control_packet(greq_id, OpType.NACK))
        self.events.append(Event("nack", greq_id))

    # -- read path (first read-policy: request up, data streamed back) -------

    def _read_handler(self, pkt: Packet) -> None:
        """HH of the read pipeline: capability check (Rights.READ), then
        the PH streams the extent back in MTU-sized READ_RESP packets."""
        dfs, rrh = pkt.dfs, pkt.rrh
        assert dfs is not None and rrh is not None
        ok = self.authority.verify(
            dfs.capability,
            now=self.now_fn(),
            op_rights=Rights.READ,
            offset=rrh.addr,
            length=rrh.size,
            client_id=dfs.client_id,
        )
        if not ok:
            self._nack(dfs.greq_id, dfs.client_id)
            return
        data = self.storage.read(rrh.addr, rrh.size)
        cap = self.mtu - RDMA_HEADER_SIZE
        off = 0
        idx = 0
        while True:
            chunk = data[off : off + cap]
            is_last = off + chunk.size >= data.size
            self.router.send_to_client(
                dfs.client_id,
                Packet(
                    greq_id=dfs.greq_id,
                    pkt_index=idx,
                    is_header=(idx == 0),
                    is_completion=is_last,
                    dfs=None,
                    wrh=None,
                    rrh=rrh,
                    payload=np.ascontiguousarray(chunk),
                    payload_offset=off,
                    wire_size=RDMA_HEADER_SIZE + int(chunk.size),
                    ctrl=OpType.READ_RESP,
                ),
            )
            off += int(chunk.size)
            idx += 1
            if is_last:
                break
        self.events.append(Event("read_done", dfs.greq_id))

    # -- dispatch -------------------------------------------------------------

    def handle_packet(self, pkt: Packet) -> None:
        if pkt.ctrl is not None:
            if pkt.ctrl == OpType.WRITE_ACK:
                self._on_child_ack(pkt.greq_id)
            return
        if pkt.rrh is not None:
            self._read_handler(pkt)
            return
        if pkt.is_header:
            self._header_handler(pkt)
        self._payload_handler(pkt)
        if pkt.is_completion:
            self._completion_handler(pkt)

    # -- host-side API ---------------------------------------------------------

    def read(self, addr: int, size: int) -> np.ndarray:
        return self.storage.read(addr, size)

    def cleanup_stale(self, alive: set[int]) -> list[int]:
        """Cleanup-handler semantics for client failures (section VII)."""
        for g in list(self._reqs):
            if g not in alive and not self._reqs[g].acked:
                agg = self._ec_agg.pop(g, None)
                if agg:
                    for idx in agg["table"].values():
                        self._acc_pool.release(idx)
                del self._reqs[g]
                self.events.append(Event("cleanup", g))
        return self.req_table.cleanup_stale(alive)


def _control_packet(greq_id: int, op: OpType) -> Packet:
    return Packet(
        greq_id=greq_id,
        pkt_index=0,
        is_header=False,
        is_completion=False,
        dfs=None,
        wrh=None,
        rrh=None,
        payload=np.zeros(0, dtype=np.uint8),
        payload_offset=0,
        wire_size=RDMA_HEADER_SIZE,
        ctrl=op,
    )


# ---------------------------------------------------------------------------
# Consistency-axis harness: chain replication (CRAQ reads) and ABD quorums
# over Router nodes, with every operation logged for the linearizability
# checker (repro_torch.verify.linearize).
# ---------------------------------------------------------------------------


class HistoryLog:
    """Operation history with unique, monotonically increasing logical
    timestamps.  Every invoke/response is one record; the checker
    (:func:`repro_torch.verify.linearize.check_history`) consumes the records
    directly."""

    def __init__(self):
        self._t = 0
        self.records: list[dict] = []

    def tick(self) -> int:
        self._t += 1
        return self._t

    def invoke(self, client: int, op_id: int, kind: str, key: int,
               value=None) -> None:
        self.records.append({"ts": self.tick(), "ev": "invoke",
                             "client": client, "op": op_id, "kind": kind,
                             "key": key, "value": value})

    def respond(self, client: int, op_id: int, value=None) -> None:
        self.records.append({"ts": self.tick(), "ev": "ok",
                             "client": client, "op": op_id, "value": value})


@dataclasses.dataclass
class RMsg:
    """One consistency-protocol message (small control-plane header; the
    payload bytes of the timed plane are abstracted to ``body``)."""

    kind: str
    src: int
    rid: int
    key: int
    body: dict


class ChainReplica:
    """One chain-replication replica with CRAQ clean/dirty reads.

    State per key: ``committed`` (version, value) — the clean value —
    plus ``pending`` dirty versions awaiting the tail's commit ack.
    Writes enter at the head (which assigns the version, idempotently
    per rid so client retries are safe), forward down the chain, commit
    at the tail, and the ack walks back up marking each copy clean.
    Reads are served from any replica: clean keys locally, dirty keys
    after a version query to the tail (CRAQ).

    The replica never reads the harness's fault schedule: its chain
    position comes from the *learned* view (``view_no``/``members``),
    installed by ``vi``/``hba`` messages from the view service, and it
    serves only while (a) it is listed in that view, (b) its lease —
    renewed by every heartbeat ack — is unexpired, and (c) the message's
    epoch matches its view.  Stale-epoch client requests get a ``fence``
    reply so the client refreshes and resends; everything else fenced is
    silently dropped (the sender retries).  A replica that learns it
    became the tail runs :meth:`become_tail`.

    ``tail_bump=False`` is the mutation hook for the checker self-test:
    the tail acks *without* committing, so acknowledged writes never
    become visible at the tail — a stale-read bug the linearizability
    checker must flag."""

    def __init__(self, node_id: int, harness: "ReplicationHarness",
                 tail_bump: bool = True):
        self.node_id = node_id
        self.h = harness
        self.tail_bump = tail_bump
        self.committed: dict[int, tuple[int, int]] = {}
        self.pending: dict[int, dict[int, tuple[int, int]]] = {}
        self._max_ver: dict[int, int] = {}
        self._rid_vers: dict[int, int] = {}
        self.view_no = harness.views.view.number
        self.members = list(harness.views.view.members)
        self.lease_until = harness.views.lease_until.get(node_id, 0.0)
        harness.router.register(self)

    def handle_packet(self, msg: RMsg) -> None:
        self.h.enqueue(self, msg)

    # -- write path ---------------------------------------------------------

    def _next_ver(self, key: int) -> int:
        v = self._max_ver.get(key, self.committed.get(key, (0, 0))[0]) + 1
        self._max_ver[key] = v
        return v

    def _note_ver(self, key: int, ver: int) -> None:
        if ver > self._max_ver.get(key, 0):
            self._max_ver[key] = ver

    def _commit(self, key: int, ver: int) -> None:
        pend = self.pending.get(key)
        cur = self.committed.get(key, (0, 0))[0]
        if ver > cur and pend and ver in pend:
            self.committed[key] = (ver, pend[ver][0])
            cur = ver
        if pend:
            for v in [v for v in pend if v <= cur]:
                del pend[v]
            if not pend:
                del self.pending[key]

    def _ack_up(self, key: int, ver: int, rid: int, client: int) -> None:
        view = self.members
        i = view.index(self.node_id)
        body = {"ver": ver, "cl": client, "ep": self.view_no}
        if i == 0:
            self.h.send(self.node_id, client,
                        RMsg("cwa", self.node_id, rid, key, body))
        else:
            self.h.send(self.node_id, view[i - 1],
                        RMsg("ca", self.node_id, rid, key, body))

    def _on_cw(self, m: RMsg) -> None:
        view = self.members
        i = view.index(self.node_id)
        ver = m.body.get("ver")
        if ver is None:
            # entering at the head: assign the version, idempotently per
            # rid so a client retry re-propagates the same version
            ver = self._rid_vers.get(m.rid)
            if ver is None:
                ver = self._next_ver(m.key)
        # every replica remembers rid -> version (not just the assigning
        # head): after a head crash the retried write enters at the NEW
        # head, which must reuse the original version — assigning a
        # fresh one would re-apply the old value over a newer committed
        # write (a new-old inversion the checker catches)
        self._rid_vers[m.rid] = ver
        self._note_ver(m.key, ver)
        self.pending.setdefault(m.key, {})[ver] = (m.body["val"], m.rid)
        if i == len(view) - 1:
            # the tail is the commit point
            if self.tail_bump:
                self._commit(m.key, ver)
            else:
                del self.pending[m.key][ver]  # mutation: ack, never commit
                if not self.pending[m.key]:
                    del self.pending[m.key]
            self._ack_up(m.key, ver, m.rid, m.body["cl"])
        else:
            self.h.send(self.node_id, view[i + 1],
                        RMsg("cw", self.node_id, m.rid, m.key,
                             {"cl": m.body["cl"], "val": m.body["val"],
                              "ver": ver, "ep": self.view_no}))

    def _on_ca(self, m: RMsg) -> None:
        # downstream committed: mark clean here, propagate upstream
        self._commit(m.key, m.body["ver"])
        self._ack_up(m.key, m.body["ver"], m.rid, m.body["cl"])

    def become_tail(self) -> None:
        """Chain reconfiguration: this replica is the new tail — commit
        every pending (fully-replicated-on-the-live-chain) version."""
        if not self.tail_bump:
            return
        for key in list(self.pending):
            self._commit(key, max(self.pending[key]))

    # -- read path (CRAQ) ---------------------------------------------------

    def _serve(self, m: RMsg, ver: int, val: int) -> None:
        self.h.send(self.node_id, m.body["cl"],
                    RMsg("crr", self.node_id, m.rid, m.key,
                         {"ver": ver, "val": val}))

    def _on_cr(self, m: RMsg) -> None:
        view = self.members
        is_tail = view[-1] == self.node_id
        dirty = bool(self.pending.get(m.key))
        if is_tail or not dirty:
            ver, val = self.committed.get(m.key, (0, 0))
            self._serve(m, ver, val)
        else:
            # dirty: resolve the committed version with the tail (CRAQ)
            self.h.send(self.node_id, view[-1],
                        RMsg("vq", self.node_id, m.rid, m.key,
                             {"cl": m.body["cl"], "org": self.node_id,
                              "ep": self.view_no}))

    def _on_vq(self, m: RMsg) -> None:
        ver = self.committed.get(m.key, (0, 0))[0]
        self.h.send(self.node_id, m.body["org"],
                    RMsg("vr", self.node_id, m.rid, m.key,
                         {"cl": m.body["cl"], "ver": ver,
                          "ep": self.view_no}))

    def _on_vr(self, m: RMsg) -> None:
        v = m.body["ver"]
        cver, cval = self.committed.get(m.key, (0, 0))
        if v > cver:
            pend = self.pending.get(m.key, {})
            if v in pend:
                self._serve(m, v, pend[v][0])
                return
        # the local copy already advanced past the tail's answer (commit
        # acks overtook the version reply): the newer committed value is
        # a valid later linearization point within the read's interval.
        self._serve(m, cver, cval)

    # -- view installation / fencing ----------------------------------------

    def _on_view(self, m: RMsg) -> None:
        """Adopt a newer view from a ``vi`` install or an ``hba`` lease
        grant; a replica that just became the tail commits its pending
        (fully-replicated) versions."""
        if "lease" in m.body:
            self.lease_until = max(self.lease_until, m.body["lease"])
        no = m.body["no"]
        if no > self.view_no:
            was_tail = bool(self.members) and self.members[-1] == self.node_id
            self.view_no = no
            self.members = list(m.body["members"])
            if (self.members and self.members[-1] == self.node_id
                    and not was_tail):
                self.become_tail()

    def _fence(self, m: RMsg) -> None:
        self.h.fenced += 1
        cl = m.body.get("cl")
        client_facing = m.kind == "cr" or (m.kind == "cw"
                                           and m.body.get("ver") is None)
        if client_facing and cl is not None:
            self.h.send(self.node_id, cl,
                        RMsg("fence", self.node_id, m.rid, m.key,
                             {"no": self.view_no}))

    _DISPATCH = {"cw": _on_cw, "ca": _on_ca, "cr": _on_cr,
                 "vq": _on_vq, "vr": _on_vr}

    def process(self, m: RMsg) -> None:
        if m.kind in ("vi", "hba"):
            self._on_view(m)
            return
        if self.node_id not in self.members or self.h.steps > self.lease_until:
            # removed from the view, or self-fenced by lease expiry (the
            # partitioned-tail case the wait-out protects against)
            self.h.fenced += 1
            return
        ep = m.body.get("ep")
        if ep is not None and ep != self.view_no:
            self._fence(m)
            return
        self._DISPATCH[m.kind](self, m)


class AbdReplica:
    """One ABD quorum replica: a per-key tagged register.  Tags are
    ``(seq, client_id)`` pairs, totally ordered; writes and read
    write-backs adopt strictly newer tags only."""

    def __init__(self, node_id: int, harness: "ReplicationHarness"):
        self.node_id = node_id
        self.h = harness
        self.reg: dict[int, tuple[tuple[int, int], int]] = {}
        harness.router.register(self)

    def handle_packet(self, msg: RMsg) -> None:
        self.h.enqueue(self, msg)

    def _get(self, key: int) -> tuple[tuple[int, int], int]:
        return self.reg.get(key, ((0, 0), 0))

    def _adopt(self, key: int, tag: tuple[int, int], val: int) -> None:
        if tag > self._get(key)[0]:
            self.reg[key] = (tag, val)

    def process(self, m: RMsg) -> None:
        if m.kind in ("vi", "hba"):
            return   # ABD needs no fencing: the quorum threshold is fixed
                     # over the original n, so intersection holds across
                     # view changes without epochs or leases
        reply = {"src": self.node_id}
        if m.kind == "qt":            # write phase 1: tag query
            reply["tag"] = self._get(m.key)[0]
            out = "qtr"
        elif m.kind == "w2":          # write phase 2: tagged write
            self._adopt(m.key, tuple(m.body["tag"]), m.body["val"])
            out = "w2a"
        elif m.kind == "rq":          # read phase 1: tagged read
            tag, val = self._get(m.key)
            reply["tag"], reply["val"] = tag, val
            out = "rqr"
        else:                          # "wb" read phase 2: write-back
            self._adopt(m.key, tuple(m.body["tag"]), m.body["val"])
            out = "wba"
        self.h.send(self.node_id, m.body["cl"],
                    RMsg(out, self.node_id, m.rid, m.key, reply))


class _HarnessClient:
    """Shared client plumbing: op pumping, history logging, and bounded
    retry with capped exponential backoff + seeded jitter.  ``timeout``
    is the backoff base (in steps); a client that exhausts its retry
    budget abandons the op — recorded as a :class:`RetryExhausted` in
    ``harness.client_errors``, with the op left open in the history (the
    checker treats an abandoned write as possibly-applied)."""

    def __init__(self, cid: int, harness: "ReplicationHarness", ops,
                 timeout: int, retry: RetryPolicy | None = None):
        self.node_id = cid
        self.h = harness
        self.ops = list(ops)
        self.timeout = timeout
        self.retry = retry or RetryPolicy(base=float(timeout), mult=2.0,
                                          cap=8.0 * timeout, jitter=0.25,
                                          max_attempts=10)
        self.rng = random.Random((cid * 0x9E3779B1) ^ harness.seed)
        self.idx = 0
        self.inflight: dict | None = None
        self.age = 0.0
        self.attempts = 0
        self._deadline = float(timeout)
        self._rid = cid << 20
        harness.router.register(self)

    def handle_packet(self, msg: RMsg) -> None:
        self.h.enqueue(self, msg)

    @property
    def done(self) -> bool:
        return self.inflight is None and self.idx >= len(self.ops)

    def pump(self) -> None:
        if self.inflight is not None or self.idx >= len(self.ops):
            return
        kind, key, val = self.ops[self.idx]
        self.idx += 1
        self._rid += 1
        self.h.log.invoke(self.node_id, self._rid, kind, key,
                          val if kind == "write" else None)
        self.inflight = {"op": self._rid, "kind": kind, "key": key,
                         "val": val}
        self.age = 0.0
        self.attempts = 0
        self._deadline = self.retry.delay(0, self.rng)
        self._send()

    def on_step(self) -> None:
        if self.inflight is None:
            return
        self.age += 1
        if self.age < self._deadline:
            return
        self.attempts += 1
        if self.attempts >= self.retry.max_attempts:
            self.h.client_errors.append(RetryExhausted(
                self.node_id, self.inflight["op"], self.inflight["kind"],
                self.inflight["key"], self.attempts))
            self.inflight = None
            return
        self.age = 0.0
        self._deadline = self.retry.delay(self.attempts, self.rng)
        self._retry()

    def _finish(self, value=None) -> None:
        self.h.log.respond(self.node_id, self.inflight["op"], value=value)
        self.inflight = None


class ChainClient(_HarnessClient):
    """Chain/CRAQ client: writes to the head, reads round-robin over the
    replicas (CRAQ serves from any); retries are idempotent (same rid)
    and re-target the current view, which is how it rides over a chain
    reconfiguration."""

    def __init__(self, cid, harness, ops, timeout=60):
        super().__init__(cid, harness, ops, timeout)
        self._read_rr = cid  # de-phase the round-robin across clients

    def _send(self) -> None:
        f = self.inflight
        vno, view = self.h.client_view()
        if not view:
            return
        if f["kind"] == "write":
            self.h.send(self.node_id, view[0],
                        RMsg("cw", self.node_id, f["op"], f["key"],
                             {"cl": self.node_id, "val": f["val"],
                              "ep": vno}))
        else:
            if self.h.dirty_read:
                tgt = view[self._read_rr % len(view)]
                self._read_rr += 1
            else:
                tgt = view[-1]  # classic chain: tail-only reads
            self.h.send(self.node_id, tgt,
                        RMsg("cr", self.node_id, f["op"], f["key"],
                             {"cl": self.node_id, "ep": vno}))

    _retry = _send

    def process(self, m: RMsg) -> None:
        f = self.inflight
        if f is None or m.rid != f["op"]:
            return  # stale reply from a retried op
        if m.kind == "fence":
            # Replica rejected our epoch: refresh the view and resend
            # immediately (same rid — idempotent at the head).
            self._send()
        elif m.kind == "cwa" and f["kind"] == "write":
            self._finish()
        elif m.kind == "crr" and f["kind"] == "read":
            self._finish(value=m.body["val"])


class AbdClient(_HarnessClient):
    """ABD client: two-phase writes (tag query at a majority, then tagged
    write to all, complete at a majority) and two-phase reads (tagged
    read at a majority, then write the max tag back to a majority)."""

    def __init__(self, cid, harness, ops, timeout=60):
        super().__init__(cid, harness, ops, timeout)
        self.quorum = len(harness.replicas) // 2 + 1

    def _broadcast(self, kind: str, body: dict) -> None:
        # Target the *detected* membership, not the full replica set:
        # nodes the detector has declared dead get no traffic.  The
        # quorum threshold stays over the original n, so this is safe —
        # a false `dead` verdict only costs availability, never quorum
        # intersection.
        f = self.inflight
        _, members = self.h.client_view()
        for n in members:
            self.h.send(self.node_id, n,
                        RMsg(kind, self.node_id, f["op"], f["key"],
                             {"cl": self.node_id, **body}))

    def _send(self) -> None:
        f = self.inflight
        f["phase"] = 1
        f["got"] = {}
        f["acks"] = set()
        self._broadcast("qt" if f["kind"] == "write" else "rq", {})

    def _retry(self) -> None:
        f = self.inflight
        if f["phase"] == 1:
            self._broadcast("qt" if f["kind"] == "write" else "rq", {})
        elif f["kind"] == "write":
            self._broadcast("w2", {"tag": f["tag"], "val": f["val"]})
        else:
            self._broadcast("wb", {"tag": f["tag"], "val": f["wbval"]})

    def process(self, m: RMsg) -> None:
        f = self.inflight
        if f is None or m.rid != f["op"]:
            return
        if m.kind in ("qtr", "rqr") and f["phase"] == 1:
            f["got"][m.body["src"]] = m.body
            if len(f["got"]) < self.quorum:
                return
            f["phase"] = 2
            if f["kind"] == "write":
                maxseq = max(tuple(b["tag"])[0] for b in f["got"].values())
                f["tag"] = (maxseq + 1, self.node_id)
                self._broadcast("w2", {"tag": f["tag"], "val": f["val"]})
            else:
                best = max(f["got"].values(),
                           key=lambda b: tuple(b["tag"]))
                f["tag"] = tuple(best["tag"])
                f["wbval"] = best["val"]
                self._broadcast("wb", {"tag": f["tag"],
                                       "val": f["wbval"]})
        elif m.kind in ("w2a", "wba") and f["phase"] == 2:
            f["acks"].add(m.body["src"])
            if len(f["acks"]) >= self.quorum:
                self._finish(value=None if f["kind"] == "write"
                             else f["wbval"])


class _VMNode:
    """View-manager pseudo-node (id 0): the monitor every replica
    heartbeats to.  Heartbeats ride the same seeded delivery queue as
    protocol messages, so detection latency is subject to the same
    reordering/loss/partition effects as data traffic.  Each heartbeat
    is answered with an ``hba`` carrying the current view number,
    members, and the sender's renewed lease — the only channel through
    which replicas learn membership."""

    node_id = 0

    def __init__(self, harness: "ReplicationHarness"):
        self.h = harness
        harness.router.register(self)

    def handle_packet(self, msg: RMsg) -> None:
        self.h.enqueue(self, msg)

    def process(self, m: RMsg) -> None:
        if m.kind != "hb":
            return
        views = self.h.views
        views.record_heartbeat(m.src, float(self.h.steps))
        self.h.send(0, m.src,
                    RMsg("hba", 0, 0, 0,
                         {"no": views.view.number,
                          "members": list(views.view.members),
                          "lease": views.lease_until.get(m.src, 0.0)}))


#: message kinds that are control traffic (membership/fencing), allowed
#: to remain in flight when the run terminates
_CTRL_KINDS = frozenset(("hb", "hba", "vi", "fence"))


class ReplicationHarness:
    """Seeded concurrent executor for the consistency protocols.

    Replica/client ``handle_packet`` calls enqueue; :meth:`step` delivers
    one pending message chosen by a seeded weighted draw (weights are the
    inverse of the destination's straggler factor), so operations overlap
    genuinely and every run is reproducible from its seed.  Fault axes
    mirror the timed plane's :class:`repro_torch.policy.FailureModel`: ``loss``
    (seeded per-destination drops via :class:`Router`), ``slow``
    (delivery de-prioritization), ``crashes`` — ``(step, node)`` pairs
    that blackhole the node — plus ``partitions`` (step-windowed group
    cuts) and ``flaps`` (gray failure: a node unreachable for a duty
    fraction of every period).

    No production path learns of a failure from the schedule: a crash
    only blackholes the router.  Everything downstream — suspicion,
    the ``dead`` verdict, lease expiry, and the successor view — flows
    through the heartbeat/:class:`ViewManager` machinery (``_VMNode``),
    and replicas/clients act only on views they were *told* about.

    Unfinished operations stay open in the history; the checker treats
    pending writes as possibly-applied and drops pending reads.  Clients
    that exhaust their retry budget land in ``client_errors``."""

    def __init__(self, kind: str, k: int, *, seed: int = 0,
                 dirty_read: bool = True, tail_bump: bool = True,
                 loss: dict[int, float] | None = None,
                 slow: dict[int, float] | None = None,
                 crashes: tuple[tuple[int, int], ...] = (),
                 partitions: tuple[tuple[int, int, tuple[int, ...]], ...] = (),
                 flaps: tuple[tuple[int, int, float], ...] = (),
                 membership: MembershipConfig | None = None,
                 timeout: int = 60, max_steps: int = 200_000):
        if kind not in ("chain", "abd"):
            raise ValueError(f"unknown consistency kind {kind!r}")
        self.kind = kind
        self.dirty_read = dirty_read
        self.timeout = timeout
        self.max_steps = max_steps
        self.seed = seed
        self.router = Router()
        self.router.set_loss(loss, seed)
        self.router.unreachable = self._unreachable
        self.rng = random.Random(seed ^ 0x5BD1E995)
        self.log = HistoryLog()
        self.slow = dict(slow or {})
        self.crashes = sorted(crashes)
        self.partitions = tuple((int(s), int(e), tuple(grp))
                                for s, e, grp in partitions)
        self.flaps = {int(n): (int(p), float(d)) for n, p, d in flaps}
        # Membership state must exist before replicas: each replica's
        # initial view/lease comes from the ViewManager's bootstrap.
        self.membership = membership or MembershipConfig(
            interval=10.0, suspect_after=3.0, dead_after=6.0)
        self.views = ViewManager(range(1, k + 1), self.membership, now=0.0)
        self.views.on_change.append(self._install_view)
        self.hb_every = max(1, int(self.membership.interval))
        self.fenced = 0
        self.client_errors: list[RetryExhausted] = []
        self.steps = 0
        self.pending: list[tuple[object, RMsg]] = []
        self._vm = _VMNode(self)
        if kind == "chain":
            self.replicas = {n: ChainReplica(n, self, tail_bump=tail_bump)
                             for n in self.views.view.members}
        else:
            self.replicas = {n: AbdReplica(n, self)
                             for n in self.views.view.members}
        self.clients: list[_HarnessClient] = []

    @property
    def view(self) -> list[int]:
        """The view service's current membership (chain order)."""
        return list(self.views.view.members)

    def client_view(self) -> tuple[int, list[int]]:
        """What a client knows: the latest installed view.  Modeled as a
        read against the view service (clients refresh on every send and
        on ``fence`` replies), so it is authoritative-at-send-time."""
        v = self.views.view
        return v.number, list(v.members)

    def _unreachable(self, src: int, dst: int) -> bool:
        s = self.steps
        for start, end, grp in self.partitions:
            if start <= s < end and ((src in grp) != (dst in grp)):
                return True
        for n in (src, dst):
            f = self.flaps.get(n)
            if f is not None and (s % f[0]) < f[1] * f[0]:
                return True
        return False

    def _install_view(self, view) -> None:
        """A new view activated: push ``vi`` installs to its members
        (best-effort — the periodic ``hba`` grants re-deliver the view
        to anyone who misses the install)."""
        for n in view.members:
            self.send(0, n,
                      RMsg("vi", 0, 0, 0,
                           {"no": view.number,
                            "members": list(view.members),
                            "lease": self.views.lease_until.get(n, 0.0)}))

    @classmethod
    def from_spec(cls, spec, **kw) -> "ReplicationHarness":
        """Build the harness from a :class:`repro_torch.policy.PolicySpec` via
        its functional lowering (:func:`repro_torch.policy.functional.
        consistency_plan`)."""
        from repro_torch.policy.functional import consistency_plan

        plan = consistency_plan(spec)
        if plan.kind == "chain":
            kw.setdefault("dirty_read", plan.dirty_read)
        return cls(plan.kind, plan.k, **kw)

    def add_client(self, ops) -> _HarnessClient:
        cid = 101 + len(self.clients)
        cls = ChainClient if self.kind == "chain" else AbdClient
        c = cls(cid, self, ops, timeout=self.timeout)
        self.clients.append(c)
        return c

    def send(self, src: int, dst: int, msg: RMsg) -> None:
        self.router.send(dst, msg, src=src)

    def enqueue(self, node, msg: RMsg) -> None:
        self.pending.append((node, msg))

    def step(self) -> None:
        weights = [1.0 / self.slow.get(n.node_id, 1.0)
                   for n, _ in self.pending]
        i = self.rng.choices(range(len(self.pending)), weights=weights)[0]
        node, msg = self.pending.pop(i)
        if node.node_id in self.router.failed:
            self.router.packets_dropped += 1
            return
        node.process(msg)

    def crash(self, node_id: int) -> None:
        """Crash = the node goes silent.  Nothing else: its heartbeats
        stop, the detector suspects it, the lease runs out, and the view
        service announces the successor view.  (The pre-membership
        harness reconfigured the chain here, omnisciently.)"""
        self.router.fail(node_id)

    def _drained(self) -> bool:
        """Done when every client finished (or gave up) and the only
        in-flight messages are control traffic (heartbeats keep flowing
        as long as the cluster lives)."""
        return (all(c.done for c in self.clients)
                and all(m.kind in _CTRL_KINDS for _, m in self.pending))

    def run(self) -> HistoryLog:
        while self.steps < self.max_steps:
            while self.crashes and self.crashes[0][0] <= self.steps:
                self.crash(self.crashes.pop(0)[1])
            if self.steps % self.hb_every == 0:
                # Live replicas emit their periodic heartbeat toward the
                # monitor; crashed nodes are silent — that silence *is*
                # the failure signal.
                for n in self.replicas:
                    if n not in self.router.failed:
                        self.send(n, 0, RMsg("hb", n, 0, 0, {}))
            self.views.poll(float(self.steps))
            for c in self.clients:
                c.pump()
            if self._drained():
                break
            self.steps += 1
            if self.pending:
                self.step()
            # an empty queue is NOT a retry signal: clients cannot see
            # it (that would be omniscience) — they age toward their own
            # backoff deadline while the step clock keeps advancing
            for c in self.clients:
                c.on_step()
        return self.log


# ---------------------------------------------------------------------------
# Client
# ---------------------------------------------------------------------------


class DFSClient:
    """Issues authenticated writes with replication / EC policies."""

    def __init__(self, client_id: int, router: Router, mtu: int = DEFAULT_MTU):
        self.client_id = client_id
        self.router = router
        self.mtu = mtu
        self._next_greq = client_id << 32

    def _greq(self) -> int:
        self._next_greq += 1
        return self._next_greq

    def write(
        self,
        capability,
        data: np.ndarray,
        targets: list[ReplicaCoord],
        resiliency: Resiliency = Resiliency.NONE,
        strategy: ReplStrategy = ReplStrategy.RING,
        ec_m: int = 0,
        parity_targets: list[ReplicaCoord] | None = None,
    ) -> list[int]:
        """Issue a write; returns the greq ids used (1 for raw/replicated,
        k for erasure-coded stripes).  Acks land in router.client_acks."""
        data = np.asarray(data, dtype=np.uint8).ravel()
        if resiliency in (Resiliency.NONE, Resiliency.REPLICATION):
            greq = self._greq()
            dfs = DFSHeader(OpType.WRITE, greq, self.client_id, capability)
            wrh = WriteRequestHeader(
                addr=targets[0].addr,
                size=int(data.size),
                resiliency=resiliency,
                strategy=strategy,
                virtual_rank=0,
                replicas=tuple(targets) if resiliency == Resiliency.REPLICATION else (),
            )
            for pkt in packetize_write(dfs, wrh, data, self.mtu):
                self.router.send(targets[0].node, pkt)
            return [greq]
        # Erasure coding: split into k chunks, one write per data node,
        # packets interleaved across chunks (section VI-B1).
        assert resiliency == Resiliency.ERASURE_CODING
        k = len(targets)
        assert parity_targets is not None and len(parity_targets) == ec_m
        chunks = erasure.split_stripe(data, k)
        stripe_id = self._greq() & 0xFFFFFFFF  # shared 32-bit stripe id
        greqs = [stripe_id]  # parity acks carry the stripe id
        pkt_streams = []
        for j in range(k):
            greq = self._greq()
            greqs.append(greq)
            dfs = DFSHeader(OpType.WRITE, greq, self.client_id, capability)
            wrh = WriteRequestHeader(
                addr=targets[j].addr,
                size=int(chunks.shape[1]),
                resiliency=Resiliency.ERASURE_CODING,
                ec_k=k,
                ec_m=ec_m,
                ec_index=j,
                replicas=tuple(parity_targets),
                seq=stripe_id,
            )
            pkt_streams.append(
                packetize_write(dfs, wrh, chunks[j], self.mtu)
            )
        # Interleave: seq 0 of every chunk, then seq 1, ... (Fig. 14).
        max_len = max(len(s) for s in pkt_streams)
        for i in range(max_len):
            for j in range(k):
                if i < len(pkt_streams[j]):
                    self.router.send(targets[j].node, pkt_streams[j][i])
        return greqs

    def write_spec(
        self,
        capability,
        data: np.ndarray,
        spec,
        targets: list[ReplicaCoord],
        parity_targets: list[ReplicaCoord] | None = None,
    ) -> list[int]:
        """Issue a write under a declarative :class:`repro_torch.policy.PolicySpec`
        (the spec's stages are lowered by ``repro_torch.policy.functional``)."""
        from repro_torch.policy.functional import write_plan

        plan = write_plan(spec)
        if plan.kind == "flat":
            greqs: list[int] = []
            for t in targets[: plan.k]:
                greqs += self.write(capability, data, [t])
            return greqs
        if plan.kind == "tree":
            return self.write(
                capability, data, targets,
                resiliency=Resiliency.REPLICATION, strategy=plan.strategy,
            )
        if plan.kind == "ec-nic":
            return self.write(
                capability, data, targets,
                resiliency=Resiliency.ERASURE_CODING, ec_m=plan.m,
                parity_targets=parity_targets,
            )
        if plan.kind == "ec-client":
            raise ValueError(
                "ec-client plans batch-encode on the host; use "
                "StorageCluster.write_object_bulk, not the packet client"
            )
        return self.write(capability, data, targets[:1])

    def read(self, capability, coord: ReplicaCoord, size: int) -> np.ndarray:
        """Authenticated read: READ request up, READ_RESP packets streamed
        back by the node's read pipeline.  Returns the bytes; raises
        :class:`IOError` on NACK or short data."""
        greq = self._greq()
        dfs = DFSHeader(OpType.READ, greq, self.client_id, capability)
        rrh = ReadRequestHeader(addr=coord.addr, size=size)
        req = Packet(
            greq_id=greq,
            pkt_index=0,
            is_header=True,
            is_completion=True,
            dfs=dfs,
            wrh=None,
            rrh=rrh,
            payload=np.zeros(0, dtype=np.uint8),
            payload_offset=0,
            wire_size=RDMA_HEADER_SIZE + DFSHeader.packed_size()
            + rrh.packed_size(),
        )
        inbox = self.router.client_acks[self.client_id]
        before = len(inbox)
        self.router.send(coord.node, req)
        resps = inbox[before:]
        del inbox[before:]  # reads are consumed; acks() stays write-centric
        if any(p.ctrl == OpType.NACK and p.greq_id == greq for p in resps):
            raise IOError(f"read {greq}: denied (NACK)")
        out = np.zeros(size, dtype=np.uint8)
        got = 0
        for p in resps:
            if p.ctrl != OpType.READ_RESP or p.greq_id != greq:
                continue
            out[p.payload_offset : p.payload_offset + p.payload_size] = p.payload
            got += p.payload_size
        if got != size:
            raise IOError(f"read {greq}: got {got}/{size} bytes")
        return out

    def acks(self) -> list[Packet]:
        return self.router.client_acks[self.client_id]
