"""Checkpoint storage cluster: DFS storage nodes + metadata service.

This instantiates the paper's architecture for the training framework:
a set of storage nodes whose "NICs" run the policy engine
(``repro_torch.core.handlers``), a metadata service that owns the object
namespace and issues capabilities, and a client used by the checkpoint
manager.  Storage is byte-addressable memory per node (optionally spilled
to disk files), the paper's NVMM assumption.

The metadata service implements the control plane the paper leaves
abstract: object -> (layout, policy) mapping, extent allocation, and
capability issuance (section II: clients query metadata, then talk to
storage nodes directly).

The port's cluster owns a ``device``: the batched client-side EC of
:meth:`StorageCluster.write_object_bulk` and the degraded
:meth:`StorageCluster.read_objects` encode, decode and verify there
(``"cuda"`` by default, which raises without a GPU; ``"cpu"`` runs the
kernels' plain PyTorch versions).  Its state crosses from a ``repro``
cluster as plain numpy arrays and values (:meth:`StorageCluster.to_state`,
:meth:`StorageCluster.from_state`).
"""

from __future__ import annotations

import dataclasses
import functools
import os
import secrets
import threading
import time

import numpy as np

from repro_torch import DEFAULT_DEVICE
from repro_torch.core.auth import CapabilityAuthority, Rights
from repro_torch.core.handlers import DFSClient, DFSNode, Router
from repro_torch.core.packets import (
    RDMA_HEADER_SIZE, OpType, ReplicaCoord, ReplStrategy, Resiliency,
)
from repro_torch.namenode.placement import PlacementPolicy, RoundRobinPlacement
from repro_torch.policy.functional import write_plan
from repro_torch.trace.host import span


@dataclasses.dataclass
class ObjectLayout:
    """Where one object lives: data/parity extents on storage nodes."""

    object_id: int
    size: int
    resiliency: Resiliency
    strategy: ReplStrategy
    data_coords: list[ReplicaCoord]
    parity_coords: list[ReplicaCoord]
    ec_k: int = 0
    ec_m: int = 0
    chunk_len: int = 0  # per-node chunk length (EC) or full size (repl)
    #: set by repair when the object exceeded its loss tolerance: reads
    #: raise and the audit ledger pins the bytes as lost — re-provisioned
    #: nodes must not resurrect zeroed shards as "readable"
    lost: bool = False


class _SpannedAuthority(CapabilityAuthority):
    """The cluster's authority: the nodes' header handlers run its
    capability check inside a ``pp.auth`` host span."""

    def verify(self, cap, **kwargs) -> bool:
        with span("pp.auth") as s:
            ok = super().verify(cap, **kwargs)
            s.set(ok=ok)
        return ok


class _SpannedClient(DFSClient):
    """The cluster's packet client: each write call (packetize, delivery,
    the nodes' handlers, the ack) inside a ``pp.write`` host span, each read
    call (request, the node's read handler, the READ_RESP stream,
    reassembly) inside a ``pp.read``, with the packets and bytes each
    carried."""

    def write(self, capability, data, targets, *args, **kwargs) -> list[int]:
        before = self.router.packets_delivered
        with span("pp.write") as s:
            greqs = super().write(capability, data, targets, *args, **kwargs)
            if s:
                s.set(packets=self.router.packets_delivered - before,
                      bytes=int(np.asarray(data, np.uint8).size))
        return greqs

    def read(self, capability, coord: ReplicaCoord, size: int) -> np.ndarray:
        before = self.router.packets_delivered
        with span("pp.read") as s:
            out = super().read(capability, coord, size)
            if s:
                per_packet = self.router.nodes[coord.node].mtu - RDMA_HEADER_SIZE
                responses = max(1, -(-size // per_packet))
                s.set(packets=self.router.packets_delivered - before + responses,
                      bytes=int(size))
        return out


class MetadataService:
    """Control plane: namespace, extent allocation, capabilities."""

    def __init__(self, num_nodes: int, node_capacity: int,
                 key: bytes | None = None,
                 placement: PlacementPolicy | None = None):
        self.authority = _SpannedAuthority(key or secrets.token_bytes(16))
        self.num_nodes = num_nodes
        self.node_capacity = node_capacity
        self._alloc = [0] * num_nodes  # bump allocator per node
        self._objects: dict[int, ObjectLayout] = {}
        self._next_oid = 1
        #: pluggable placement (repro_torch.namenode.placement) — replaces the
        #: old private ``_rr`` cursor, whose scan-count advance skewed
        #: load onto the node after a failed one
        self.placement = placement or RoundRobinPlacement(num_nodes)
        #: nodes excluded from new placements (StorageCluster aliases its
        #: ``failed`` set here, so crashes steer future writes away)
        self.unavailable: set[int] = set()
        #: *detected*-dead exclusions (the NameNode's view changes land
        #: here): kept apart from ``unavailable`` so detection never
        #: mutates the fault injector's omniscient ``failed`` set
        self.suspected: set[int] = set()

    def _place(self, n: int) -> list[int]:
        return self.placement.place(n, self.unavailable | self.suspected)

    def _extent(self, node: int, size: int) -> int:
        addr = self._alloc[node]
        if addr + size > self.node_capacity:
            raise RuntimeError(f"storage node {node} full")
        self._alloc[node] = addr + size
        self.placement.record(node, size)
        return addr

    def create_object(
        self,
        size: int,
        resiliency: Resiliency,
        k: int,
        m: int = 0,
        strategy: ReplStrategy = ReplStrategy.RING,
    ) -> ObjectLayout:
        oid = self._next_oid
        self._next_oid += 1
        if resiliency == Resiliency.ERASURE_CODING:
            chunk = -(-size // k)
            chunk = -(-chunk // 32) * 32  # stripe alignment
            nodes = self._place(k + m)
            data = [ReplicaCoord(n, self._extent(n, chunk)) for n in nodes[:k]]
            par = [ReplicaCoord(n, self._extent(n, chunk)) for n in nodes[k:]]
            layout = ObjectLayout(oid, size, resiliency, strategy, data, par,
                                  ec_k=k, ec_m=m, chunk_len=chunk)
        elif resiliency == Resiliency.REPLICATION:
            nodes = self._place(k)
            data = [ReplicaCoord(n, self._extent(n, size)) for n in nodes]
            layout = ObjectLayout(oid, size, resiliency, strategy, data, [],
                                  chunk_len=size)
        else:
            node = self._place(1)
            data = [ReplicaCoord(node[0], self._extent(node[0], size))]
            layout = ObjectLayout(oid, size, resiliency, strategy, data, [],
                                  chunk_len=size)
        self._objects[oid] = layout
        return layout

    def lookup(self, oid: int) -> ObjectLayout:
        return self._objects[oid]

    def issue_capability(
        self, client_id: int, rights: int = Rights.WRITE | Rights.READ,
        ttl_s: int = 3600,
    ):
        # Extent-wide capability: per-object capabilities are issued by
        # narrowing offset/length (see CheckpointManager).
        return self.authority.issue(
            client_id=client_id,
            object_id=0,
            offset=0,
            length=self.node_capacity,
            rights=rights,
            expiry=int(time.time()) + ttl_s,
        )


def _io_locked(fn):
    """Serialize a packet-plane method on the cluster's I/O lock."""

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        with self._io_lock:
            return fn(self, *args, **kwargs)

    return wrapper


class StorageCluster:
    """N policy-enforcing storage nodes + a metadata service + a client."""

    def __init__(
        self,
        num_nodes: int,
        node_capacity: int = 1 << 26,
        client_id: int = 1,
        spill_dir: str | None = None,
        placement: PlacementPolicy | None = None,
        device=DEFAULT_DEVICE,
    ):
        from repro_torch.kernels.ops import resolve_device

        #: where the bulk EC path encodes, decodes and verifies
        self.device = resolve_device(device)
        self.router = Router()
        self.meta = MetadataService(num_nodes, node_capacity,
                                    placement=placement)
        self.nodes = [
            DFSNode(i, self.router, self.meta.authority,
                    storage_size=node_capacity)
            for i in range(num_nodes)
        ]
        self.client = _SpannedClient(client_id, self.router)
        self.client_id = client_id
        self.capability = self.meta.issue_capability(client_id)
        self.spill_dir = spill_dir
        self.num_nodes = num_nodes
        self.node_capacity = node_capacity
        self.failed: set[int] = set()
        # the metadata service places new extents on live nodes only
        self.meta.unavailable = self.failed
        # serializes packet-plane operations (reads/writes/repair): the
        # Router is synchronous and not thread-safe, and background
        # repair / async checkpoint saves run on their own threads
        self._io_lock = threading.RLock()
        #: bounded retry budget for shard reads under packet loss: a
        #: lossy link (see :meth:`set_failures`) drops read requests /
        #: responses, and each failed attempt is retried up to this many
        #: times before the shard is treated as missing (degraded-read
        #: reconstruction takes over).  Counted in the audit ledger.
        self.max_read_retries = 3
        self.read_retries = 0      # extra attempts that were needed
        self.read_timeouts = 0     # shards given up on after the budget

    # -- data plane -----------------------------------------------------------

    @_io_locked
    def write_object(
        self,
        data: bytes | np.ndarray,
        resiliency: Resiliency = Resiliency.ERASURE_CODING,
        k: int = 4,
        m: int = 2,
        strategy: ReplStrategy = ReplStrategy.RING,
        spec=None,
    ) -> ObjectLayout:
        """Write one object.  ``spec`` (a :class:`repro_torch.policy.PolicySpec`)
        overrides the positional policy knobs; an ``RS(engine='client')``
        spec routes through the batched host encode
        (:meth:`write_object_bulk`)."""
        if spec is not None:
            plan = write_plan(spec)
            if plan.kind == "ec-client":
                return self.write_object_bulk([data], k=plan.k, m=plan.m)[0]
            if plan.kind == "flat":
                raise NotImplementedError(
                    "Flat replication has no object layout; use a Tree spec"
                )
            resiliency, strategy = plan.resiliency, plan.strategy
            k, m = plan.k, plan.m
        blob = np.frombuffer(bytes(data), np.uint8) if isinstance(
            data, (bytes, bytearray)) else np.asarray(data, np.uint8).ravel()
        layout = self.meta.create_object(
            int(blob.size), resiliency, k, m, strategy
        )
        try:
            self._write_object_shards(layout, blob, resiliency, m, strategy)
        except IOError:
            # a placed node crashed between allocation and the write: drop
            # the dead layout, re-place on live nodes, retry once
            del self.meta._objects[layout.object_id]
            layout = self.meta.create_object(
                int(blob.size), resiliency, k, m, strategy
            )
            self._write_object_shards(layout, blob, resiliency, m, strategy)
        return layout

    def _write_object_shards(
        self,
        layout: ObjectLayout,
        blob: np.ndarray,
        resiliency: Resiliency,
        m: int,
        strategy: ReplStrategy,
    ) -> None:
        before = len(self.client.acks())
        if resiliency == Resiliency.ERASURE_CODING:
            self.client.write(
                self.capability, blob, list(layout.data_coords),
                resiliency=resiliency, ec_m=m,
                parity_targets=list(layout.parity_coords),
            )
            expect = layout.ec_k + layout.ec_m
        else:
            self.client.write(
                self.capability, blob, list(layout.data_coords),
                resiliency=resiliency, strategy=strategy,
            )
            expect = 1
        self._check_acks(layout, before, expect)

    def _check_acks(self, layout: ObjectLayout, before: int, expect: int) -> None:
        acks = self.client.acks()[before:]
        good = [a for a in acks if a.ctrl == OpType.WRITE_ACK]
        if len(good) < expect:
            raise IOError(
                f"object {layout.object_id}: {len(good)}/{expect} acks "
                f"(NACK or loss)"
            )

    @_io_locked
    def write_object_bulk(
        self,
        blobs: list[bytes | np.ndarray],
        k: int = 4,
        m: int = 2,
        backend: str = "torch",
    ) -> list[ObjectLayout]:
        """Batched client-side EC — the ``RS(engine='client')`` plan.

        All same-geometry stripes are encoded in *one*
        ``RSCode.encode_stripes`` call (backend="torch" is a single kernel
        launch per chunk-length group on the cluster's device), then every
        data/parity shard is written as an authenticated plain write
        through the policy engine."""
        from repro_torch.core.erasure import RSCode, split_stripe

        arrs = [
            np.frombuffer(bytes(b), np.uint8)
            if isinstance(b, (bytes, bytearray))
            else np.asarray(b, np.uint8).ravel()
            for b in blobs
        ]
        layouts = [
            self.meta.create_object(
                int(a.size), Resiliency.ERASURE_CODING, k, m,
                ReplStrategy.RING,
            )
            for a in arrs
        ]
        # Group stripes by chunk length -> one batched encode each.
        chunks_list: list[np.ndarray] = []
        groups: dict[int, list[int]] = {}
        for idx, (a, lay) in enumerate(zip(arrs, layouts)):
            chunks = split_stripe(a, k)
            assert chunks.shape[1] == lay.chunk_len, (
                chunks.shape, lay.chunk_len)
            chunks_list.append(chunks)
            groups.setdefault(chunks.shape[1], []).append(idx)
        code = RSCode(k, m)
        parities: dict[int, np.ndarray] = {}
        for length, idxs in groups.items():
            if length == 0:
                for i in idxs:
                    parities[i] = np.zeros((m, 0), np.uint8)
                continue
            batch = np.stack([chunks_list[i] for i in idxs])   # (S, k, L)
            par = code.encode_stripes(batch, backend=backend,
                                      device=self.device)  # (S, m, L)
            for s, i in enumerate(idxs):
                parities[i] = par[s]
        for i, lay in enumerate(layouts):
            try:
                self._write_bulk_shards(lay, chunks_list[i], parities[i])
            except IOError:
                # mid-batch crash of a placed node: re-place this object on
                # live nodes (same size -> same chunk length) and retry once
                del self.meta._objects[lay.object_id]
                lay = self.meta.create_object(
                    lay.size, Resiliency.ERASURE_CODING, k, m,
                    ReplStrategy.RING,
                )
                assert lay.chunk_len == chunks_list[i].shape[1]
                layouts[i] = lay
                self._write_bulk_shards(lay, chunks_list[i], parities[i])
        return layouts

    def _write_bulk_shards(
        self, lay: ObjectLayout, chunks: np.ndarray, parity: np.ndarray
    ) -> None:
        before = len(self.client.acks())
        for j, coord in enumerate(lay.data_coords):
            self.client.write(self.capability, chunks[j], [coord])
        for pi, coord in enumerate(lay.parity_coords):
            self.client.write(self.capability, parity[pi], [coord])
        self._check_acks(lay, before, lay.ec_k + lay.ec_m)

    def set_failures(self, failures) -> None:
        """Attach a :class:`repro_torch.policy.FailureModel` to the functional
        plane: crashed nodes are failed at the router (blackholed until
        repaired), lossy nodes drop packets towards them with the model's
        seeded probabilities.  Loss applies to *all* traffic towards the
        node; reads carry their own bounded retry budget
        (``max_read_retries``), writes surface missing acks as
        :class:`IOError` at the caller."""
        for node in failures.crashed:
            self.fail_node(node)
        self.router.set_loss(failures.loss_map, failures.seed)

    def _read_shard(self, coord: ReplicaCoord, length: int) -> np.ndarray | None:
        """One shard through the authenticated packet read path; ``None``
        when the node is failed/unreachable (the read is blackholed) or
        still unreadable after the bounded retry budget (a lossy link
        dropped every attempt — the functional-plane "timeout").

        Retries are deliberately *bounded*: an endlessly-retrying client
        would hide a dead node as latency; after ``max_read_retries``
        extra attempts the shard is reported missing and the caller's
        degraded-read path reconstructs instead."""
        if coord.node in self.failed:
            return None
        for attempt in range(1 + self.max_read_retries):
            if attempt > 0:
                self.read_retries += 1
            try:
                return self.client.read(self.capability, coord, length)
            except IOError:
                continue
        self.read_timeouts += 1
        return None

    def read_object(self, layout: ObjectLayout, verify: bool = True) -> bytes:
        """Read one object (degraded-mode capable); see
        :meth:`read_objects`."""
        return self.read_objects([layout], verify=verify)[0]

    @_io_locked
    def read_objects(
        self,
        layouts: list[ObjectLayout],
        verify: bool = True,
        backend: str = "torch",
    ) -> list[bytes]:
        """Batched degraded-capable read through the packet plane.

        Every surviving shard is fetched with an authenticated
        ``DFSClient.read`` (failed nodes blackhole, so missing shards are
        *observed*, not assumed).  EC objects with missing shards are
        reconstructed by ``RSCode.decode_stripes`` — all stripes sharing
        (geometry, chunk length, erasure pattern) go through ONE batched
        decode call (the common whole-node-failure case) on the cluster's
        device.  With
        ``verify`` (default), recovered stripes are re-encoded and
        checked bit-exact against every surviving parity shard before
        the bytes are returned.  Replicated objects fail over to the
        first surviving replica.
        """
        from repro_torch.core.erasure import RSCode

        out: list[bytes | None] = [None] * len(layouts)
        # (k, m, chunk_len, missing-pattern) -> [(pos, shards)]
        groups: dict[tuple, list[tuple[int, list]]] = {}
        for pos, layout in enumerate(layouts):
            if layout.lost:
                raise IOError(
                    f"object {layout.object_id}: lost (exceeded its loss "
                    f"tolerance; repair could not reconstruct it)"
                )
            if layout.resiliency == Resiliency.ERASURE_CODING:
                chunk = layout.chunk_len
                data_shards = [self._read_shard(c, chunk)
                               for c in layout.data_coords]
                if all(s is not None for s in data_shards):
                    # healthy fast path: k data reads, no parity traffic,
                    # no decode
                    out[pos] = np.concatenate(
                        data_shards)[: layout.size].tobytes()
                    continue
                # degraded: fetch parity lazily, group by erasure pattern
                shards = data_shards + [self._read_shard(c, chunk)
                                        for c in layout.parity_coords]
                pattern = tuple(i for i, s in enumerate(shards) if s is None)
                key = (layout.ec_k, layout.ec_m, chunk, pattern)
                groups.setdefault(key, []).append((pos, shards))
            elif layout.resiliency == Resiliency.REPLICATION:
                for coord in layout.data_coords:
                    got = self._read_shard(coord, layout.size)
                    if got is not None:
                        out[pos] = got.tobytes()
                        break
                else:
                    raise IOError(
                        f"object {layout.object_id}: all replicas failed")
            else:
                got = self._read_shard(layout.data_coords[0], layout.size)
                if got is None:
                    raise IOError(f"object {layout.object_id}: node failed")
                out[pos] = got.tobytes()
        for (k, m, chunk, pattern), members in groups.items():
            code = RSCode(k, m)
            if chunk == 0:
                for pos, _ in members:
                    out[pos] = b""
                continue
            # one batched decode per (geometry, chunk, erasure pattern)
            try:
                batched, datam = self._decode_shard_group(
                    code, [shards for _, shards in members], pattern, backend,
                    self.device)
            except ValueError as exc:
                # normalize to the method's failure contract (IOError),
                # like every other unreadable-object path
                oids = [layouts[pos].object_id for pos, _ in members]
                raise IOError(f"objects {oids}: {exc}") from exc
            if verify and pattern:
                # recovered stripes must re-encode bit-exact to every
                # surviving parity shard (the encode layout is the truth)
                par = code.encode_stripes(datam, backend=backend,
                                          device=self.device)
                for pi in range(m):
                    slot = k + pi
                    if slot in pattern:
                        continue
                    if not np.array_equal(par[:, pi, :], batched[slot]):
                        oids = [layouts[pos].object_id for pos, _ in members]
                        raise IOError(
                            f"reconstruction mismatch vs parity {pi} for "
                            f"objects {oids} (corrupt shard?)"
                        )
            for s, (pos, _) in enumerate(members):
                layout = layouts[pos]
                out[pos] = datam[s].reshape(-1)[: layout.size].tobytes()
        return out  # type: ignore[return-value]

    # -- failure injection / recovery ------------------------------------------

    def fail_node(self, node_id: int) -> None:
        """Crash a node: its packets are blackholed at the router and
        its shards become unreadable until repaired."""
        self.failed.add(node_id)
        self.router.fail(node_id)

    def heal_node(self, node_id: int) -> None:
        """Re-provision a node in place and rebuild every shard it held
        (thin wrapper over :meth:`repair_node`)."""
        self.repair_node(node_id)

    def repair_node(
        self,
        node_id: int,
        replacement: int | None = None,
        background: bool = False,
        pacer=None,
    ) -> dict | None:
        """Rebuild every shard ``node_id`` held.

        ``replacement=None`` re-provisions the node in place (storage
        wiped, router healed); otherwise new extents are allocated on the
        ``replacement`` node and the object layouts are repointed.  Lost
        EC shards are reconstructed through batched
        ``RSCode.decode_stripes`` / re-encoded with ``encode_stripes``
        (one call per (geometry, chunk, erasure-pattern) group) and
        written back as authenticated plain writes through the policy
        engine.  ``background=True`` runs the rebuild on a repair thread
        (:meth:`repair_wait` joins it); stats land in ``repair_stats``.

        ``pacer`` (a :class:`repro_torch.control.RepairPacer`) throttles the
        rebuild: every rebuilt shard's bytes go through the token
        bucket, so background repair competes with foreground I/O at a
        configured rate instead of flat out — the same governor the
        timed workload engine paces its repair loads with.  The served
        wait lands in ``stats["paced_wait_s"]``.
        """
        # validate on the caller thread so bad arguments raise here, not
        # silently on the repair daemon
        if (replacement is not None and replacement != node_id
                and replacement in self.failed):
            raise ValueError(f"replacement node {replacement} is failed")
        if background:
            self.repair_stats = None
            self._repair_error: BaseException | None = None

            def run() -> None:
                try:
                    self._repair(node_id, replacement, pacer)
                except BaseException as exc:  # surfaced by repair_wait
                    self._repair_error = exc

            self._repair_thread = threading.Thread(target=run, daemon=True)
            self._repair_thread.start()
            return None
        return self._repair(node_id, replacement, pacer)

    def repair_wait(self) -> dict | None:
        """Join a background repair; re-raises its exception (a repair
        that died must not read as a success) and returns its stats."""
        t = getattr(self, "_repair_thread", None)
        if t is not None and t.is_alive():
            t.join()
        err = getattr(self, "_repair_error", None)
        if err is not None:
            self._repair_error = None
            raise err
        return getattr(self, "repair_stats", None)

    def _layout_coords(self, layout: ObjectLayout) -> list[ReplicaCoord]:
        return list(layout.data_coords) + list(layout.parity_coords)

    def _set_coord(self, layout: ObjectLayout, idx: int,
                   coord: ReplicaCoord) -> None:
        if idx < len(layout.data_coords):
            layout.data_coords[idx] = coord
        else:
            layout.parity_coords[idx - len(layout.data_coords)] = coord

    @staticmethod
    def _decode_shard_group(code, shard_lists, pattern, backend="numpy",
                            device=DEFAULT_DEVICE):
        """Stack each slot's per-member shards into an (S, L) batch and
        reconstruct the whole (geometry, chunk, erasure-pattern) group in
        ONE ``decode_stripes`` call.  Returns (batched_slots, (S, k, L))."""
        batched = [
            None if i in pattern
            else np.stack([shards[i] for shards in shard_lists])
            for i in range(code.n)
        ]
        return batched, code.decode_stripes(batched, backend=backend,
                                            device=device)

    def _repair(self, node_id: int, replacement: int | None,
                pacer=None) -> dict:
        """Collect + reconstruct under the I/O lock, then write back one
        shard at a time — with any pacer wait served *outside* the lock,
        so a throttled background rebuild interleaves with foreground
        I/O instead of blocking it for the whole paced duration.

        During the write-back window the target stays in ``failed``:
        foreground reads treat its shards as missing (degraded
        reconstruction returns correct bytes) and placement avoids it —
        only the final lock acquisition marks it live again."""
        in_place = replacement is None or replacement == node_id
        if not in_place and replacement in self.failed:
            raise ValueError(f"replacement node {replacement} is failed")
        with self._io_lock:
            stats, tasks = self._repair_collect(node_id, replacement,
                                                in_place)
        touched: set[int] = set()
        for layout, idx, shard in tasks:
            if pacer is not None:
                stats["paced_wait_s"] += pacer.throttle(int(shard.size))
            with self._io_lock:
                self._write_rebuilt(layout, idx, shard, node_id,
                                    replacement, stats)
            touched.add(id(layout))
        with self._io_lock:
            if in_place:
                # every shard is back: the node may serve reads again
                self.failed.discard(node_id)
            stats["objects"] = len(touched)
            self.repair_stats = stats
        return stats

    def _repair_collect(
        self, node_id: int, replacement: int | None, in_place: bool
    ) -> tuple[dict, list]:
        """Phases 1+2 under the caller's lock: stage every lost shard,
        reconstruct the EC groups batched, re-provision the target.
        Returns (stats, [(layout, slot, rebuilt shard), ...])."""
        from repro_torch.core.erasure import RSCode

        stats = {"objects": 0, "shards": 0, "bytes": 0, "unrecoverable": 0,
                 "paced_wait_s": 0.0}
        # Phase 1 — collect (node_id still failed): every (layout, slot)
        # the dead node held, EC slots grouped by (k, m, chunk, erasure
        # pattern) for batched reconstruction, replication sources staged.
        # Anything unrecoverable is decided NOW, before the node comes
        # back: an in-place re-provision must not resurrect zeroed shards
        # as "readable", so those layouts are pinned lost.
        ec_groups: dict[tuple, list[tuple[ObjectLayout, int, list]]] = {}
        repl_tasks: list[tuple[ObjectLayout, int, np.ndarray]] = []
        for layout in self.meta._objects.values():
            coords = self._layout_coords(layout)
            for idx, coord in enumerate(coords):
                if coord.node != node_id or layout.lost:
                    continue
                if layout.resiliency == Resiliency.ERASURE_CODING:
                    chunk = layout.chunk_len
                    shards = [
                        None if c.node == node_id
                        else self._read_shard(c, chunk)
                        for c in coords
                    ]
                    if sum(s is not None for s in shards) < layout.ec_k:
                        self._mark_unrecoverable(layout, in_place, stats)
                        continue
                    pattern = tuple(
                        i for i, s in enumerate(shards) if s is None)
                    key = (layout.ec_k, layout.ec_m, chunk, pattern)
                    ec_groups.setdefault(key, []).append(
                        (layout, idx, shards))
                elif layout.resiliency == Resiliency.REPLICATION:
                    src = next(
                        (c for c in coords
                         if c.node != node_id and c.node not in self.failed),
                        None,
                    )
                    data = (self._read_shard(src, layout.size)
                            if src is not None else None)
                    if data is None:
                        self._mark_unrecoverable(layout, in_place, stats)
                        continue
                    repl_tasks.append((layout, idx, data))
                else:
                    # the only copy is gone
                    self._mark_unrecoverable(layout, in_place, stats)
        # Phase 2 — re-provision the target: storage wiped and router
        # healed so rebuilt writes land, but the node stays in ``failed``
        # (reads keep reconstructing around it, placement avoids it)
        # until the caller finishes the write-back.
        if in_place:
            self.nodes[node_id].storage.mem[:] = 0
            self.router.heal(node_id)
        # Reconstruct the EC groups batched; the caller writes back.
        tasks: list = list(repl_tasks)
        for (k, m, chunk, pattern), members in ec_groups.items():
            code = RSCode(k, m)
            _, datam = self._decode_shard_group(
                code, [shards for _, _, shards in members], pattern)
            parm = None
            if any(idx >= k for _, idx, _ in members):
                parm = code.encode_stripes(datam, backend="numpy")
            for s, (layout, idx, _) in enumerate(members):
                rebuilt = datam[s, idx] if idx < k else parm[s, idx - k]
                tasks.append((layout, idx, rebuilt))
        return stats, tasks

    @staticmethod
    def _mark_unrecoverable(layout: ObjectLayout, in_place: bool,
                            stats: dict) -> None:
        stats["unrecoverable"] += 1
        if in_place:
            # the zeroed re-provisioned shard must never masquerade as
            # data: the object is explicitly lost (reads raise, audit
            # counts the bytes as lost)
            layout.lost = True

    def _write_rebuilt(
        self,
        layout: ObjectLayout,
        idx: int,
        shard: np.ndarray,
        node_id: int,
        replacement: int | None,
        stats: dict,
    ) -> None:
        """Write one rebuilt shard via an authenticated plain write and
        repoint the layout when repairing onto a replacement node."""
        coord = self._layout_coords(layout)[idx]
        if replacement is not None and replacement != node_id:
            addr = self.meta._extent(replacement, int(shard.size))
            coord = ReplicaCoord(replacement, addr)
            self._set_coord(layout, idx, coord)
        self.client.write(self.capability, shard, [coord])
        stats["shards"] += 1
        stats["bytes"] += int(shard.size)

    # -- per-object re-replication (NameNode block repair) ----------------------

    @_io_locked
    def re_replicate(self, layout: ObjectLayout, from_node: int,
                     to_node: int) -> int:
        """Copy one replica of a replicated object onto ``to_node`` and
        repoint ``from_node``'s slot — the per-block analogue of
        :meth:`repair_node`, driven by *detected* failures: the
        :class:`repro_torch.namenode.BlockReplicator` calls this per
        under-replicated block, so only blocks a view change actually
        touched move (not the whole node's contents).  The bytes come
        from a surviving replica through the authenticated read path;
        the write goes through the policy engine like any client write.
        Returns the bytes copied."""
        if layout.resiliency != Resiliency.REPLICATION:
            raise ValueError(
                f"object {layout.object_id}: re_replicate handles "
                f"replicated objects; EC shards go through repair_node"
            )
        if to_node in self.failed or to_node in self.meta.suspected:
            raise ValueError(f"target node {to_node} is not live")
        idx = next(
            (i for i, c in enumerate(layout.data_coords)
             if c.node == from_node),
            None,
        )
        if idx is None:
            raise ValueError(
                f"object {layout.object_id} has no replica on {from_node}")
        data = None
        for coord in layout.data_coords:
            if coord.node == from_node:
                continue
            data = self._read_shard(coord, layout.size)
            if data is not None:
                break
        if data is None:
            layout.lost = True
            raise IOError(
                f"object {layout.object_id}: no live replica to copy from")
        addr = self.meta._extent(to_node, layout.size)
        coord = ReplicaCoord(to_node, addr)
        self.client.write(self.capability, data, [coord])
        self._set_coord(layout, idx, coord)
        return layout.size

    # -- conservation audit -----------------------------------------------------

    def audit(self) -> dict:
        """Byte-conservation ledger under failure injection: every byte
        written is *readable* (all data shards / a replica live),
        *reconstructable* (EC with <= m shards lost), or *lost* (beyond
        the policy's tolerance) — the three buckets partition
        ``bytes_written`` exactly, so nothing goes silently missing.
        ``read_retries`` / ``read_timeouts`` account the live-loss
        plane: extra shard-read attempts a lossy link forced, and shards
        given up on after the bounded budget."""
        out = {"objects": 0, "bytes_written": 0, "readable_bytes": 0,
               "reconstructable_bytes": 0, "lost_bytes": 0,
               "read_retries": self.read_retries,
               "read_timeouts": self.read_timeouts}
        for layout in self.meta._objects.values():
            out["objects"] += 1
            out["bytes_written"] += layout.size
            if layout.lost:
                # pinned by repair: a re-provisioned node's zeroed shards
                # must never count as readable
                out["lost_bytes"] += layout.size
                continue
            if layout.resiliency == Resiliency.ERASURE_CODING:
                coords = self._layout_coords(layout)
                live = sum(c.node not in self.failed for c in coords)
                data_live = all(
                    c.node not in self.failed for c in layout.data_coords)
                if data_live:
                    out["readable_bytes"] += layout.size
                elif live >= layout.ec_k:
                    out["reconstructable_bytes"] += layout.size
                else:
                    out["lost_bytes"] += layout.size
            else:
                if any(c.node not in self.failed
                       for c in layout.data_coords):
                    out["readable_bytes"] += layout.size
                else:
                    out["lost_bytes"] += layout.size
        assert (out["readable_bytes"] + out["reconstructable_bytes"]
                + out["lost_bytes"]) == out["bytes_written"]
        return out

    def stats(self) -> dict:
        return {
            "nodes": self.num_nodes,
            "failed": sorted(self.failed),
            "bytes_stored": sum(n.storage.bytes_written for n in self.nodes),
            "packets": self.router.packets_delivered,
            "objects": len(self.meta._objects),
        }

    # -- durability: spill node contents + metadata to disk --------------------

    def spill(self, dirname: str | None = None) -> str:
        """Persist every node's storage and the object namespace to disk
        (one file per node + a metadata pickle); survives process restart."""
        import pickle

        d = dirname or self.spill_dir
        if d is None:
            raise ValueError("no spill directory configured")
        os.makedirs(d, exist_ok=True)
        for node in self.nodes:
            node.storage.mem.tofile(os.path.join(d, f"node{node.node_id}.bin"))
        with open(os.path.join(d, "meta.pkl"), "wb") as f:
            pickle.dump(
                {
                    "objects": self.meta._objects,
                    "alloc": self.meta._alloc,
                    "next_oid": self.meta._next_oid,
                    "key": bytes(self.meta.authority.key.tobytes()),
                    "num_nodes": self.num_nodes,
                    "capacity": self.node_capacity,
                },
                f,
            )
        return d

    @classmethod
    def from_spill(cls, dirname: str, client_id: int = 1,
                   device=DEFAULT_DEVICE) -> "StorageCluster":
        """Reconstruct a cluster (nodes + namespace + auth key) from disk."""
        import pickle

        with open(os.path.join(dirname, "meta.pkl"), "rb") as f:
            meta = pickle.load(f)
        cluster = cls(meta["num_nodes"], meta["capacity"], client_id=client_id,
                      spill_dir=dirname, device=device)
        cluster.meta.authority = _SpannedAuthority(meta["key"])
        for node in cluster.nodes:
            node.authority = cluster.meta.authority
            path = os.path.join(dirname, f"node{node.node_id}.bin")
            node.storage.mem[:] = np.fromfile(path, dtype=np.uint8)
        cluster.meta._objects = meta["objects"]
        cluster.meta._alloc = meta["alloc"]
        cluster.meta._next_oid = meta["next_oid"]
        cluster.capability = cluster.meta.issue_capability(client_id)
        return cluster

    # -- state carried across packages: numpy arrays and plain values ----------

    def to_state(self) -> dict:
        """The cluster's state as numpy arrays and plain Python values only:
        ``key``, ``num_nodes``, ``capacity``, ``alloc``, ``next_oid``,
        ``nodes`` (one uint8 array per node) and ``objects`` (one dict per
        :class:`ObjectLayout`, enums as ints, coordinates as (node, addr)).
        Unlike :meth:`spill` it pickles no class, so the state of a
        ``repro`` cluster, read out into the same dict, loads here too."""
        return {
            "key": bytes(self.meta.authority.key.tobytes()),
            "num_nodes": self.num_nodes,
            "capacity": self.node_capacity,
            "alloc": list(self.meta._alloc),
            "next_oid": self.meta._next_oid,
            "nodes": [node.storage.mem.copy() for node in self.nodes],
            "objects": [
                {
                    "object_id": lay.object_id,
                    "size": lay.size,
                    "resiliency": int(lay.resiliency),
                    "strategy": int(lay.strategy),
                    "data_coords": [(c.node, c.addr) for c in lay.data_coords],
                    "parity_coords": [(c.node, c.addr)
                                      for c in lay.parity_coords],
                    "ec_k": lay.ec_k,
                    "ec_m": lay.ec_m,
                    "chunk_len": lay.chunk_len,
                    "lost": lay.lost,
                }
                for lay in self.meta._objects.values()
            ],
        }

    @classmethod
    def from_state(cls, state: dict, client_id: int = 1,
                   device=DEFAULT_DEVICE) -> "StorageCluster":
        """Rebuild a cluster (nodes + namespace + auth key) from
        :meth:`to_state`'s dict."""
        cluster = cls(state["num_nodes"], state["capacity"],
                      client_id=client_id, device=device)
        cluster.meta.authority = _SpannedAuthority(state["key"])
        for node, mem in zip(cluster.nodes, state["nodes"], strict=True):
            node.authority = cluster.meta.authority
            node.storage.mem[:] = np.asarray(mem, dtype=np.uint8)
        cluster.meta._objects = {
            obj["object_id"]: ObjectLayout(
                object_id=obj["object_id"],
                size=obj["size"],
                resiliency=Resiliency(obj["resiliency"]),
                strategy=ReplStrategy(obj["strategy"]),
                data_coords=[ReplicaCoord(n, a) for n, a in obj["data_coords"]],
                parity_coords=[ReplicaCoord(n, a)
                               for n, a in obj["parity_coords"]],
                ec_k=obj["ec_k"],
                ec_m=obj["ec_m"],
                chunk_len=obj["chunk_len"],
                lost=obj["lost"],
            )
            for obj in state["objects"]
        }
        cluster.meta._alloc = list(state["alloc"])
        cluster.meta._next_oid = state["next_oid"]
        cluster.capability = cluster.meta.issue_capability(client_id)
        return cluster
