"""Frozen hand-written protocol simulators (the parity reference).

These are the original per-protocol classes of ``repro_torch.sim.protocols``
(PR 1), moved here verbatim when the declarative :mod:`repro_torch.policy`
pipeline became the production path.  They are kept as the *golden
reference* for the bit-exactness parity suite (tests/test_policy.py):
every ``PolicySpec`` preset compiled by ``repro_torch.policy.timed`` must
report latencies bit-identical to its hand-written predecessor here.

Do not extend these classes — add stages to ``repro_torch.policy`` instead.
Node ids and semantics are documented in ``repro_torch.sim.protocols``.
"""

from __future__ import annotations

from repro_torch.core.packets import ReplStrategy
from repro_torch.core.replication import children_of, optimal_chunk_count
from repro_torch.sim.engine import SerialResource
from repro_torch.sim.network import Network  # noqa: F401  (type reference)
from repro_torch.sim.protocols import (
    ACK_WIRE,
    HYPERLOOP_CONFIG_WIRE,
    INEC_EC_ENGINE_GBPS,
    INEC_PCIE_BW_GBPS,
    INEC_TRIGGER_NS,
    INEC_WINDOW,
    Env,
    Protocol,
    _Pending,
    _chunk_counts,
    _send_message,
    ec_data_ph_ns,
    ec_parity_ph_ns,
    write_header_extra,
)
from repro_torch.sim.pspin import (
    Emit,
    HANDLER_NS,
    HandlerSpec,
    RequestGate,
)

# ---------------------------------------------------------------------------
# Fig. 6 — single-write protocols.
# ---------------------------------------------------------------------------


class RawWriteProtocol(Protocol):
    """Speed-of-light: plain RDMA write, NIC acks after the last packet."""

    name = "raw-write"

    def __init__(self, env: Env, size: int, node: int = 1):
        super().__init__(env)
        self.size = size
        self.request_bytes = size
        self.node = node
        self.storage_nodes = (node,)
        self._got: dict[int, int] = {}
        self._install(node, self._on_storage)

    def _on_storage(self, pkt) -> None:
        rid = pkt.meta["rid"]
        got = self._got.get(rid, 0) + 1
        self._got[rid] = got
        if got == pkt.meta["n"]:
            del self._got[rid]
            cfg, net = self.env.cfg, self.env.net
            client = pkt.meta["cl"]
            self.env.sim.after(
                cfg.nic_fixed_ns,
                lambda: net.send(self.node, client, ACK_WIRE,
                                 {"rid": rid, "ack": 1}),
            )

    def _start(self, pend: _Pending) -> None:
        cfg, net = self.env.cfg, self.env.net
        meta = {"rid": pend.rid, "cl": pend.client}
        self.env.sim.after(
            cfg.client_post_ns,
            lambda: _send_message(
                net, pend.client, self.node, self.size, 0,
                lambda i, n, w: {**meta, "i": i, "n": n},
            ),
        )


class SpinAuthWriteProtocol(Protocol):
    """sPIN write: per-packet handlers validate the request on the NIC."""

    name = "spin-write"

    class _Req:
        __slots__ = ("gate", "processed", "n")

        def __init__(self):
            self.gate = RequestGate()
            self.processed = 0
            self.n: int | None = None

    def __init__(self, env: Env, size: int, node: int = 1):
        super().__init__(env)
        self.size = size
        self.request_bytes = size
        self.node = node
        self.storage_nodes = (node,)
        self.unit = env.pspin(node)
        self._reqs: dict[int, SpinAuthWriteProtocol._Req] = {}
        self._install(node, self._on_storage)

    def _on_storage(self, pkt) -> None:
        hh, ph, ch = HANDLER_NS["auth"]
        rid, client = pkt.meta["rid"], pkt.meta["cl"]
        i = pkt.meta["i"]
        req = self._reqs.setdefault(rid, self._Req())
        req.n = pkt.meta["n"]
        unit = self.unit

        def packet_done() -> None:
            req.processed += 1
            if req.processed == req.n:
                # CH: runs once all packets were processed; sends the
                # response.
                del self._reqs[rid]
                unit.process(
                    ACK_WIRE,
                    HandlerSpec(ch, [Emit(client, ACK_WIRE,
                                          {"rid": rid, "ack": 1})]),
                )

        if i == 0:
            # HH is its own (short) handler invocation; it opens the gate so
            # payload handlers — including the header packet's own PH — can
            # proceed on other HPUs.
            unit.process(pkt.wire_size, HandlerSpec(hh, gate=req.gate))
        spec = HandlerSpec(ph, on_complete=packet_done, gate=req.gate)
        unit.process_gated(pkt.wire_size, spec)

    def _start(self, pend: _Pending) -> None:
        cfg, net = self.env.cfg, self.env.net
        meta = {"rid": pend.rid, "cl": pend.client}
        self.env.sim.after(
            cfg.client_post_ns,
            lambda: _send_message(
                net, pend.client, self.node, self.size, write_header_extra(),
                lambda i, n, w: {**meta, "i": i, "n": n},
            ),
        )


class RpcWriteProtocol(Protocol):
    """RPC: message lands in a host buffer; CPU validates, copies, acks.

    The notify+validate+buffer-copy runs on the storage node's (serial)
    host CPU, so concurrent requests queue for it — the contention the
    paper's CPU data path suffers under load."""

    name = "rpc-write"

    def __init__(self, env: Env, size: int, node: int = 1):
        super().__init__(env)
        self.size = size
        self.request_bytes = size
        self.node = node
        self.storage_nodes = (node,)
        self._got: dict[int, int] = {}
        self._install(node, self._on_storage)

    def _on_storage(self, pkt) -> None:
        rid = pkt.meta["rid"]
        got = self._got.get(rid, 0) + 1
        self._got[rid] = got
        if got == pkt.meta["n"]:
            del self._got[rid]
            cfg, net = self.env.cfg, self.env.net
            client = pkt.meta["cl"]
            cpu = self.env.host_cpu(self.node)
            work = (cfg.host_notify_ns + cfg.cpu_validate_ns
                    + cfg.memcpy_ns(self.size))

            # last packet DMA'd to the host ring: notify, validate, copy, ack
            def at_host() -> None:
                cpu.acquire(
                    work,
                    lambda _s, _e: net.send(self.node, client, ACK_WIRE,
                                            {"rid": rid, "ack": 1}),
                )

            self.env.sim.after(cfg.pcie_latency_ns / 2, at_host)

    def _start(self, pend: _Pending) -> None:
        cfg, net = self.env.cfg, self.env.net
        meta = {"rid": pend.rid, "cl": pend.client}
        self.env.sim.after(
            cfg.client_post_ns,
            lambda: _send_message(
                net, pend.client, self.node, self.size, write_header_extra(),
                lambda i, n, w: {**meta, "i": i, "n": n},
            ),
        )


class RpcRdmaWriteProtocol(Protocol):
    """RPC+RDMA: validate via RPC, then RDMA-read the payload (Fig. 5)."""

    name = "rpc-rdma-write"

    def __init__(self, env: Env, size: int, node: int = 1):
        super().__init__(env)
        self.size = size
        self.request_bytes = size
        self.node = node
        self.storage_nodes = (node,)
        self._got: dict[int, int] = {}
        self._install(node, self._on_storage)

    def _on_storage(self, pkt) -> None:
        cfg, net, sim = self.env.cfg, self.env.net, self.env.sim
        rid, client = pkt.meta["rid"], pkt.meta["cl"]
        cpu = self.env.host_cpu(self.node)
        if pkt.meta.get("kind") == "req":
            # CPU posts an RDMA read towards the client.
            def at_host() -> None:
                cpu.acquire(
                    cfg.host_notify_ns + cfg.cpu_validate_ns,
                    lambda _s, _e: net.send(
                        self.node, client, ACK_WIRE,
                        {"rid": rid, "cl": client, "kind": "read_req"},
                    ),
                )

            sim.after(cfg.pcie_latency_ns / 2, at_host)
        else:
            got = self._got.get(rid, 0) + 1
            self._got[rid] = got
            if got == pkt.meta["n"]:
                del self._got[rid]

                # completion event -> CPU -> ack (data already at target).
                def at_host() -> None:
                    cpu.acquire(
                        cfg.host_notify_ns,
                        lambda _s, _e: net.send(self.node, client, ACK_WIRE,
                                                {"rid": rid, "ack": 1}),
                    )

                sim.after(cfg.pcie_latency_ns / 2, at_host)

    def _on_client_pkt(self, pkt) -> None:
        if pkt.meta.get("kind") == "read_req":
            # client NIC serves the RDMA read: stream the data.
            rid, client = pkt.meta["rid"], pkt.meta["cl"]
            _send_message(
                self.env.net, client, self.node, self.size, 0,
                lambda i, n, w: {"rid": rid, "cl": client, "kind": "data",
                                 "i": i, "n": n},
            )
            return
        super()._on_client_pkt(pkt)

    def _start(self, pend: _Pending) -> None:
        cfg, net = self.env.cfg, self.env.net
        self.env.sim.after(
            cfg.client_post_ns,
            lambda: net.send(
                pend.client, self.node,
                cfg.rdma_header + write_header_extra(),
                {"rid": pend.rid, "cl": pend.client, "kind": "req"},
            ),
        )


# ---------------------------------------------------------------------------
# Fig. 9 / 10 — replication strategies.
# ---------------------------------------------------------------------------


class RdmaFlatProtocol(Protocol):
    """Client issues k writes, one per replica (no validation)."""

    name = "rdma-flat"

    def __init__(self, env: Env, size: int, k: int):
        super().__init__(env)
        self.size = size
        self.request_bytes = size
        self.k = k
        self.storage_nodes = tuple(range(1, k + 1))
        self._got: dict[tuple[int, int], int] = {}
        for node in self.storage_nodes:
            self._install(node, self._mk_storage(node))

    def _expected_acks(self) -> int:
        return self.k

    def _mk_storage(self, node: int):
        def on_storage(pkt) -> None:
            rid = pkt.meta["rid"]
            key = (rid, node)
            got = self._got.get(key, 0) + 1
            self._got[key] = got
            if got == pkt.meta["n"]:
                del self._got[key]
                cfg, net = self.env.cfg, self.env.net
                client = pkt.meta["cl"]
                self.env.sim.after(
                    cfg.nic_fixed_ns,
                    lambda: net.send(node, client, ACK_WIRE,
                                     {"rid": rid, "ack": node}),
                )

        return on_storage

    def _start(self, pend: _Pending) -> None:
        cfg, net = self.env.cfg, self.env.net
        meta = {"rid": pend.rid, "cl": pend.client}
        for idx, node in enumerate(self.storage_nodes):
            delay = cfg.client_post_ns + idx * cfg.client_post_extra_ns
            self.env.sim.after(
                delay,
                lambda node=node: _send_message(
                    net, pend.client, node, self.size, 0,
                    lambda i, n, w: {**meta, "i": i, "n": n},
                ),
            )


class ChunkedTreeProtocol(Protocol):
    """Chunked store-and-forward broadcast over a ring/tree.

    Models both CPU-based replication (per-chunk host notify + buffer copy)
    and RDMA-HyperLoop (per-chunk WQE trigger, optional config phase).
    Every node acks the client when it holds the full message.

    The per-chunk copy engine is modeled as parallel (a multi-core host
    memcpy at half single-copy bandwidth), matching the paper's stated
    penalty; contention across concurrent requests arises at the network
    ports."""

    name = "chunked-tree"

    class _NodeState:
        __slots__ = ("received", "chunk_acc", "next_chunk", "acked")

        def __init__(self):
            self.received = 0
            self.chunk_acc = 0
            self.next_chunk = 0
            self.acked = False

    def __init__(
        self,
        env: Env,
        size: int,
        k: int,
        strategy: ReplStrategy,
        per_chunk_overhead_ns: float,
        copy_GBps: float | None,
        chunk: int | None = None,
        config_phase_writes: int = 0,
    ):
        super().__init__(env)
        self.size = size
        self.request_bytes = size
        self.k = k
        self.strategy = strategy
        self.per_chunk_overhead_ns = per_chunk_overhead_ns
        self.copy_GBps = copy_GBps
        self.config_phase_writes = config_phase_writes
        cfg = env.cfg
        if chunk is None:
            nchunks = optimal_chunk_count(
                size, k, strategy, cfg.bytes_per_ns * 1e9,
                per_chunk_overhead_ns * 1e-9,
            )
            chunk = -(-size // nchunks)
        self.chunk = chunk
        self.chunks = _chunk_counts(size, chunk)
        self.storage_nodes = tuple(range(1, k + 1))
        self._states: dict[tuple[int, int], ChunkedTreeProtocol._NodeState] = {}
        for r in range(k):
            self._install(r + 1, self._mk_node(r))

    def _expected_acks(self) -> int:
        return self.k

    def _forward_chunk(self, rid: int, client: int, rank: int,
                       chunk_idx: int) -> None:
        for c in children_of(rank, self.k, self.strategy):
            _send_message(
                self.env.net,
                rank + 1,
                c + 1,
                self.chunks[chunk_idx],
                0,
                lambda i, n, w: {"rid": rid, "cl": client, "i": i, "n": n,
                                 "chunk": chunk_idx},
            )

    def _mk_node(self, rank: int):
        def on_node(pkt) -> None:
            cfg, sim = self.env.cfg, self.env.sim
            meta = pkt.meta
            if meta.get("cfg"):
                # HyperLoop configuration write: ack it.
                node = rank + 1
                sim.after(
                    cfg.nic_fixed_ns,
                    lambda: self.env.net.send(
                        node, meta["cl"], ACK_WIRE,
                        {"rid": meta["rid"], "cfg_ack": 1},
                    ),
                )
                return
            rid, client = meta["rid"], meta["cl"]
            st = self._states.setdefault((rid, rank), self._NodeState())
            payload = pkt.wire_size - cfg.rdma_header
            if meta.get("hdr"):
                payload -= meta["hdr"]
            st.received += payload
            st.chunk_acc += payload
            chunks = self.chunks
            while (st.next_chunk < len(chunks)
                   and st.chunk_acc >= chunks[st.next_chunk]):
                st.chunk_acc -= chunks[st.next_chunk]
                ci = st.next_chunk
                st.next_chunk += 1
                delay = self.per_chunk_overhead_ns
                if self.copy_GBps is not None:
                    delay += chunks[ci] / self.copy_GBps
                sim.after(
                    delay,
                    lambda ci=ci: self._forward_chunk(rid, client, rank, ci),
                )
            if st.received >= self.size and not st.acked:
                st.acked = True
                node = rank + 1
                sim.after(
                    cfg.nic_fixed_ns,
                    lambda: self.env.net.send(node, client, ACK_WIRE,
                                              {"rid": rid, "ack": rank}),
                )
            if st.acked and st.next_chunk == len(chunks):
                del self._states[(rid, rank)]

        return on_node

    def _broadcast(self, pend: _Pending) -> None:
        meta = {"rid": pend.rid, "cl": pend.client}
        _send_message(
            self.env.net, pend.client, 1, self.size, 0,
            lambda i, n, w: {**meta, "i": i, "n": n},
        )

    def _on_cfg_ack(self, pend: _Pending) -> None:
        pend.cfg_acks += 1
        if pend.cfg_acks == self.config_phase_writes:
            cfg = self.env.cfg
            self.env.sim.after(
                cfg.client_complete_ns + cfg.client_post_ns,
                lambda: self._broadcast(pend),
            )

    def _start(self, pend: _Pending) -> None:
        cfg, sim = self.env.cfg, self.env.sim
        if self.config_phase_writes:
            # HyperLoop: write WQE descriptors to each node, wait for acks,
            # then post the actual data write.
            for r in range(self.config_phase_writes):
                node = r + 1
                delay = cfg.client_post_ns + r * cfg.client_post_extra_ns
                sim.after(
                    delay,
                    lambda node=node: self.env.net.send(
                        pend.client, node, HYPERLOOP_CONFIG_WIRE,
                        {"rid": pend.rid, "cl": pend.client, "cfg": 1},
                    ),
                )
        else:
            sim.after(cfg.client_post_ns, lambda: self._broadcast(pend))


class SpinReplicationProtocol(Protocol):
    """sPIN-Ring / sPIN-PBT: per-packet forwarding by NIC handlers."""

    name = "spin-repl"

    class _Req:
        __slots__ = ("gate", "processed", "n", "ch_fired")

        def __init__(self):
            self.gate = RequestGate()
            self.processed = 0
            self.n: int | None = None
            self.ch_fired = False

    def __init__(self, env: Env, size: int, k: int, strategy: ReplStrategy):
        super().__init__(env)
        self.size = size
        self.request_bytes = size
        self.k = k
        self.strategy = strategy
        key = "repl_ring" if strategy == ReplStrategy.RING else "repl_pbt"
        self.handler_ns = HANDLER_NS[key]
        self.header_extra = write_header_extra(k)
        self.storage_nodes = tuple(range(1, k + 1))
        self.units = {r: env.pspin(r + 1) for r in range(k)}
        self._reqs: dict[tuple[int, int], SpinReplicationProtocol._Req] = {}
        for r in range(k):
            self._install(r + 1, self._mk_node(r))

    def _expected_acks(self) -> int:
        return self.k

    def _mk_node(self, rank: int):
        unit = self.units[rank]
        kids = children_of(rank, self.k, self.strategy)
        hh, ph, ch = self.handler_ns

        def on_node(pkt) -> None:
            meta = pkt.meta
            rid, i = meta["rid"], meta["i"]
            req = self._reqs.setdefault((rid, rank), self._Req())
            req.n = meta["n"]
            emits = [Emit(c + 1, pkt.wire_size, dict(meta)) for c in kids]

            def packet_done() -> None:
                req.processed += 1
                if req.processed == req.n and not req.ch_fired:
                    req.ch_fired = True
                    del self._reqs[(rid, rank)]
                    unit.process(
                        ACK_WIRE,
                        HandlerSpec(
                            ch,
                            [Emit(meta["cl"], ACK_WIRE,
                                  {"rid": rid, "ack": rank})],
                        ),
                    )

            if i == 0:
                unit.process(pkt.wire_size, HandlerSpec(hh, gate=req.gate))
            spec = HandlerSpec(ph, emits, on_complete=packet_done,
                               gate=req.gate)
            unit.process_gated(pkt.wire_size, spec)

        return on_node

    def _start(self, pend: _Pending) -> None:
        cfg, net = self.env.cfg, self.env.net
        meta = {"rid": pend.rid, "cl": pend.client}
        self.env.sim.after(
            cfg.client_post_ns,
            lambda: _send_message(
                net, pend.client, 1, self.size, self.header_extra,
                lambda i, n, w: {**meta, "i": i, "n": n},
            ),
        )


# ---------------------------------------------------------------------------
# Fig. 15 — erasure coding: sPIN-TriEC vs INEC-TriEC.
# ---------------------------------------------------------------------------


class SpinTriecProtocol(Protocol):
    """Streaming per-packet TriEC encode on the NIC (section VI-B)."""

    name = "spin-triec"

    class _DataReq:
        __slots__ = ("gate", "processed", "n", "done")

        def __init__(self):
            self.gate = RequestGate()
            self.processed = 0
            self.n: int | None = None
            self.done = False

    class _ParReq:
        __slots__ = ("seq_counts", "seqs_done", "streams_done",
                     "expected_seqs", "acked")

        def __init__(self):
            self.seq_counts: dict[int, int] = {}
            self.seqs_done = 0
            self.streams_done = 0
            self.expected_seqs: int | None = None
            self.acked = False

    def __init__(self, env: Env, block: int, k: int, m: int):
        super().__init__(env)
        self.block = block
        self.request_bytes = block
        self.k = k
        self.m = m
        self.chunk = -(-block // k)
        self.header_extra = write_header_extra(m)
        self.storage_nodes = tuple(range(1, k + m + 1))
        self.data_units = {j: env.pspin(j + 1) for j in range(k)}
        self.par_units = {i: env.pspin(k + 1 + i) for i in range(m)}
        self._dreqs: dict[tuple[int, int], SpinTriecProtocol._DataReq] = {}
        self._preqs: dict[tuple[int, int], SpinTriecProtocol._ParReq] = {}
        self.first_inject_ns: float | None = None
        for j in range(k):
            self._install(j + 1, self._mk_data(j))
        for pi in range(m):
            self._install(k + 1 + pi, self._mk_parity(pi))

    def _expected_acks(self) -> int:
        return self.k + self.m

    def _mk_data(self, j: int):
        unit = self.data_units[j]
        hh, _, ch = HANDLER_NS["ec_data_rs32"]
        k, m = self.k, self.m

        def on_node(pkt) -> None:
            cfg = self.env.cfg
            meta = pkt.meta
            rid, i, n = meta["rid"], meta["i"], meta["n"]
            req = self._dreqs.setdefault((rid, j), self._DataReq())
            req.n = n
            payload = (pkt.wire_size - cfg.rdma_header
                       - (self.header_extra if i == 0 else 0))
            emits = [
                Emit(
                    k + 1 + pi,
                    cfg.rdma_header + payload,
                    {"rid": rid, "cl": meta["cl"], "seq": i, "src": j,
                     "n": n, "last": i == n - 1},
                )
                for pi in range(m)
            ]
            compute = ec_data_ph_ns(payload, m)

            def packet_done() -> None:
                req.processed += 1
                if req.processed == req.n and not req.done:
                    req.done = True
                    del self._dreqs[(rid, j)]
                    unit.process(
                        ACK_WIRE,
                        HandlerSpec(
                            ch,
                            [Emit(meta["cl"], ACK_WIRE,
                                  {"rid": rid, "ack": ("d", j)})],
                        ),
                    )

            if i == 0:
                unit.process(pkt.wire_size, HandlerSpec(hh, gate=req.gate))
            spec = HandlerSpec(compute, emits, on_complete=packet_done,
                               gate=req.gate)
            unit.process_gated(pkt.wire_size, spec)

        return on_node

    def _mk_parity(self, pi: int):
        unit = self.par_units[pi]
        _, _, pch = HANDLER_NS["ec_parity"]
        k = self.k

        def on_node(pkt) -> None:
            cfg = self.env.cfg
            meta = pkt.meta
            rid, seq = meta["rid"], meta["seq"]
            req = self._preqs.setdefault((rid, pi), self._ParReq())
            payload = pkt.wire_size - cfg.rdma_header

            def packet_done() -> None:
                c = req.seq_counts.get(seq, 0) + 1
                req.seq_counts[seq] = c
                if c == k:
                    req.seqs_done += 1
                if meta["last"]:
                    req.streams_done += 1
                    req.expected_seqs = meta["n"]
                if (
                    not req.acked
                    and req.streams_done == k
                    and req.expected_seqs is not None
                    and req.seqs_done == req.expected_seqs
                ):
                    req.acked = True
                    del self._preqs[(rid, pi)]
                    unit.process(
                        ACK_WIRE,
                        HandlerSpec(
                            pch,
                            [Emit(meta["cl"], ACK_WIRE,
                                  {"rid": rid, "ack": ("p", pi)})],
                        ),
                    )

            compute = ec_parity_ph_ns(payload)
            unit.process(pkt.wire_size,
                         HandlerSpec(compute, on_complete=packet_done))

        return on_node

    def _start(self, pend: _Pending) -> None:
        cfg, net, sim = self.env.cfg, self.env.net, self.env.sim
        k = self.k

        # Interleaved transmission (section VI-B1): packet i of every chunk
        # before packet i+1 of any.
        def inject() -> None:
            if self.first_inject_ns is None:
                self.first_inject_ns = sim.now
            streams = [net.cfg.packets_of(self.chunk, self.header_extra)
                       for _ in range(k)]
            nmax = max(len(s) for s in streams)
            for i in range(nmax):
                for j in range(k):
                    if i < len(streams[j]):
                        net.send(
                            pend.client,
                            j + 1,
                            streams[j][i],
                            {"rid": pend.rid, "cl": pend.client,
                             "i": i, "n": len(streams[j])},
                        )

        post = cfg.client_post_ns + (k - 1) * cfg.client_post_extra_ns
        sim.after(post, inject)


class InecTriecProtocol(Protocol):
    """INEC-TriEC: chunk-granularity NIC-offloaded EC with host staging.

    Data path per chunk (Fig. 13 left): chunk lands in host memory (PCIe
    flush), the on-NIC EC engine reads it back over PCIe, encodes, sends m
    intermediate chunks; parity nodes stage k chunks in host memory, the
    NIC XOR engine reads them back, writes the final parity.  No packet-
    level overlap — per-chunk pipelining only (INEC's triggered ops).

    Posting is host-paced per client: at most ``window`` blocks
    outstanding (the INEC benchmark chains are posted per block by host
    software); excess requests queue at the client."""

    name = "inec-triec"

    def __init__(self, env: Env, block: int, k: int, m: int,
                 window: int = INEC_WINDOW):
        super().__init__(env)
        self.block = block
        self.request_bytes = block
        self.k = k
        self.m = m
        self.window = window
        self.chunk = -(-block // k)
        self.storage_nodes = tuple(range(1, k + m + 1))
        # Per-node serial engines: PCIe staging + EC/XOR engine.  Each
        # engine dispatch pays the triggered-op chain overhead (WAIT WQE +
        # doorbell).
        self.pcie = {n: SerialResource(env.sim) for n in self.storage_nodes}
        self.engine = {n: SerialResource(env.sim) for n in self.storage_nodes}
        self._got: dict[tuple[int, int], int] = {}
        self._par_got: dict[tuple[int, int], int] = {}
        self._outstanding: dict[int, int] = {}   # client -> in-flight blocks
        self._queued: dict[int, list[_Pending]] = {}
        self.first_inject_ns: float | None = None
        for j in range(k):
            self._install(j + 1, self._mk_data(j))
        for pi in range(m):
            self._install(k + 1 + pi, self._mk_parity(pi))

    def _expected_acks(self) -> int:
        return self.k + self.m

    def _mk_data(self, j: int):
        node = j + 1

        def on_node(pkt) -> None:
            cfg, net = self.env.cfg, self.env.net
            meta = pkt.meta
            rid, client = meta["rid"], meta["cl"]
            key = (rid, j)
            self._got[key] = self._got.get(key, 0) + 1
            if self._got[key] != meta["n"]:
                return
            del self._got[key]
            chunk, m = self.chunk, self.m

            # full chunk in NIC; flush to host memory:
            def staged(_s, _e) -> None:
                def read_back(_s2, _e2) -> None:
                    def encoded(_s3, _e3) -> None:
                        for pi in range(m):
                            _send_message(
                                net, node, self.k + 1 + pi, chunk, 0,
                                lambda i, n, w: {"rid": rid, "cl": client,
                                                 "src": j, "i": i, "n": n},
                            )
                        net.send(node, client, ACK_WIRE,
                                 {"rid": rid, "ack": ("d", j)})

                    self.engine[node].acquire(
                        INEC_TRIGGER_NS + chunk / INEC_EC_ENGINE_GBPS, encoded
                    )

                self.pcie[node].acquire(
                    cfg.pcie_latency_ns + chunk / INEC_PCIE_BW_GBPS, read_back
                )

            self.pcie[node].acquire(
                cfg.pcie_latency_ns / 2 + chunk / INEC_PCIE_BW_GBPS, staged
            )

        return on_node

    def _mk_parity(self, pi: int):
        node = self.k + 1 + pi

        def on_node(pkt) -> None:
            cfg, net = self.env.cfg, self.env.net
            meta = pkt.meta
            rid, client = meta["rid"], meta["cl"]
            key = (rid, pi)
            self._par_got[key] = self._par_got.get(key, 0) + 1
            # every intermediate chunk stages through host memory:
            if self._par_got[key] != self.k * meta["n"]:
                return
            del self._par_got[key]
            chunk, k = self.chunk, self.k

            def staged(_s, _e) -> None:
                def xored(_s2, _e2) -> None:
                    def written(_s3, _e3) -> None:
                        net.send(node, client, ACK_WIRE,
                                 {"rid": rid, "ack": ("p", pi)})

                    self.pcie[node].acquire(
                        cfg.pcie_latency_ns / 2 + chunk / INEC_PCIE_BW_GBPS,
                        written,
                    )

                self.engine[node].acquire(
                    INEC_TRIGGER_NS + k * chunk / INEC_EC_ENGINE_GBPS, xored
                )

            # NIC XOR engine reads the k staged chunks back over PCIe.
            self.pcie[node].acquire(
                cfg.pcie_latency_ns + k * chunk / INEC_PCIE_BW_GBPS, staged
            )

        return on_node

    def _inject(self, pend: _Pending) -> None:
        if self.first_inject_ns is None:
            self.first_inject_ns = self.env.sim.now
        for j in range(self.k):
            _send_message(
                self.env.net, pend.client, j + 1, self.chunk, 0,
                lambda i, n, w: {"rid": pend.rid, "cl": pend.client,
                                 "i": i, "n": n},
            )

    def _start(self, pend: _Pending) -> None:
        cfg, sim = self.env.cfg, self.env.sim
        client = pend.client
        if self._outstanding.get(client, 0) < self.window:
            self._outstanding[client] = self._outstanding.get(client, 0) + 1
            post = cfg.client_post_ns + (self.k - 1) * cfg.client_post_extra_ns
            sim.after(post, lambda: self._inject(pend))
        else:
            self._queued.setdefault(client, []).append(pend)

    def _on_request_complete(self, pend: _Pending) -> None:
        client = pend.client
        queue = self._queued.get(client)
        if queue:
            # Re-armed chains pay only client_post_ns (the k WQEs were
            # batched when the chain was configured) — matches the
            # pre-refactor host-pacing model.
            nxt = queue.pop(0)
            self.env.sim.after(self.env.cfg.client_post_ns,
                               lambda: self._inject(nxt))
        else:
            self._outstanding[client] -= 1
