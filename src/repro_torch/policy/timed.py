"""Timed compiler: :class:`PolicySpec` -> stage pipeline over a shared Env.

A compiled policy is a :class:`PipelineProtocol`: one client-side
*injector* stage (how requests are posted and packets injected) plus one
*sink* stage per storage node (how that node ingests, validates, forwards,
encodes, and acks).  The stage classes are the timed realizations of the
spec vocabulary (``repro_torch.policy.spec``); composing them reproduces every
hand-written protocol of ``repro_torch.sim.legacy`` bit-exactly — enforced by
tests/test_policy.py — while adding what the monolithic classes could
not express:

  * per-request payload sizes (``Protocol.issue(..., size=)``), so one
    compiled policy serves a whole size distribution;
  * several policies sharing one Env *and its storage nodes*: every
    packet carries the policy id (``pid``) and the per-node dispatcher
    (:meth:`repro_torch.sim.protocols.Env.bind`) demultiplexes — mixed-policy
    contention (writes + EC on the same nodes) composes mechanically;
  * a read path (:class:`SpinReadSink`): authenticated request up, data
    streamed back by the NIC handlers;
  * degraded reads (:class:`EcReadInjector`): compiled against the Env's
    :class:`repro_torch.policy.FailureModel`, the striped-EC read fans out to
    the k surviving shards and reconstructs missing data chunks with a
    per-packet decode stage — on the client NIC's HPUs (cost model
    symmetric to the SpinStream encode handlers) or on the host CPU
    (:class:`HostReadSink` + :data:`HOST_DECODE_GBPS`, the detour the
    paper's offloads avoid) — plus replica-failover reads.

Stage -> paper map: SpongeAuth / SpinStreamSink gating = section IV;
Flat / Tree forwarding sinks = section V; RS data/parity sinks = section
VI (sPIN-TriEC streaming vs INEC chunk staging).
"""

from __future__ import annotations

import random

from repro_torch.core.packets import ReplStrategy
from repro_torch.membership.retry import RetryPolicy
from repro_torch.core.replication import children_of, optimal_chunk_count
from repro_torch.policy.spec import (
    Chain,
    Flat,
    HostAuth,
    METADATA_OPS,
    PolicySpec,
    Quorum,
    RS,
    SpongeAuth,
    Tree,
)
from repro_torch.sim.engine import SerialResource
from repro_torch.sim.protocols import (
    ACK_WIRE,
    HOST_DECODE_GBPS,
    HYPERLOOP_CONFIG_WIRE,
    HYPERLOOP_TRIGGER_NS,
    INEC_EC_ENGINE_GBPS,
    INEC_PCIE_BW_GBPS,
    INEC_TRIGGER_NS,
    INEC_WINDOW,
    VERSION_WIRE,
    Env,
    Protocol,
    _Pending,
    _chunk_counts,
    _send_message,
    ec_data_ph_ns,
    ec_decode_ph_ns,
    ec_parity_ph_ns,
    read_header_extra,
    write_header_extra,
)
from repro_torch.sim.pspin import Emit, HANDLER_NS, HandlerSpec, RequestGate


def _spin_trace(p, rid):
    """``(rid, pid)`` HandlerSpec trace context when the tracer samples
    this request; None otherwise (the zero-cost-when-off guard every
    PsPIN-backed sink shares)."""
    tr = p.env.sim.tracer
    if tr is None or not tr.sampled(rid):
        return None
    return (rid, p.pid)


def _trace_client_post(p, pend, dur_ns) -> None:
    """Record the client posting span [now, now+dur) for a sampled
    request (software post + doorbell + WQE fetch)."""
    tr = p.env.sim.tracer
    if tr is not None and tr.sampled(pend.rid):
        now = p.env.sim.now
        tr.record("client post", "client", now, now + dur_ns, rid=pend.rid,
                  pid=p.pid, resource=f"cl{pend.client}")


def _host_trace(p, node, rid, pcie_ns):
    """Record the NIC->host PCIe detour span [now, now+pcie_ns) and
    return a host-CPU trace context for the subsequent ``cpu.acquire``
    (None when the request is unsampled)."""
    tr = p.env.sim.tracer
    if tr is None or not tr.sampled(rid):
        return None
    now = p.env.sim.now
    tr.record("pcie", "pcie", now, now + pcie_ns, rid=rid, pid=p.pid,
              resource=f"n{node}.pcie")
    return (rid, p.pid, "host_cpu")


class Stage:
    """One pipeline stage, attached to its protocol after construction."""

    proto: "PipelineProtocol"

    def attach(self, proto: "PipelineProtocol") -> None:
        self.proto = proto

    # injector hooks (no-ops for sinks):
    def expected_acks(self, size: int) -> int:
        return 1

    def on_client_pkt(self, pkt) -> bool:
        return False

    def on_cfg_ack(self, pend: _Pending) -> None:
        pass

    def on_request_complete(self, pend: _Pending) -> None:
        pass


class PipelineProtocol(Protocol):
    """A timed protocol assembled from stages: injector + per-node sinks.

    All packets carry ``meta['pid']`` so several pipelines can share one
    Env (and storage nodes); ``meta['sz']`` carries the request payload so
    sinks handle per-request sizes."""

    def __init__(
        self,
        env: Env,
        spec: PolicySpec | None,
        size: int,
        injector: Stage,
        sinks: dict[int, Stage],
    ):
        super().__init__(env)
        self.spec = spec
        self.size = size
        self.request_bytes = size
        self.pid = env.new_pid()
        self.injector = injector
        self.sinks = dict(sinks)
        self.storage_nodes = tuple(sorted(self.sinks))
        self.first_inject_ns: float | None = None
        self.chunk: int | None = None  # tree pipelines: chunk @ default size
        injector.attach(self)
        for node, sink in self.sinks.items():
            sink.attach(self)
            env.bind(node, self.pid, sink.on_packet)
        tr = env.sim.tracer
        if tr is not None:
            tr.register_policy(self.pid, self.name)

    @property
    def name(self) -> str:
        if self.spec is None:
            return "pipeline"
        return self.spec.name or self.spec.describe()

    def req_size(self, pend: _Pending) -> int:
        return self.size if pend.size is None else pend.size

    def mark_inject(self) -> None:
        if self.first_inject_ns is None:
            self.first_inject_ns = self.env.sim.now

    # -- Protocol plumbing, routed through the stages -----------------------

    def _install(self, node: int, handler) -> None:
        self.env.bind(node, self.pid, handler)

    def _expected_acks_of(self, pend: _Pending) -> int:
        return self.injector.expected_acks(self.req_size(pend))

    def _start(self, pend: _Pending) -> None:
        self.injector.start(pend)

    def _on_cfg_ack(self, pend: _Pending) -> None:
        self.injector.on_cfg_ack(pend)

    def _on_request_complete(self, pend: _Pending) -> None:
        self.injector.on_request_complete(pend)

    def _on_client_pkt(self, pkt) -> None:
        if self.injector.on_client_pkt(pkt):
            return
        super()._on_client_pkt(pkt)


# ---------------------------------------------------------------------------
# Client-side injector stages.
# ---------------------------------------------------------------------------


class MessageInjector(Stage):
    """Post one message to a single storage node after ``client_post_ns``."""

    def __init__(self, node: int = 1, header_extra: int = 0, acks: int = 1):
        self.node = node
        self.header_extra = header_extra
        self.acks = acks

    def expected_acks(self, size: int) -> int:
        return self.acks

    def start(self, pend: _Pending) -> None:
        p = self.proto
        cfg, net = p.env.cfg, p.env.net
        size = p.req_size(pend)
        meta = {"rid": pend.rid, "cl": pend.client, "pid": p.pid, "sz": size}
        _trace_client_post(p, pend, cfg.client_post_ns)
        p.env.sim.after(
            cfg.client_post_ns,
            lambda: _send_message(
                net, pend.client, self.node, size, self.header_extra,
                lambda i, n, w: {**meta, "i": i, "n": n},
            ),
        )


class ChainWriteInjector(Stage):
    """Membership-aware chain write injector: the head is resolved from
    the *detected* view per attempt (never from the fault schedule), the
    view number rides along as the request epoch, and a missing ack is
    retried with capped exponential backoff + seeded jitter — covering
    head crashes, fenced packets, and the unavailability window while a
    view change waits out leases.  Exhausting ``max_attempts`` fails the
    request cleanly via ``Protocol._register_failure``."""

    def __init__(self, membership, chain_nodes: tuple[int, ...],
                 header_extra: int, retry: RetryPolicy | None = None,
                 seed: int = 0):
        self.membership = membership
        self.chain_nodes = tuple(chain_nodes)
        self.header_extra = header_extra
        self.retry = retry or RetryPolicy(base=250_000.0, mult=2.0,
                                          cap=2_000_000.0, jitter=0.2,
                                          max_attempts=12)
        self.rng = random.Random(seed ^ 0x9E3779B9)

    def expected_acks(self, size: int) -> int:
        return 1

    def start(self, pend: _Pending) -> None:
        self._attempt(pend, 0)

    def _attempt(self, pend: _Pending, attempt: int) -> None:
        p = self.proto
        if pend.rid not in p._pending:
            return
        view = self.membership.views.view
        members = [n for n in self.chain_nodes if n in view.members]
        if not members:
            p._register_failure(pend, "no live chain replicas")
            return
        head = members[0]
        cfg, net = p.env.cfg, p.env.net
        size = p.req_size(pend)
        meta = {"rid": pend.rid, "cl": pend.client, "pid": p.pid,
                "sz": size, "ep": view.number}
        if attempt:
            p.retries += 1
        _trace_client_post(p, pend, cfg.client_post_ns)
        p.env.sim.after(
            cfg.client_post_ns,
            lambda: _send_message(
                net, pend.client, head, size, self.header_extra,
                lambda i, n, w: {**meta, "i": i, "n": n},
            ),
        )
        rto = cfg.client_post_ns + self.retry.delay(attempt, self.rng)
        p.env.sim.after(rto, lambda: self._timeout(pend, attempt))

    def _timeout(self, pend: _Pending, attempt: int) -> None:
        p = self.proto
        if pend.rid not in p._pending:
            return   # completed in the meantime
        if attempt + 1 >= self.retry.max_attempts:
            p._register_failure(pend, "retry budget exhausted")
            return
        self._attempt(pend, attempt + 1)


class FanoutInjector(Stage):
    """Section V baseline: one write per replica, staggered by the
    per-WQE post cost (RDMA-Flat)."""

    def __init__(self, nodes: tuple[int, ...]):
        self.nodes = nodes

    def expected_acks(self, size: int) -> int:
        return len(self.nodes)

    def start(self, pend: _Pending) -> None:
        p = self.proto
        cfg, net = p.env.cfg, p.env.net
        size = p.req_size(pend)
        meta = {"rid": pend.rid, "cl": pend.client, "pid": p.pid, "sz": size}
        _trace_client_post(p, pend, cfg.client_post_ns
                           + (len(self.nodes) - 1) * cfg.client_post_extra_ns)
        for idx, node in enumerate(self.nodes):
            delay = cfg.client_post_ns + idx * cfg.client_post_extra_ns
            p.env.sim.after(
                delay,
                lambda node=node: _send_message(
                    net, pend.client, node, size, 0,
                    lambda i, n, w: {**meta, "i": i, "n": n},
                ),
            )


class RpcRdmaInjector(Stage):
    """RPC+RDMA (Fig. 5): small request out; when the storage CPU posts
    the RDMA read, the client NIC streams the payload."""

    def __init__(self, node: int = 1):
        self.node = node

    def start(self, pend: _Pending) -> None:
        p = self.proto
        cfg, net = p.env.cfg, p.env.net
        size = p.req_size(pend)
        _trace_client_post(p, pend, cfg.client_post_ns)
        p.env.sim.after(
            cfg.client_post_ns,
            lambda: net.send(
                pend.client, self.node,
                cfg.rdma_header + write_header_extra(),
                {"rid": pend.rid, "cl": pend.client, "pid": p.pid,
                 "sz": size, "kind": "req"},
            ),
        )

    def on_client_pkt(self, pkt) -> bool:
        if pkt.meta.get("kind") != "read_req":
            return False
        p = self.proto
        rid, client = pkt.meta["rid"], pkt.meta["cl"]
        pend = p._pending.get(rid)
        if pend is None:
            return True
        size = p.req_size(pend)
        _send_message(
            p.env.net, client, self.node, size, 0,
            lambda i, n, w: {"rid": rid, "cl": client, "pid": p.pid,
                             "kind": "data", "i": i, "n": n, "sz": size},
        )
        return True


class TreeRootInjector(Stage):
    """Send the whole message to the tree root (node 1); with
    ``config_phase_writes`` it first runs HyperLoop's configuration phase
    (WQE descriptor writes to every node, wait for acks)."""

    def __init__(self, k: int, config_phase_writes: int = 0):
        self.k = k
        self.config_phase_writes = config_phase_writes

    def expected_acks(self, size: int) -> int:
        return self.k

    def _broadcast(self, pend: _Pending) -> None:
        p = self.proto
        size = p.req_size(pend)
        meta = {"rid": pend.rid, "cl": pend.client, "pid": p.pid, "sz": size}
        _send_message(
            p.env.net, pend.client, 1, size, 0,
            lambda i, n, w: {**meta, "i": i, "n": n},
        )

    def on_cfg_ack(self, pend: _Pending) -> None:
        pend.cfg_acks += 1
        if pend.cfg_acks == self.config_phase_writes:
            cfg = self.proto.env.cfg
            self.proto.env.sim.after(
                cfg.client_complete_ns + cfg.client_post_ns,
                lambda: self._broadcast(pend),
            )

    def start(self, pend: _Pending) -> None:
        p = self.proto
        cfg, sim = p.env.cfg, p.env.sim
        if self.config_phase_writes:
            _trace_client_post(p, pend, cfg.client_post_ns
                               + (self.config_phase_writes - 1)
                               * cfg.client_post_extra_ns)
            for r in range(self.config_phase_writes):
                node = r + 1
                delay = cfg.client_post_ns + r * cfg.client_post_extra_ns
                sim.after(
                    delay,
                    lambda node=node: p.env.net.send(
                        pend.client, node, HYPERLOOP_CONFIG_WIRE,
                        {"rid": pend.rid, "cl": pend.client, "pid": p.pid,
                         "cfg": 1},
                    ),
                )
        else:
            _trace_client_post(p, pend, cfg.client_post_ns)
            sim.after(cfg.client_post_ns, lambda: self._broadcast(pend))


class InterleavedEcInjector(Stage):
    """Section VI-B1: k chunk streams, packet i of every chunk before
    packet i+1 of any (sPIN-TriEC)."""

    def __init__(self, k: int, m: int):
        self.k = k
        self.m = m

    def expected_acks(self, size: int) -> int:
        return self.k + self.m

    def start(self, pend: _Pending) -> None:
        p = self.proto
        cfg, net, sim = p.env.cfg, p.env.net, p.env.sim
        k = self.k
        size = p.req_size(pend)
        chunk = -(-size // k)
        header_extra = write_header_extra(self.m)
        post = cfg.client_post_ns + (k - 1) * cfg.client_post_extra_ns
        _trace_client_post(p, pend, post)

        fl = p.env.flight_lane()
        if fl is not None:
            # batched engines: the whole request's packet schedule is
            # computed analytically at inject time (repro_torch.policy.flight)
            sim.call(sim.now + post, fl.fly_ec, (self, pend))
            return

        def inject() -> None:
            p.mark_inject()
            streams = [net.cfg.packets_of(chunk, header_extra)
                       for _ in range(k)]
            nmax = max(len(s) for s in streams)
            for i in range(nmax):
                for j in range(k):
                    if i < len(streams[j]):
                        net.send(
                            pend.client,
                            j + 1,
                            streams[j][i],
                            {"rid": pend.rid, "cl": pend.client, "pid": p.pid,
                             "i": i, "n": len(streams[j]), "sz": size},
                        )

        sim.after(post, inject)


class InecInjector(Stage):
    """INEC posting: host-paced per client — at most ``window`` blocks
    outstanding; excess requests queue at the client."""

    def __init__(self, k: int, m: int, window: int = INEC_WINDOW):
        self.k = k
        self.m = m
        self.window = window
        self._outstanding: dict[int, int] = {}
        self._queued: dict[int, list[_Pending]] = {}

    def expected_acks(self, size: int) -> int:
        return self.k + self.m

    def _inject(self, pend: _Pending) -> None:
        p = self.proto
        p.mark_inject()
        size = p.req_size(pend)
        chunk = -(-size // self.k)
        for j in range(self.k):
            _send_message(
                p.env.net, pend.client, j + 1, chunk, 0,
                lambda i, n, w: {"rid": pend.rid, "cl": pend.client,
                                 "pid": p.pid, "i": i, "n": n, "sz": size},
            )

    def start(self, pend: _Pending) -> None:
        p = self.proto
        cfg, sim = p.env.cfg, p.env.sim
        client = pend.client
        if self._outstanding.get(client, 0) < self.window:
            self._outstanding[client] = self._outstanding.get(client, 0) + 1
            post = cfg.client_post_ns + (self.k - 1) * cfg.client_post_extra_ns
            _trace_client_post(p, pend, post)
            sim.after(post, lambda: self._inject(pend))
        else:
            self._queued.setdefault(client, []).append(pend)

    def on_request_complete(self, pend: _Pending) -> None:
        client = pend.client
        queue = self._queued.get(client)
        if queue:
            # Re-armed chains pay only client_post_ns (the k WQEs were
            # batched when the chain was configured).
            nxt = queue.pop(0)
            self.proto.env.sim.after(
                self.proto.env.cfg.client_post_ns,
                lambda: self._inject(nxt),
            )
        else:
            self._outstanding[client] -= 1


class EcReadInjector(Stage):
    """Striped (degraded-capable) EC read — the failure story of section
    VI: one read request per surviving shard node; survivors stream their
    chunks back concurrently.  With ``r > 0`` missing data chunks, every
    received shard packet is multiply-accumulated into the reconstruction
    by a timed decode stage:

      decode="spin"  a per-packet PH on the *client* NIC's HPUs with an
                     HPU cost model symmetric to the SpinStream encode
                     handlers (:func:`ec_decode_ph_ns`) — reconstruction
                     pipelines with the incoming streams;
      decode="host"  all shards land in client host memory first; after
                     the last packet the (serial) host CPU is notified
                     and reconstructs at :data:`HOST_DECODE_GBPS` — the
                     CPU detour the paper's offloads avoid.
    """

    def __init__(self, nodes: tuple[int, ...], k: int, r: int,
                 decode: str = "spin"):
        self.nodes = tuple(nodes)
        self.k = k
        self.r = r
        self.decode = decode
        self._arrived: dict[int, int] = {}

    def _chunk(self, size: int) -> int:
        return -(-size // self.k)

    def expected_acks(self, size: int) -> int:
        cfg = self.proto.env.cfg
        per_stream = len(cfg.packets_of(self._chunk(size), 0))
        total = per_stream * len(self.nodes)
        if self.decode == "host":
            total += 1  # the host-CPU decode completion
        return total

    def start(self, pend: _Pending) -> None:
        p = self.proto
        cfg, net = p.env.cfg, p.env.net
        chunk = self._chunk(p.req_size(pend))
        wire = cfg.rdma_header + read_header_extra()
        _trace_client_post(p, pend, cfg.client_post_ns
                           + (len(self.nodes) - 1) * cfg.client_post_extra_ns)
        for idx, node in enumerate(self.nodes):
            delay = cfg.client_post_ns + idx * cfg.client_post_extra_ns
            p.env.sim.after(
                delay,
                lambda node=node: net.send(
                    pend.client, node, wire,
                    {"rid": pend.rid, "cl": pend.client, "pid": p.pid,
                     "sz": chunk, "req": 1},
                ),
            )

    def _ack(self, rid: int) -> None:
        pend = self.proto._pending.get(rid)
        if pend is not None:
            self.proto._register_ack(pend)

    def on_client_pkt(self, pkt) -> bool:
        if not pkt.meta.get("data"):
            return False
        p = self.proto
        rid = pkt.meta["rid"]
        pend = p._pending.get(rid)
        if pend is None:
            return True
        if self.decode == "host":
            # Count the arrival; the last one hands off to the host CPU
            # (completion notify + reconstruction of the missing chunks).
            p._register_ack(pend)
            got = self._arrived.get(rid, 0) + 1
            if got == pend.expected - 1:
                self._arrived.pop(rid, None)
                cfg = p.env.cfg
                chunk = self._chunk(p.req_size(pend))
                work = cfg.host_notify_ns
                if self.r > 0:
                    work += self.k * chunk / HOST_DECODE_GBPS
                cpu = p.env.host_cpu(pend.client)
                ctx = _host_trace(p, pend.client, rid,
                                  cfg.pcie_latency_ns / 2)
                p.env.sim.after(
                    cfg.pcie_latency_ns / 2,
                    lambda: cpu.acquire(work,
                                        lambda _s, _e: self._ack(rid),
                                        trace=ctx),
                )
            else:
                self._arrived[rid] = got
            return True
        if self.r > 0:
            # NIC-side decode: the packet's ack registers only once its
            # reconstruction PH retired on the client NIC.
            payload = pkt.wire_size - p.env.cfg.rdma_header
            unit = p.env.pspin(pend.client)
            unit.process(
                pkt.wire_size,
                HandlerSpec(ec_decode_ph_ns(payload, self.r),
                            on_complete=lambda: self._ack(rid),
                            trace=_spin_trace(p, rid)),
            )
            return True
        return False  # healthy striped read: plain arrival counting


class ReadInjector(Stage):
    """Post one small authenticated read request; completion is counted
    in received data packets (one 'ack' per response packet)."""

    def __init__(self, node: int = 1):
        self.node = node

    def expected_acks(self, size: int) -> int:
        return len(self.proto.env.cfg.packets_of(size, 0))

    def start(self, pend: _Pending) -> None:
        p = self.proto
        cfg, net = p.env.cfg, p.env.net
        size = p.req_size(pend)
        wire = cfg.rdma_header + read_header_extra()
        _trace_client_post(p, pend, cfg.client_post_ns)
        p.env.sim.after(
            cfg.client_post_ns,
            lambda: net.send(
                pend.client, self.node, wire,
                {"rid": pend.rid, "cl": pend.client, "pid": p.pid,
                 "sz": size, "req": 1},
            ),
        )


# ---------------------------------------------------------------------------
# Storage-node sink stages.
# ---------------------------------------------------------------------------


class NicWriteSink(Stage):
    """Plain-RDMA ingest: the NIC acks once the full message arrived."""

    def __init__(self, node: int):
        self.node = node
        self._got: dict[int, int] = {}

    def on_packet(self, pkt) -> None:
        rid = pkt.meta["rid"]
        got = self._got.get(rid, 0) + 1
        self._got[rid] = got
        if got == pkt.meta["n"]:
            del self._got[rid]
            p = self.proto
            cfg, net = p.env.cfg, p.env.net
            client = pkt.meta["cl"]
            node = self.node
            p.env.sim.after(
                cfg.nic_fixed_ns,
                lambda: net.send(node, client, ACK_WIRE,
                                 {"rid": rid, "ack": node, "pid": p.pid}),
            )


class SpinStreamSink(Stage):
    """Section II-B/IV: gated HH/PH/CH pipeline on the node's PsPIN unit.

    The HH (its own short handler) opens the request gate; each payload
    packet runs a PH (``ph_ns_fn``) that may emit packets (``emits_fn`` —
    replication forwarding, EC intermediate parities); once all packets
    of the request were processed, the CH acks the client."""

    class _Req:
        __slots__ = ("gate", "processed", "n", "fired")

        def __init__(self):
            self.gate = RequestGate()
            self.processed = 0
            self.n: int | None = None
            self.fired = False

    def __init__(self, node, hh_ns, ch_ns, ph_ns_fn, emits_fn=None,
                 ack_tag=None):
        self.node = node
        self.hh_ns = hh_ns
        self.ch_ns = ch_ns
        self.ph_ns_fn = ph_ns_fn      # (sink, pkt) -> compute ns
        self.emits_fn = emits_fn      # (sink, pkt) -> list[Emit]
        self.ack_tag = node if ack_tag is None else ack_tag
        self._reqs: dict[int, SpinStreamSink._Req] = {}

    def attach(self, proto) -> None:
        super().attach(proto)
        self.unit = proto.env.pspin(self.node)

    def on_packet(self, pkt) -> None:
        meta = pkt.meta
        rid, i = meta["rid"], meta["i"]
        req = self._reqs.setdefault(rid, self._Req())
        req.n = meta["n"]
        emits = self.emits_fn(self, pkt) if self.emits_fn is not None else []
        unit = self.unit
        pid = self.proto.pid
        ack_tag = self.ack_tag
        trace = _spin_trace(self.proto, rid)

        def packet_done() -> None:
            req.processed += 1
            if req.processed == req.n and not req.fired:
                req.fired = True
                del self._reqs[rid]
                unit.process(
                    ACK_WIRE,
                    HandlerSpec(
                        self.ch_ns,
                        [Emit(meta["cl"], ACK_WIRE,
                              {"rid": rid, "ack": ack_tag, "pid": pid})],
                        trace=trace,
                    ),
                )

        if i == 0:
            unit.process(pkt.wire_size,
                         HandlerSpec(self.hh_ns, gate=req.gate, trace=trace))
        spec = HandlerSpec(self.ph_ns_fn(self, pkt), emits,
                           on_complete=packet_done, gate=req.gate,
                           trace=trace)
        unit.process_gated(pkt.wire_size, spec)


class SpinParitySink(Stage):
    """Section VI-B3: XOR-aggregate k intermediate-parity streams per
    aggregation sequence; ack the client at stripe granularity."""

    class _Req:
        __slots__ = ("seq_counts", "seqs_done", "streams_done",
                     "expected_seqs", "acked")

        def __init__(self):
            self.seq_counts: dict[int, int] = {}
            self.seqs_done = 0
            self.streams_done = 0
            self.expected_seqs: int | None = None
            self.acked = False

    def __init__(self, node: int, k: int, ack_tag):
        self.node = node
        self.k = k
        self.ack_tag = ack_tag
        self._reqs: dict[int, SpinParitySink._Req] = {}

    def attach(self, proto) -> None:
        super().attach(proto)
        self.unit = proto.env.pspin(self.node)
        self.pch = HANDLER_NS["ec_parity"][2]

    def on_packet(self, pkt) -> None:
        cfg = self.proto.env.cfg
        meta = pkt.meta
        rid, seq = meta["rid"], meta["seq"]
        req = self._reqs.setdefault(rid, self._Req())
        payload = pkt.wire_size - cfg.rdma_header
        k = self.k
        unit = self.unit
        pid = self.proto.pid
        trace = _spin_trace(self.proto, rid)

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
                del self._reqs[rid]
                unit.process(
                    ACK_WIRE,
                    HandlerSpec(
                        self.pch,
                        [Emit(meta["cl"], ACK_WIRE,
                              {"rid": rid, "ack": self.ack_tag, "pid": pid})],
                        trace=trace,
                    ),
                )

        compute = ec_parity_ph_ns(payload)
        unit.process(pkt.wire_size,
                     HandlerSpec(compute, on_complete=packet_done,
                                 trace=trace))


class HostCpuSink(Stage):
    """RPC ingest: message lands in a host buffer; the (serial) CPU
    notifies, validates, copies, then acks — the CPU data path."""

    def __init__(self, node: int):
        self.node = node
        self._got: dict[int, int] = {}

    def on_packet(self, pkt) -> None:
        rid = pkt.meta["rid"]
        got = self._got.get(rid, 0) + 1
        self._got[rid] = got
        if got == pkt.meta["n"]:
            del self._got[rid]
            p = self.proto
            cfg, net = p.env.cfg, p.env.net
            client = pkt.meta["cl"]
            cpu = p.env.host_cpu(self.node)
            node = self.node
            pid = p.pid
            work = (cfg.host_notify_ns + cfg.cpu_validate_ns
                    + cfg.memcpy_ns(pkt.meta["sz"]))
            ctx = _host_trace(p, node, rid, cfg.pcie_latency_ns / 2)

            # last packet DMA'd to the host ring: notify, validate, copy, ack
            def at_host() -> None:
                cpu.acquire(
                    work,
                    lambda _s, _e: net.send(node, client, ACK_WIRE,
                                            {"rid": rid, "ack": 1,
                                             "pid": pid}),
                    trace=ctx,
                )

            p.env.sim.after(cfg.pcie_latency_ns / 2, at_host)


class RpcRdmaSink(Stage):
    """RPC+RDMA ingest: CPU validates and posts an RDMA read towards the
    client; the completion event triggers the ack."""

    def __init__(self, node: int):
        self.node = node
        self._got: dict[int, int] = {}

    def on_packet(self, pkt) -> None:
        p = self.proto
        cfg, net, sim = p.env.cfg, p.env.net, p.env.sim
        rid, client = pkt.meta["rid"], pkt.meta["cl"]
        cpu = p.env.host_cpu(self.node)
        node = self.node
        pid = p.pid
        if pkt.meta.get("kind") == "req":
            ctx = _host_trace(p, node, rid, cfg.pcie_latency_ns / 2)

            # CPU posts an RDMA read towards the client.
            def at_host() -> None:
                cpu.acquire(
                    cfg.host_notify_ns + cfg.cpu_validate_ns,
                    lambda _s, _e: net.send(
                        node, client, ACK_WIRE,
                        {"rid": rid, "cl": client, "kind": "read_req",
                         "pid": pid},
                    ),
                    trace=ctx,
                )

            sim.after(cfg.pcie_latency_ns / 2, at_host)
        else:
            got = self._got.get(rid, 0) + 1
            self._got[rid] = got
            if got == pkt.meta["n"]:
                del self._got[rid]
                ctx = _host_trace(p, node, rid, cfg.pcie_latency_ns / 2)

                # completion event -> CPU -> ack (data already at target).
                def at_host() -> None:
                    cpu.acquire(
                        cfg.host_notify_ns,
                        lambda _s, _e: net.send(node, client, ACK_WIRE,
                                                {"rid": rid, "ack": 1,
                                                 "pid": pid}),
                        trace=ctx,
                    )

                sim.after(cfg.pcie_latency_ns / 2, at_host)


class ChunkedTreeSink(Stage):
    """Section V host engines: chunked store-and-forward broadcast node
    (CPU ring/PBT: per-chunk notify + buffer copy; HyperLoop: per-chunk
    WQE trigger).  Acks the client once it holds the full message."""

    class _NodeState:
        __slots__ = ("received", "chunk_acc", "next_chunk", "acked")

        def __init__(self):
            self.received = 0
            self.chunk_acc = 0
            self.next_chunk = 0
            self.acked = False

    def __init__(self, rank, k, strategy, per_chunk_overhead_ns, copy_GBps,
                 chunks_for):
        self.rank = rank
        self.k = k
        self.strategy = strategy
        self.per_chunk_overhead_ns = per_chunk_overhead_ns
        self.copy_GBps = copy_GBps
        self.chunks_for = chunks_for   # size -> list of chunk byte counts
        self._states: dict[int, ChunkedTreeSink._NodeState] = {}

    def _forward_chunk(self, rid, client, size, chunks, chunk_idx) -> None:
        p = self.proto
        for c in children_of(self.rank, self.k, self.strategy):
            _send_message(
                p.env.net,
                self.rank + 1,
                c + 1,
                chunks[chunk_idx],
                0,
                lambda i, n, w: {"rid": rid, "cl": client, "pid": p.pid,
                                 "i": i, "n": n, "chunk": chunk_idx,
                                 "sz": size},
            )

    def on_packet(self, pkt) -> None:
        p = self.proto
        cfg, sim = p.env.cfg, p.env.sim
        meta = pkt.meta
        if meta.get("cfg"):
            # HyperLoop configuration write: ack it.
            node = self.rank + 1
            pid = p.pid
            sim.after(
                cfg.nic_fixed_ns,
                lambda: p.env.net.send(
                    node, meta["cl"], ACK_WIRE,
                    {"rid": meta["rid"], "cfg_ack": 1, "pid": pid},
                ),
            )
            return
        rid, client = meta["rid"], meta["cl"]
        size = meta["sz"]
        st = self._states.setdefault(rid, self._NodeState())
        payload = pkt.wire_size - cfg.rdma_header
        if meta.get("hdr"):
            payload -= meta["hdr"]
        st.received += payload
        st.chunk_acc += payload
        chunks = self.chunks_for(size)
        while (st.next_chunk < len(chunks)
               and st.chunk_acc >= chunks[st.next_chunk]):
            st.chunk_acc -= chunks[st.next_chunk]
            ci = st.next_chunk
            st.next_chunk += 1
            delay = self.per_chunk_overhead_ns
            if self.copy_GBps is not None:
                delay += chunks[ci] / self.copy_GBps
                tr = sim.tracer
                if tr is not None and tr.sampled(rid):
                    # host engines: per-chunk notify + buffer copy before
                    # the forward (plain delay, overlap is legitimate).
                    tr.record("chunk copy", "host_cpu", sim.now,
                              sim.now + delay, rid=rid, pid=p.pid,
                              resource=f"n{self.rank + 1}.host")
            sim.after(
                delay,
                lambda ci=ci: self._forward_chunk(rid, client, size,
                                                  chunks, ci),
            )
        if st.received >= size and not st.acked:
            st.acked = True
            node = self.rank + 1
            pid = p.pid
            sim.after(
                cfg.nic_fixed_ns,
                lambda: p.env.net.send(node, client, ACK_WIRE,
                                       {"rid": rid, "ack": self.rank,
                                        "pid": pid}),
            )
        if st.acked and st.next_chunk == len(chunks):
            del self._states[rid]


class InecDataSink(Stage):
    """Section VI INEC data node: chunk staged through host memory (PCIe
    flush), read back by the on-NIC EC engine, m intermediates sent."""

    def __init__(self, j: int, k: int, m: int):
        self.j = j
        self.k = k
        self.m = m
        self._got: dict[int, int] = {}

    def attach(self, proto) -> None:
        super().attach(proto)
        node = self.j + 1
        self.pcie = proto.inec_pcie[node]
        self.engine = proto.inec_engine[node]

    def on_packet(self, pkt) -> None:
        p = self.proto
        cfg, net = p.env.cfg, p.env.net
        meta = pkt.meta
        rid, client = meta["rid"], meta["cl"]
        self._got[rid] = self._got.get(rid, 0) + 1
        if self._got[rid] != meta["n"]:
            return
        del self._got[rid]
        size = meta["sz"]
        chunk = -(-size // self.k)
        m = self.m
        node = self.j + 1
        j = self.j
        pid = p.pid
        tr = p.env.sim.tracer
        sampled = tr is not None and tr.sampled(rid)
        t_pcie = (rid, pid, "pcie") if sampled else None
        t_ec = (rid, pid, "hpu_exec") if sampled else None

        # full chunk in NIC; flush to host memory:
        def staged(_s, _e) -> None:
            def read_back(_s2, _e2) -> None:
                def encoded(_s3, _e3) -> None:
                    for pi in range(m):
                        _send_message(
                            net, node, self.k + 1 + pi, chunk, 0,
                            lambda i, n, w: {"rid": rid, "cl": client,
                                             "pid": pid, "src": j,
                                             "i": i, "n": n, "sz": size},
                        )
                    net.send(node, client, ACK_WIRE,
                             {"rid": rid, "ack": ("d", j), "pid": pid})

                self.engine.acquire(
                    INEC_TRIGGER_NS + chunk / INEC_EC_ENGINE_GBPS, encoded,
                    trace=t_ec,
                )

            self.pcie.acquire(
                cfg.pcie_latency_ns + chunk / INEC_PCIE_BW_GBPS, read_back,
                trace=t_pcie,
            )

        self.pcie.acquire(
            cfg.pcie_latency_ns / 2 + chunk / INEC_PCIE_BW_GBPS, staged,
            trace=t_pcie,
        )


class InecParitySink(Stage):
    """Section VI INEC parity node: stage k intermediates through host
    memory, XOR them on the NIC engine, write the final parity."""

    def __init__(self, pi: int, k: int):
        self.pi = pi
        self.k = k
        self._got: dict[int, int] = {}

    def attach(self, proto) -> None:
        super().attach(proto)
        node = self.k + 1 + self.pi
        self.pcie = proto.inec_pcie[node]
        self.engine = proto.inec_engine[node]

    def on_packet(self, pkt) -> None:
        p = self.proto
        cfg, net = p.env.cfg, p.env.net
        meta = pkt.meta
        rid, client = meta["rid"], meta["cl"]
        self._got[rid] = self._got.get(rid, 0) + 1
        # every intermediate chunk stages through host memory:
        if self._got[rid] != self.k * meta["n"]:
            return
        del self._got[rid]
        size = meta["sz"]
        chunk = -(-size // self.k)
        k = self.k
        node = self.k + 1 + self.pi
        pi = self.pi
        pid = p.pid
        tr = p.env.sim.tracer
        sampled = tr is not None and tr.sampled(rid)
        t_pcie = (rid, pid, "pcie") if sampled else None
        t_ec = (rid, pid, "hpu_exec") if sampled else None

        def staged(_s, _e) -> None:
            def xored(_s2, _e2) -> None:
                def written(_s3, _e3) -> None:
                    net.send(node, client, ACK_WIRE,
                             {"rid": rid, "ack": ("p", pi), "pid": pid})

                self.pcie.acquire(
                    cfg.pcie_latency_ns / 2 + chunk / INEC_PCIE_BW_GBPS,
                    written,
                    trace=t_pcie,
                )

            self.engine.acquire(
                INEC_TRIGGER_NS + k * chunk / INEC_EC_ENGINE_GBPS, xored,
                trace=t_ec,
            )

        # NIC XOR engine reads the k staged chunks back over PCIe.
        self.pcie.acquire(
            cfg.pcie_latency_ns + k * chunk / INEC_PCIE_BW_GBPS, staged,
            trace=t_pcie,
        )


class HostReadSink(Stage):
    """RPC read server: the request lands in the host ring, the (serial)
    CPU is notified and validates, then the NIC streams the extent from
    host memory at line rate — the host-CPU read baseline."""

    def __init__(self, node: int):
        self.node = node

    def on_packet(self, pkt) -> None:
        p = self.proto
        cfg, net, sim = p.env.cfg, p.env.net, p.env.sim
        meta = pkt.meta
        rid, client, sz = meta["rid"], meta["cl"], meta["sz"]
        cpu = p.env.host_cpu(self.node)
        node = self.node
        pid = p.pid
        ctx = _host_trace(p, node, rid, cfg.pcie_latency_ns / 2)

        def at_host() -> None:
            cpu.acquire(
                cfg.host_notify_ns + cfg.cpu_validate_ns,
                lambda _s, _e: _send_message(
                    net, node, client, sz, 0,
                    lambda i, n, w: {"rid": rid, "pid": pid, "data": 1,
                                     "i": i, "n": n},
                ),
                trace=ctx,
            )

        sim.after(cfg.pcie_latency_ns / 2, at_host)


class SpinReadSink(Stage):
    """Read path: the request's HH validates the capability (section IV),
    then the PH streams the object back to the client packet by packet."""

    def __init__(self, node: int, hh_ns: float, ph_ns: float):
        self.node = node
        self.hh_ns = hh_ns
        self.ph_ns = ph_ns

    def attach(self, proto) -> None:
        super().attach(proto)
        self.unit = proto.env.pspin(self.node)

    def on_packet(self, pkt) -> None:
        p = self.proto
        cfg = p.env.cfg
        meta = pkt.meta
        rid, client = meta["rid"], meta["cl"]
        size = meta["sz"]
        pid = p.pid
        gate = RequestGate()
        sizes = cfg.packets_of(size, 0)
        n = len(sizes)
        emits = [
            Emit(client, w, {"rid": rid, "pid": pid, "data": 1,
                             "i": i, "n": n})
            for i, w in enumerate(sizes)
        ]
        trace = _spin_trace(p, rid)
        self.unit.process(pkt.wire_size,
                          HandlerSpec(self.hh_ns, gate=gate, trace=trace))
        self.unit.process_gated(pkt.wire_size,
                                HandlerSpec(self.ph_ns, emits, gate=gate,
                                            trace=trace))


# ---------------------------------------------------------------------------
# Metadata-plane stages: namespace RPCs against the NameNode.
# ---------------------------------------------------------------------------

#: request header extra beyond the RDMA header: a path/handle key (up to
#: 56 B of path digest + object handle) and the op code
NS_REQ_EXTRA = 64
#: reply wire size: header + block id, generation stamp, and up to 8
#: datanode placements with extent offsets
NS_REPLY_WIRE = 124
#: host-CPU namespace service time per op (assumption): the same table
#: walks the NIC handlers run (``HANDLER_NS["ns_*"]`` instruction
#: counts) served from host DRAM at ~2 ns/instruction — pointer-chase
#: bound, mostly LLC misses — *after* the usual notify+validate detour.
NS_HOST_SERVICE_NS = {
    "lookup": 2.0 * 140.0,
    "open": 2.0 * 190.0,
    "commit": 2.0 * 230.0,
}


class NsRequestInjector(Stage):
    """Post one small namespace RPC (lookup/open/commit) to the NameNode;
    the single reply is the ack.  Both directions carry ``ctrl=1`` —
    metadata RPCs are control traffic, booked under the network's
    ``ctrl_*`` counters and never in data goodput."""

    def __init__(self, node: int = 1):
        self.node = node

    def expected_acks(self, size: int) -> int:
        return 1

    def start(self, pend: _Pending) -> None:
        p = self.proto
        cfg, net = p.env.cfg, p.env.net
        wire = cfg.rdma_header + NS_REQ_EXTRA
        _trace_client_post(p, pend, cfg.client_post_ns)
        p.env.sim.after(
            cfg.client_post_ns,
            lambda: net.send(
                pend.client, self.node, wire,
                {"rid": pend.rid, "cl": pend.client, "pid": p.pid,
                 "ns": 1, "ctrl": 1},
            ),
        )


class SpinNsSink(Stage):
    """NameNode NIC path: the HH validates the request capability
    (sponge MAC over the small header), the gated PH walks the namespace
    tables (``HANDLER_NS["ns_<op>"]``) and emits the reply — lookups
    never touch the host CPU."""

    def __init__(self, node: int, op: str):
        self.node = node
        self.hh_ns, self.ph_ns, _ = HANDLER_NS[f"ns_{op}"]

    def attach(self, proto) -> None:
        super().attach(proto)
        self.unit = proto.env.pspin(self.node)

    def on_packet(self, pkt) -> None:
        p = self.proto
        meta = pkt.meta
        gate = RequestGate()
        emits = [Emit(meta["cl"], NS_REPLY_WIRE,
                      {"rid": meta["rid"], "pid": p.pid, "ns": 1, "ctrl": 1})]
        trace = _spin_trace(p, meta["rid"])
        self.unit.process(pkt.wire_size,
                          HandlerSpec(self.hh_ns, gate=gate, trace=trace))
        self.unit.process_gated(pkt.wire_size,
                                HandlerSpec(self.ph_ns, emits, gate=gate,
                                            trace=trace))


class HostNsSink(Stage):
    """NameNode host-RPC path: the request crosses PCIe into the host
    ring, the (serial) metadata CPU is notified, validates, and walks
    the namespace (``NS_HOST_SERVICE_NS``), then the reply goes back out
    — every lookup serializes on the one metadata thread, which is
    exactly where the namespace-saturation knee comes from."""

    def __init__(self, node: int, op: str):
        self.node = node
        self.service_ns = NS_HOST_SERVICE_NS[op]

    def on_packet(self, pkt) -> None:
        p = self.proto
        cfg, net = p.env.cfg, p.env.net
        meta = pkt.meta
        rid, client = meta["rid"], meta["cl"]
        cpu = p.env.host_cpu(self.node)
        node, pid = self.node, p.pid
        work = cfg.host_notify_ns + cfg.cpu_validate_ns + self.service_ns
        ctx = _host_trace(p, node, rid, cfg.pcie_latency_ns / 2)

        def at_host() -> None:
            cpu.acquire(
                work,
                lambda _s, _e: net.send(node, client, NS_REPLY_WIRE,
                                        {"rid": rid, "pid": pid,
                                         "ns": 1, "ctrl": 1}),
                trace=ctx,
            )

        p.env.sim.after(cfg.pcie_latency_ns / 2, at_host)


def ns_pipeline(env: Env, spec: PolicySpec, size: int,
                node: int = 1) -> PipelineProtocol:
    """Compile a metadata op onto ``env`` with the NameNode at ``node``
    (``compile_policy`` uses node 1; benchmarks place a dedicated
    NameNode beside the datanodes by passing another id).  The pipeline
    moves no data payload: ``request_bytes`` is 0, so workload goodput
    accounting stays pure data-plane."""
    assert spec.op in METADATA_OPS
    if spec.transport == "spin":
        sink: Stage = SpinNsSink(node, spec.op)
    else:
        sink = HostNsSink(node, spec.op)
    proto = PipelineProtocol(env, spec, size, NsRequestInjector(node),
                             {node: sink})
    proto.request_bytes = 0
    return proto


# ---------------------------------------------------------------------------
# Consistency-axis stages (chain replication / CRAQ and ABD quorums).
# ---------------------------------------------------------------------------


class ChainSpinSink(Stage):
    """Consistency axis, ``Chain(engine='spin')`` write path: every chain
    replica's PsPIN unit forwards each payload packet to its successor as
    it is validated (cut-through, like the ring PH), the tail commits the
    version, and the commit ack walks back up the chain — each hop's CH
    marks the local version clean (the CRAQ dirty-list walk) before
    emitting upstream.  The head's CH acks the client, so the client
    completion certifies the *committed* write, not just receipt.

    Two failover modes.  Static (default, ``membership=None``): succ/pred
    are fixed at compile time against the fault schedule — the legacy
    omniscient reconfiguration, kept as the anchor-exact baseline for
    healthy runs.  Detection-driven (``membership=`` a
    :class:`~repro_torch.membership.HeartbeatService`): every packet resolves
    its position in the chain from the *detected* view at arrival time
    and carries the issuing view number as an epoch (``meta["ep"]``) —
    packets whose epoch mismatches the current view, or that land on a
    replica the view no longer lists, are fenced (dropped + counted in
    ``proto.fenced``) and the client retries with a fresh epoch."""

    class _Req:
        __slots__ = ("gate", "processed", "n", "local_done", "ack_seen",
                     "fired")

        def __init__(self):
            self.gate = RequestGate()
            self.processed = 0
            self.n: int | None = None
            self.local_done = False
            self.ack_seen = False
            self.fired = False

    def __init__(self, node: int, succ: int | None, pred: int | None,
                 membership=None, chain_nodes: tuple[int, ...] = ()):
        self.node = node
        self.succ = succ   # next replica down the chain (None == tail)
        self.pred = pred   # previous replica (None == head)
        self.membership = membership
        self.chain_nodes = tuple(chain_nodes)
        hh, ph, ch = HANDLER_NS["chain_repl"]
        self.hh_ns, self.ph_ns, self.ch_ns = hh, ph, ch
        self._reqs: dict = {}

    def attach(self, proto) -> None:
        super().attach(proto)
        self.unit = proto.env.pspin(self.node)

    def _route(self) -> tuple[int | None, int | None, bool, int | None]:
        """(succ, pred, is_member, epoch) under the detected view."""
        view = self.membership.views.view
        members = [n for n in self.chain_nodes if n in view.members]
        if self.node not in members:
            return None, None, False, view.number
        i = members.index(self.node)
        succ = members[i + 1] if i + 1 < len(members) else None
        pred = members[i - 1] if i > 0 else None
        return succ, pred, True, view.number

    def _commit_ack(self, rid: int, client: int, pred: int | None,
                    ep: int | None) -> None:
        # CH: downstream committed -> mark clean locally, ack upstream.
        pid = self.proto.pid
        extra = {} if ep is None else {"ep": ep}
        if pred is None:
            emit = Emit(client, ACK_WIRE,
                        {"rid": rid, "ack": "chain", "pid": pid, **extra})
        else:
            emit = Emit(pred, ACK_WIRE,
                        {"rid": rid, "cl": client, "pid": pid,
                         "chain_ack": 1, **extra})
        self.unit.process(ACK_WIRE,
                          HandlerSpec(self.ch_ns, [emit],
                                      trace=_spin_trace(self.proto, rid)))

    def _maybe_fire(self, key, req: "ChainSpinSink._Req", client: int,
                    pred: int | None, ep: int | None) -> None:
        if req.fired or not (req.local_done and req.ack_seen):
            return
        req.fired = True
        del self._reqs[key]
        self._commit_ack(key if ep is None else key[0], client, pred, ep)

    def on_packet(self, pkt) -> None:
        meta = pkt.meta
        rid = meta["rid"]
        if self.membership is None:
            succ, pred, ep = self.succ, self.pred, None
            key = rid
        else:
            succ, pred, member, cur_ep = self._route()
            if not member or meta.get("ep") != cur_ep:
                self.proto.fenced += 1
                return
            ep = cur_ep
            key = (rid, ep)
        req = self._reqs.setdefault(key, self._Req())
        if meta.get("chain_ack"):
            req.ack_seen = True
            self._maybe_fire(key, req, meta["cl"], pred, ep)
            return
        req.n = meta["n"]
        trace = _spin_trace(self.proto, rid)
        emits = ([Emit(succ, pkt.wire_size, dict(meta))]
                 if succ is not None else [])

        def packet_done() -> None:
            req.processed += 1
            if req.processed == req.n:
                req.local_done = True
                if succ is None:
                    req.ack_seen = True   # the tail commits locally
                self._maybe_fire(key, req, meta["cl"], pred, ep)

        if meta["i"] == 0:
            self.unit.process(pkt.wire_size,
                              HandlerSpec(self.hh_ns, gate=req.gate,
                                          trace=trace))
        self.unit.process_gated(
            pkt.wire_size,
            HandlerSpec(self.ph_ns, emits, on_complete=packet_done,
                        gate=req.gate, trace=trace),
        )


class ChainHostSink(Stage):
    """Consistency axis, ``Chain(engine='host')`` baseline: chunked
    store-and-forward through host memory down the chain (the cpu-ring
    data path), then the commit ack walks back up — every hop pays the
    PCIe + notify detour both ways, which is exactly what the NIC chain
    avoids."""

    class _St:
        __slots__ = ("received", "chunk_acc", "next_chunk", "local_done",
                     "ack_seen", "fired")

        def __init__(self):
            self.received = 0
            self.chunk_acc = 0
            self.next_chunk = 0
            self.local_done = False
            self.ack_seen = False
            self.fired = False

    def __init__(self, node: int, succ: int | None, pred: int | None,
                 per_chunk_overhead_ns: float, copy_GBps: float,
                 chunks_for):
        self.node = node
        self.succ = succ
        self.pred = pred
        self.per_chunk_overhead_ns = per_chunk_overhead_ns
        self.copy_GBps = copy_GBps
        self.chunks_for = chunks_for
        self._states: dict[int, ChainHostSink._St] = {}

    def _trace_detour(self, rid: int, cpu_ns: float) -> None:
        # This sink models its host detours as plain delays (no serial
        # CPU resource), so the spans are recorded directly; the
        # ``.host`` track may legitimately overlap across requests.
        p = self.proto
        tr = p.env.sim.tracer
        if tr is None or not tr.sampled(rid):
            return
        cfg = p.env.cfg
        now = p.env.sim.now
        t_host = now + cfg.pcie_latency_ns / 2
        tr.record("pcie", "pcie", now, t_host, rid=rid, pid=p.pid,
                  resource=f"n{self.node}.pcie")
        tr.record("commit detour", "host_cpu", t_host, t_host + cpu_ns,
                  rid=rid, pid=p.pid, resource=f"n{self.node}.host")

    def _send_up(self, rid: int, client: int) -> None:
        p = self.proto
        if self.pred is None:
            p.env.net.send(self.node, client, ACK_WIRE,
                           {"rid": rid, "ack": "chain", "pid": p.pid})
        else:
            p.env.net.send(self.node, self.pred, ACK_WIRE,
                           {"rid": rid, "cl": client, "pid": p.pid,
                            "chain_ack": 1})

    def _maybe_fire(self, rid: int, st: "ChainHostSink._St",
                    client: int) -> None:
        if st.fired or not (st.local_done and st.ack_seen):
            return
        st.fired = True
        del self._states[rid]
        cfg = self.proto.env.cfg
        self._trace_detour(rid, cfg.host_notify_ns)
        # commit-ack detour: completion lands in the host ring, the CPU
        # is notified, then posts the upstream ack.
        self.proto.env.sim.after(
            cfg.pcie_latency_ns / 2 + cfg.host_notify_ns,
            lambda: self._send_up(rid, client),
        )

    def on_packet(self, pkt) -> None:
        p = self.proto
        cfg, sim = p.env.cfg, p.env.sim
        meta = pkt.meta
        rid, client = meta["rid"], meta["cl"]
        st = self._states.setdefault(rid, self._St())
        if meta.get("chain_ack"):
            st.ack_seen = True
            self._maybe_fire(rid, st, client)
            return
        size = meta["sz"]
        payload = pkt.wire_size - cfg.rdma_header
        st.received += payload
        st.chunk_acc += payload
        chunks = self.chunks_for(size)
        while (st.next_chunk < len(chunks)
               and st.chunk_acc >= chunks[st.next_chunk]):
            st.chunk_acc -= chunks[st.next_chunk]
            ci = st.next_chunk
            st.next_chunk += 1
            if self.succ is not None:
                delay = (self.per_chunk_overhead_ns
                         + chunks[ci] / self.copy_GBps)
                tr = sim.tracer
                if tr is not None and tr.sampled(rid):
                    tr.record("chunk copy", "host_cpu", sim.now,
                              sim.now + delay, rid=rid, pid=p.pid,
                              resource=f"n{self.node}.host")
                sim.after(
                    delay,
                    lambda ci=ci: _send_message(
                        p.env.net, self.node, self.succ, chunks[ci], 0,
                        lambda i, n, w, ci=ci: {
                            "rid": rid, "cl": client, "pid": p.pid,
                            "i": i, "n": n, "chunk": ci, "sz": size},
                    ),
                )
        if st.received >= size and not st.local_done:
            st.local_done = True
            if self.succ is None:
                # the tail commits: notify + validate, then ack upstream.
                st.ack_seen = True
                st.fired = True
                del self._states[rid]
                self._trace_detour(rid,
                                   cfg.host_notify_ns + cfg.cpu_validate_ns)
                sim.after(
                    cfg.pcie_latency_ns / 2 + cfg.host_notify_ns
                    + cfg.cpu_validate_ns,
                    lambda: self._send_up(rid, client),
                )
            else:
                self._maybe_fire(rid, st, client)


class ChainReadSink(Stage):
    """Consistency axis chain read: any replica serves (CRAQ).  The tail
    (or any replica under ``dirty_read=False``, which pins reads to the
    tail) streams its committed version straight back; a non-tail replica
    under CRAQ first resolves the committed version with a small query
    round-trip to the tail — the timed plane charges this dirty-read
    worst case, while the functional plane implements the real
    clean/dirty distinction."""

    def __init__(self, node: int, tail: int):
        self.node = node
        self.tail = tail
        hh, ph, _ = HANDLER_NS["chain_read"]
        self.hh_ns, self.ph_ns = hh, ph
        self.vq_probe_ns, self.vr_ns, _ = HANDLER_NS["chain_version"]

    def attach(self, proto) -> None:
        super().attach(proto)
        self.unit = proto.env.pspin(self.node)

    def _data_emits(self, rid: int, client: int, size: int) -> list[Emit]:
        cfg = self.proto.env.cfg
        sizes = cfg.packets_of(size, 0)
        n = len(sizes)
        return [
            Emit(client, w, {"rid": rid, "pid": self.proto.pid, "data": 1,
                             "i": i, "n": n})
            for i, w in enumerate(sizes)
        ]

    def on_packet(self, pkt) -> None:
        meta = pkt.meta
        rid = meta["rid"]
        pid = self.proto.pid
        trace = _spin_trace(self.proto, rid)
        if meta.get("vq"):
            # tail: committed-version table probe, reply to the origin.
            self.unit.process(
                pkt.wire_size,
                HandlerSpec(self.vq_probe_ns,
                            [Emit(meta["org"], VERSION_WIRE,
                                  {"rid": rid, "cl": meta["cl"], "pid": pid,
                                   "vr": 1, "sz": meta["sz"]})],
                            trace=trace),
            )
            return
        client, size = meta["cl"], meta["sz"]
        if meta.get("vr"):
            # version resolved: stream the (now known-clean) extent back.
            self.unit.process(
                pkt.wire_size,
                HandlerSpec(self.vr_ns + self.ph_ns,
                            self._data_emits(rid, client, size),
                            trace=trace),
            )
            return
        # client read request
        if self.node == self.tail:
            gate = RequestGate()
            self.unit.process(pkt.wire_size,
                              HandlerSpec(self.hh_ns, gate=gate,
                                          trace=trace))
            self.unit.process_gated(
                pkt.wire_size,
                HandlerSpec(self.ph_ns, self._data_emits(rid, client, size),
                            gate=gate, trace=trace),
            )
            return
        # non-tail CRAQ replica: version query to the tail first.
        self.unit.process(
            pkt.wire_size,
            HandlerSpec(self.hh_ns,
                        [Emit(self.tail, VERSION_WIRE,
                              {"rid": rid, "cl": client, "pid": pid,
                               "vq": 1, "org": self.node, "sz": size})],
                        trace=trace),
        )


class AbdSink(Stage):
    """ABD quorum replica (``Quorum``): answers tag queries with its
    current tag, ingests tagged write / write-back streams (ack per
    message), and streams reads back for the client-side quorum."""

    class _Req:
        __slots__ = ("gate", "processed", "n", "fired")

        def __init__(self):
            self.gate = RequestGate()
            self.processed = 0
            self.n: int | None = None
            self.fired = False

    def __init__(self, node: int):
        self.node = node
        hh, ph, ch = HANDLER_NS["quorum"]
        self.hh_ns, self.ph_ns, self.ch_ns = hh, ph, ch
        self._reqs: dict[tuple[int, str], AbdSink._Req] = {}

    def attach(self, proto) -> None:
        super().attach(proto)
        self.unit = proto.env.pspin(self.node)

    def on_packet(self, pkt) -> None:
        meta = pkt.meta
        rid = meta["rid"]
        unit = self.unit
        pid = self.proto.pid
        trace = _spin_trace(self.proto, rid)
        if meta.get("qt"):
            # phase-1 tag query: reply with the local tag.
            unit.process(
                pkt.wire_size,
                HandlerSpec(self.hh_ns,
                            [Emit(meta["cl"], VERSION_WIRE,
                                  {"rid": rid, "pid": pid, "qtr": 1,
                                   "src": self.node})],
                            trace=trace),
            )
            return
        if meta.get("rq"):
            # read query: stream the locally stored extent back, tagged.
            cfg = self.proto.env.cfg
            sizes = cfg.packets_of(meta["sz"], 0)
            n = len(sizes)
            emits = [
                Emit(meta["cl"], w,
                     {"rid": rid, "pid": pid, "abd_data": 1,
                      "src": self.node, "i": i, "n": n})
                for i, w in enumerate(sizes)
            ]
            gate = RequestGate()
            unit.process(pkt.wire_size,
                         HandlerSpec(self.hh_ns, gate=gate, trace=trace))
            unit.process_gated(pkt.wire_size,
                               HandlerSpec(self.ph_ns, emits, gate=gate,
                                           trace=trace))
            return
        # tagged write ("w2") or read write-back ("wb") payload stream
        ack_kind = "wba" if meta.get("wb") else "w2a"
        key = (rid, ack_kind)
        req = self._reqs.setdefault(key, self._Req())
        req.n = meta["n"]

        def packet_done() -> None:
            req.processed += 1
            if req.processed == req.n and not req.fired:
                req.fired = True
                del self._reqs[key]
                unit.process(
                    ACK_WIRE,
                    HandlerSpec(
                        self.ch_ns,
                        [Emit(meta["cl"], ACK_WIRE,
                              {"rid": rid, "pid": pid, ack_kind: 1,
                               "src": self.node})],
                        trace=trace,
                    ),
                )

        if meta["i"] == 0:
            unit.process(pkt.wire_size,
                         HandlerSpec(self.hh_ns, gate=req.gate, trace=trace))
        unit.process_gated(
            pkt.wire_size,
            HandlerSpec(self.ph_ns, on_complete=packet_done, gate=req.gate,
                        trace=trace),
        )


class AbdWriteInjector(Stage):
    """ABD write: query all n replicas for their tags, adopt max+1 at a
    majority, then stream the tagged payload to all n and complete at a
    majority of acks.  A minority of crashed or slow replicas never
    blocks completion — availability the chain trades away."""

    def __init__(self, nodes: tuple[int, ...], quorum: int):
        self.nodes = tuple(nodes)
        self.quorum = quorum
        self._qtr: dict[int, set[int]] = {}
        self._acks: dict[int, set[int]] = {}
        self._phase2: set[int] = set()

    def expected_acks(self, size: int) -> int:
        return 1  # completion is registered manually at quorum

    def start(self, pend: _Pending) -> None:
        p = self.proto
        cfg, net = p.env.cfg, p.env.net
        size = p.req_size(pend)
        _trace_client_post(p, pend, cfg.client_post_ns
                           + (len(self.nodes) - 1) * cfg.client_post_extra_ns)
        for idx, node in enumerate(self.nodes):
            delay = cfg.client_post_ns + idx * cfg.client_post_extra_ns
            p.env.sim.after(
                delay,
                lambda node=node: net.send(
                    pend.client, node, VERSION_WIRE,
                    {"rid": pend.rid, "cl": pend.client, "pid": p.pid,
                     "qt": 1, "sz": size},
                ),
            )

    def on_client_pkt(self, pkt) -> bool:
        meta = pkt.meta
        rid = meta.get("rid")
        p = self.proto
        pend = p._pending.get(rid)
        if meta.get("qtr"):
            if pend is None or rid in self._phase2:
                return True
            got = self._qtr.setdefault(rid, set())
            got.add(meta["src"])
            if len(got) >= self.quorum:
                self._phase2.add(rid)
                del self._qtr[rid]
                cfg, net = p.env.cfg, p.env.net
                size = p.req_size(pend)
                header_extra = write_header_extra(1)

                def phase2() -> None:
                    for node in self.nodes:
                        _send_message(
                            net, pend.client, node, size, header_extra,
                            lambda i, n, w: {
                                "rid": rid, "cl": pend.client, "pid": p.pid,
                                "i": i, "n": n, "sz": size, "w2": 1},
                        )

                post = (cfg.client_post_ns
                        + (len(self.nodes) - 1) * cfg.client_post_extra_ns)
                _trace_client_post(p, pend, cfg.client_complete_ns + post)
                p.env.sim.after(cfg.client_complete_ns + post, phase2)
            return True
        if meta.get("w2a"):
            if pend is None:
                return True
            got = self._acks.setdefault(rid, set())
            got.add(meta["src"])
            if len(got) >= self.quorum:
                del self._acks[rid]
                self._phase2.discard(rid)
                p._register_ack(pend)
            return True
        return False


class AbdReadInjector(Stage):
    """ABD read: query all n replicas; once a majority streamed their
    (tagged) copies back, write the max-tag value back to a majority so
    later reads cannot observe an older value — the write-back that makes
    the register atomic rather than merely regular."""

    def __init__(self, nodes: tuple[int, ...], quorum: int):
        self.nodes = tuple(nodes)
        self.quorum = quorum
        self._streams: dict[int, dict[int, int]] = {}
        self._done: dict[int, set[int]] = {}
        self._phase2: set[int] = set()
        self._wba: dict[int, set[int]] = {}

    def expected_acks(self, size: int) -> int:
        return 1  # completion is registered manually at quorum

    def start(self, pend: _Pending) -> None:
        p = self.proto
        cfg, net = p.env.cfg, p.env.net
        size = p.req_size(pend)
        wire = cfg.rdma_header + read_header_extra()
        _trace_client_post(p, pend, cfg.client_post_ns
                           + (len(self.nodes) - 1) * cfg.client_post_extra_ns)
        for idx, node in enumerate(self.nodes):
            delay = cfg.client_post_ns + idx * cfg.client_post_extra_ns
            p.env.sim.after(
                delay,
                lambda node=node: net.send(
                    pend.client, node, wire,
                    {"rid": pend.rid, "cl": pend.client, "pid": p.pid,
                     "rq": 1, "sz": size},
                ),
            )

    def on_client_pkt(self, pkt) -> bool:
        meta = pkt.meta
        rid = meta.get("rid")
        p = self.proto
        pend = p._pending.get(rid)
        if meta.get("abd_data"):
            if pend is None or rid in self._phase2:
                return True
            counts = self._streams.setdefault(rid, {})
            src = meta["src"]
            counts[src] = counts.get(src, 0) + 1
            if counts[src] == meta["n"]:
                done = self._done.setdefault(rid, set())
                done.add(src)
                if len(done) >= self.quorum:
                    self._phase2.add(rid)
                    self._streams.pop(rid, None)
                    self._done.pop(rid, None)
                    cfg, net = p.env.cfg, p.env.net
                    size = p.req_size(pend)
                    header_extra = write_header_extra(1)

                    def writeback() -> None:
                        for node in self.nodes:
                            _send_message(
                                net, pend.client, node, size, header_extra,
                                lambda i, n, w: {
                                    "rid": rid, "cl": pend.client,
                                    "pid": p.pid, "i": i, "n": n,
                                    "sz": size, "wb": 1},
                            )

                    post = (cfg.client_post_ns
                            + (len(self.nodes) - 1)
                            * cfg.client_post_extra_ns)
                    _trace_client_post(p, pend, cfg.client_complete_ns + post)
                    p.env.sim.after(cfg.client_complete_ns + post, writeback)
            return True
        if meta.get("wba"):
            if pend is None:
                return True
            got = self._wba.setdefault(rid, set())
            got.add(meta["src"])
            if len(got) >= self.quorum:
                del self._wba[rid]
                self._phase2.discard(rid)
                p._register_ack(pend)
            return True
        return False


# ---------------------------------------------------------------------------
# The compiler.
# ---------------------------------------------------------------------------


def chunked_tree_protocol(
    env: Env,
    size: int,
    k: int,
    strategy: ReplStrategy,
    per_chunk_overhead_ns: float,
    copy_GBps: float | None,
    chunk: int | None = None,
    config_phase_writes: int = 0,
    message_chunks: bool = False,
    spec: PolicySpec | None = None,
) -> PipelineProtocol:
    """Assemble a chunked-tree pipeline with explicit stage knobs (the
    machinery under the cpu-ring / cpu-pbt / hyperloop presets)."""
    cfg = env.cfg
    cache: dict[int, list[int]] = {}

    def chunk_of(sz: int) -> int:
        if chunk is not None:
            return chunk
        if message_chunks:
            return sz
        nchunks = optimal_chunk_count(
            sz, k, strategy, cfg.bytes_per_ns * 1e9,
            per_chunk_overhead_ns * 1e-9,
        )
        return -(-sz // nchunks)

    def chunks_for(sz: int) -> list[int]:
        got = cache.get(sz)
        if got is None:
            got = cache[sz] = _chunk_counts(sz, chunk_of(sz))
        return got

    sinks = {
        r + 1: ChunkedTreeSink(r, k, strategy, per_chunk_overhead_ns,
                               copy_GBps, chunks_for)
        for r in range(k)
    }
    proto = PipelineProtocol(
        env, spec, size, TreeRootInjector(k, config_phase_writes), sinks
    )
    proto.chunk = chunk_of(size)
    return proto


def _spin_write_sinks(spec: PolicySpec) -> dict[int, Stage]:
    hh, ph, ch = HANDLER_NS[spec.auth.handler]
    return {1: SpinStreamSink(1, hh, ch, lambda sink, pkt: ph, ack_tag=1)}


def _spin_tree_sinks(r: Tree) -> dict[int, Stage]:
    key = "repl_ring" if r.strategy == ReplStrategy.RING else "repl_pbt"
    hh, ph, ch = HANDLER_NS[key]
    sinks: dict[int, Stage] = {}
    for rank in range(r.k):
        kids = children_of(rank, r.k, r.strategy)

        def emits(sink, pkt, kids=kids):
            return [Emit(c + 1, pkt.wire_size, dict(pkt.meta)) for c in kids]

        sinks[rank + 1] = SpinStreamSink(
            rank + 1, hh, ch, lambda sink, pkt: ph, emits, ack_tag=rank
        )
    return sinks


def _spin_ec_sinks(e: RS) -> dict[int, Stage]:
    hh, _, ch = HANDLER_NS["ec_data_rs32"]
    header_extra = write_header_extra(e.m)
    sinks: dict[int, Stage] = {}
    for j in range(e.k):

        def ph_ns(sink, pkt, header_extra=header_extra, m=e.m):
            cfg = sink.proto.env.cfg
            payload = (pkt.wire_size - cfg.rdma_header
                       - (header_extra if pkt.meta["i"] == 0 else 0))
            return ec_data_ph_ns(payload, m)

        def emits(sink, pkt, header_extra=header_extra, j=j, k=e.k, m=e.m):
            cfg = sink.proto.env.cfg
            meta = pkt.meta
            i, n = meta["i"], meta["n"]
            payload = (pkt.wire_size - cfg.rdma_header
                       - (header_extra if i == 0 else 0))
            return [
                Emit(
                    k + 1 + pi,
                    cfg.rdma_header + payload,
                    {"rid": meta["rid"], "cl": meta["cl"],
                     "pid": sink.proto.pid, "seq": i, "src": j,
                     "n": n, "last": i == n - 1},
                )
                for pi in range(m)
            ]

        sinks[j + 1] = SpinStreamSink(j + 1, hh, ch, ph_ns, emits,
                                      ack_tag=("d", j))
    for pi in range(e.m):
        sinks[e.k + 1 + pi] = SpinParitySink(e.k + 1 + pi, e.k, ("p", pi))
    return sinks


def ec_read_survivors(e: RS, crashed: set[int]) -> tuple[list[int], int]:
    """Pick the k shard nodes a degraded-rs read fans out to (surviving
    data nodes first, then parities) and the number of data chunks to
    reconstruct.  Raises when fewer than k shards survive."""
    live_data = [n for n in range(1, e.k + 1) if n not in crashed]
    live_parity = [n for n in range(e.k + 1, e.k + e.m + 1)
                   if n not in crashed]
    missing = e.k - len(live_data)
    survivors = live_data + live_parity[:missing]
    if len(survivors) < e.k:
        raise ValueError(
            f"unrecoverable: {len(live_data) + len(live_parity)} of >= "
            f"{e.k} shards survive RS({e.k},{e.m}) under crashes {sorted(crashed)}"
        )
    return survivors, missing


def chain_live_nodes(c: Chain, crashed: set[int]) -> list[int]:
    """The surviving chain, in chain order (head first).  A crash simply
    drops the replica out of the chain — the compile-time analogue of the
    master reconfiguring the chain around the failure.  Raises when no
    replica survives."""
    live = [n for n in range(1, c.k + 1) if n not in crashed]
    if not live:
        raise ValueError(
            f"unrecoverable: all {c.k} chain replicas crashed"
        )
    return live


def _compile_consistency(env: Env, spec: PolicySpec,
                         size: int) -> PipelineProtocol:
    c = spec.consistency
    crashed = env.crashed_nodes()
    cfg = env.cfg

    if isinstance(c, Chain):
        m = getattr(env, "membership", None)
        if m is not None and c.engine == "spin" and spec.op != "read":
            # Detection-driven failover: all k replicas get sinks; chain
            # position, head selection, and epoch fencing resolve per
            # packet from the heartbeat-detected view.  The static
            # chain_live_nodes path below stays the default (and the
            # anchor-exact baseline) when no membership service is
            # attached to the Env.
            chain_nodes = tuple(range(1, c.k + 1))
            sinks = {n: ChainSpinSink(n, None, None, membership=m,
                                      chain_nodes=chain_nodes)
                     for n in chain_nodes}
            seed = getattr(env.failures, "seed", 0) or 0
            return PipelineProtocol(
                env, spec, size,
                ChainWriteInjector(m, chain_nodes, write_header_extra(c.k),
                                   seed=seed),
                sinks,
            )
        chain = chain_live_nodes(c, crashed)
        if spec.op == "read":
            tail = chain[-1]
            serve = chain[0] if c.dirty_read else tail
            sinks: dict[int, Stage] = {n: ChainReadSink(n, tail)
                                       for n in chain}
            return PipelineProtocol(env, spec, size, ReadInjector(serve),
                                    sinks)
        if c.engine == "spin":
            sinks = {}
            for idx, n in enumerate(chain):
                succ = chain[idx + 1] if idx + 1 < len(chain) else None
                pred = chain[idx - 1] if idx > 0 else None
                sinks[n] = ChainSpinSink(n, succ, pred)
            return PipelineProtocol(
                env, spec, size,
                MessageInjector(chain[0], write_header_extra(c.k), acks=1),
                sinks,
            )
        # host engine: chunked store-and-forward down the chain.
        overhead = cfg.pcie_latency_ns / 2 + cfg.host_notify_ns
        cache: dict[int, list[int]] = {}

        def chunks_for(sz: int) -> list[int]:
            got = cache.get(sz)
            if got is None:
                nchunks = optimal_chunk_count(
                    sz, len(chain), ReplStrategy.RING,
                    cfg.bytes_per_ns * 1e9, overhead * 1e-9,
                )
                got = cache[sz] = _chunk_counts(sz, -(-sz // nchunks))
            return got

        sinks = {}
        for idx, n in enumerate(chain):
            succ = chain[idx + 1] if idx + 1 < len(chain) else None
            pred = chain[idx - 1] if idx > 0 else None
            sinks[n] = ChainHostSink(n, succ, pred, overhead,
                                     cfg.host_memcpy_GBps / 2, chunks_for)
        return PipelineProtocol(
            env, spec, size, MessageInjector(chain[0], 0, acks=1), sinks
        )

    # Quorum (ABD): all n replicas participate; a crashed minority is
    # tolerated by the protocol itself (majority completion), so sinks
    # stay bound everywhere and only a crashed majority is unrecoverable.
    assert isinstance(c, Quorum)
    nodes = tuple(range(1, c.n + 1))
    quorum = c.n // 2 + 1
    live = [n for n in nodes if n not in crashed]
    if len(live) < quorum:
        raise ValueError(
            f"unrecoverable: {len(live)} of {c.n} quorum replicas survive "
            f"(< majority {quorum})"
        )
    sinks = {n: AbdSink(n) for n in nodes}
    injector: Stage = (AbdReadInjector(nodes, quorum) if spec.op == "read"
                       else AbdWriteInjector(nodes, quorum))
    return PipelineProtocol(env, spec, size, injector, sinks)


def _compile_read(env: Env, spec: PolicySpec, size: int) -> PipelineProtocol:
    rp = spec.read
    mode = rp.mode if rp is not None else "direct"
    if mode == "direct":
        if spec.transport != "spin" or not isinstance(spec.auth, SpongeAuth):
            raise ValueError("direct read policies currently require the "
                             "spin transport with SpongeAuth")
        hh, ph, _ = HANDLER_NS[spec.auth.handler]
        return PipelineProtocol(
            env, spec, size, ReadInjector(1), {1: SpinReadSink(1, hh, ph)}
        )
    crashed = env.crashed_nodes()
    if mode == "replica-failover":
        r = spec.replication
        if spec.transport != "spin" or not isinstance(spec.auth, SpongeAuth):
            raise ValueError("replica-failover reads currently require the "
                             "spin transport with SpongeAuth")
        live = [n for n in range(1, r.k + 1) if n not in crashed]
        if not live:
            raise ValueError(f"unrecoverable: all {r.k} replicas crashed")
        hh, ph, _ = HANDLER_NS[spec.auth.handler]
        sinks: dict[int, Stage] = {n: SpinReadSink(n, hh, ph) for n in live}
        return PipelineProtocol(env, spec, size, ReadInjector(live[0]), sinks)
    # degraded-rs: fan out to k surviving shards, reconstruct the rest
    e = spec.erasure
    survivors, missing = ec_read_survivors(e, crashed)
    if rp.engine == "spin":
        if spec.transport != "spin" or not isinstance(spec.auth, SpongeAuth):
            raise ValueError("ReadPolicy(engine='spin') requires the spin "
                             "transport with SpongeAuth")
        hh, ph, _ = HANDLER_NS[spec.auth.handler]
        sinks = {n: SpinReadSink(n, hh, ph) for n in survivors}
    else:
        sinks = {n: HostReadSink(n) for n in survivors}
    return PipelineProtocol(
        env, spec, size,
        EcReadInjector(tuple(survivors), e.k, missing, rp.engine), sinks,
    )


def compile_policy(
    env: Env,
    spec: PolicySpec,
    size: int,
    window: int = INEC_WINDOW,
) -> PipelineProtocol:
    """Compile ``spec`` to a timed stage pipeline on ``env``.

    ``size`` is the default request payload (``issue(size=...)`` overrides
    per request); ``window`` is the INEC host-pacing window."""
    spec.validate()
    cfg = env.cfg

    if spec.op in METADATA_OPS:
        return ns_pipeline(env, spec, size)

    if spec.consistency is not None:
        return _compile_consistency(env, spec, size)

    if spec.op == "read":
        return _compile_read(env, spec, size)

    if spec.erasure is not None:
        e = spec.erasure
        if e.engine == "spin":
            proto = PipelineProtocol(
                env, spec, size, InterleavedEcInjector(e.k, e.m),
                _spin_ec_sinks(e),
            )
            return proto
        if e.engine == "inec":
            nodes = tuple(range(1, e.k + e.m + 1))
            proto = PipelineProtocol.__new__(PipelineProtocol)
            # Per-protocol NIC staging/EC engines (as in the hand-written
            # model: INEC chains are private to the posting chain).
            sinks: dict[int, Stage] = {}
            for j in range(e.k):
                sinks[j + 1] = InecDataSink(j, e.k, e.m)
            for pi in range(e.m):
                sinks[e.k + 1 + pi] = InecParitySink(pi, e.k)
            # build resources before attach (sinks resolve them in attach)
            proto.inec_pcie = {
                n: SerialResource(env.sim, name=f"n{n}.inec_pcie")
                for n in nodes
            }
            proto.inec_engine = {
                n: SerialResource(env.sim, name=f"n{n}.inec")
                for n in nodes
            }
            PipelineProtocol.__init__(
                proto, env, spec, size, InecInjector(e.k, e.m, window), sinks
            )
            return proto
        raise ValueError(
            "RS(engine='client') is the checkpoint plane's batched host "
            "encode; it has no timed pipeline"
        )

    if spec.replication is not None:
        r = spec.replication
        if isinstance(r, Flat):
            nodes = tuple(range(1, r.k + 1))
            return PipelineProtocol(
                env, spec, size, FanoutInjector(nodes),
                {n: NicWriteSink(n) for n in nodes},
            )
        if r.engine == "spin":
            return PipelineProtocol(
                env, spec, size,
                MessageInjector(1, write_header_extra(r.k), acks=r.k),
                _spin_tree_sinks(r),
            )
        if r.engine == "host":
            overhead = cfg.pcie_latency_ns / 2 + cfg.host_notify_ns
            return chunked_tree_protocol(
                env, size, r.k, r.strategy, overhead,
                cfg.host_memcpy_GBps / 2, spec=spec,
            )
        if r.engine == "hyperloop":
            return chunked_tree_protocol(
                env, size, r.k, r.strategy, HYPERLOOP_TRIGGER_NS, None,
                message_chunks=True, config_phase_writes=r.k, spec=spec,
            )
        raise ValueError(f"unknown Tree engine {r.engine!r}")

    # plain writes
    if spec.transport == "rdma":
        return PipelineProtocol(
            env, spec, size, MessageInjector(1, 0), {1: NicWriteSink(1)}
        )
    if spec.transport == "spin":
        return PipelineProtocol(
            env, spec, size, MessageInjector(1, write_header_extra()),
            _spin_write_sinks(spec),
        )
    if spec.transport == "rpc":
        assert isinstance(spec.auth, HostAuth)
        if spec.auth.rdma_read:
            return PipelineProtocol(
                env, spec, size, RpcRdmaInjector(1), {1: RpcRdmaSink(1)}
            )
        return PipelineProtocol(
            env, spec, size, MessageInjector(1, write_header_extra()),
            {1: HostCpuSink(1)},
        )
    raise ValueError(f"cannot compile spec: {spec}")
