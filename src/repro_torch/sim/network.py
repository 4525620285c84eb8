"""Network + host model for the multi-node simulation.

Matches the paper's SST configuration (section III-D): 400 Gbit/s links,
MTU 2048 B, 20 ns link latency.  Store-and-forward at both endpoints: a
packet occupies the sender's egress port for its serialization time,
propagates, then occupies the receiver's ingress port — so endpoint
contention (k replication streams converging on a parity node, a client
injecting k RDMA-Flat copies) emerges mechanistically.

Host-side constants model the CPU data path the paper compares against:
PCIe round-trip latency (up to 400 ns, [25]), an RPC delivery overhead
(NIC->host doorbell + cache miss + dispatch), a single-core memcpy
bandwidth for RPC buffering, and a fixed CPU request-validation cost
mirroring the 200-cycle NIC handler check.

Fault injection axes (all seeded/deterministic, all counted — no silent
loss): ``crashed`` blackholes a node in both directions, ``loss`` drops
toward a node with a probability, ``partitions`` cut a node group from
the rest for a time window, ``flaps`` make a node unreachable for a duty
fraction of every period (gray failure), and ``crash_at`` crashes a node
mid-run at a scheduled time.  Packets with ``meta["ctrl"]`` (heartbeats,
view management) are booked in separate ``ctrl_*`` counters so control
traffic never pollutes data goodput/loss accounting.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Callable

from repro_torch.sim.engine import SerialResource, Simulator


@dataclasses.dataclass
class NetConfig:
    bandwidth_gbps: float = 400.0
    mtu: int = 2048
    link_latency_ns: float = 20.0
    rdma_header: int = 28
    # Host-side (CPU data path) parameters:
    pcie_latency_ns: float = 400.0       # round-trip, [25]
    host_notify_ns: float = 250.0        # doorbell/poll + dispatch to handler
    host_memcpy_GBps: float = 25.0       # single-stream buffering copy
    cpu_validate_ns: float = 200.0       # request validation on CPU
    nic_fixed_ns: float = 100.0          # plain-RDMA NIC processing / message
    # Client-side costs (symmetric across all protocols): software post +
    # doorbell + WQE/SGE fetch; CQE DMA + completion poll.  Anchors the raw
    # write at ~1.8 us for 1 KiB (typical measured RDMA write latency,
    # Kalia et al. [25]), which makes the paper's "sPIN <= 27% over raw for
    # small writes" ratio meaningful.
    client_post_ns: float = 1100.0
    client_post_extra_ns: float = 150.0  # per additional batched WQE
    client_complete_ns: float = 600.0    # CQE landing + poll at the client

    @property
    def bytes_per_ns(self) -> float:
        return self.bandwidth_gbps / 8.0  # GB/s == bytes/ns

    def ser_ns(self, nbytes: float) -> float:
        return nbytes / self.bytes_per_ns

    def memcpy_ns(self, nbytes: float) -> float:
        return nbytes / self.host_memcpy_GBps

    def packets_of(self, payload: int, header_extra: int = 0) -> list[int]:
        """Wire sizes of the packets of a message with ``payload`` bytes.

        ``header_extra``: DFS+WRH bytes on the first packet.
        """
        sizes = []
        first_cap = self.mtu - self.rdma_header - header_extra
        rest_cap = self.mtu - self.rdma_header
        remaining = payload
        take = min(remaining, first_cap)
        sizes.append(self.rdma_header + header_extra + take)
        remaining -= take
        while remaining > 0:
            take = min(remaining, rest_cap)
            sizes.append(self.rdma_header + take)
            remaining -= take
        return sizes


@dataclasses.dataclass
class SimPacket:
    src: int
    dst: int
    wire_size: int
    meta: dict


class SimNode:
    """A network endpoint: egress/ingress ports + receive dispatch."""

    def __init__(self, sim: Simulator, cfg: NetConfig, node_id: int):
        self.sim = sim
        self.cfg = cfg
        self.node_id = node_id
        self.egress = SerialResource(sim, name=f"n{node_id}.egress")
        self.ingress = SerialResource(sim, name=f"n{node_id}.ingress")
        self.on_receive: Callable[[SimPacket], None] = lambda pkt: None
        self.bytes_in = 0
        self.bytes_out = 0


class Network:
    """Packet transport with failure injection; see the module docstring
    for the fault axes.  Every dropped packet is counted (data in
    ``packets_dropped``/``bytes_dropped``, control in the ``ctrl_*``
    twins) so workload metrics can account for lost bytes."""

    def __init__(self, sim: Simulator, cfg: NetConfig):
        self.sim = sim
        self.cfg = cfg
        self.nodes: dict[int, SimNode] = {}
        self.packets_sent = 0
        self.packets_dropped = 0
        self.bytes_dropped = 0
        self.ctrl_packets_sent = 0
        self.ctrl_bytes_sent = 0
        self.ctrl_packets_dropped = 0
        self.ctrl_bytes_dropped = 0
        self.crashed: set[int] = set()
        self.loss: dict[int, float] = {}
        #: ((start_ns, end_ns, frozenset(group)), ...) — during the
        #: window, packets crossing the group boundary are cut
        self.partitions: tuple[tuple[float, float, frozenset], ...] = ()
        #: {node: (period_ns, duty, phase_ns)} — the node is unreachable
        #: (both directions) for the first ``duty`` fraction of each period
        self.flaps: dict[int, tuple[float, float, float]] = {}
        self._loss_rng = random.Random(0)

    def set_failures(
        self,
        crashed=(),
        loss: dict[int, float] | None = None,
        seed: int = 0,
        partitions=(),
        flaps: dict[int, tuple[float, float, float]] | None = None,
        crash_at=(),
    ) -> None:
        self.crashed = set(crashed)
        self.loss = dict(loss or {})
        self.partitions = tuple(
            (float(s), float(e), frozenset(grp)) for s, e, grp in partitions
        )
        self.flaps = dict(flaps or {})
        self._loss_rng = random.Random(seed)
        for t, node in crash_at:
            self.sim.at(float(t), lambda n=node: self.crashed.add(n))

    def cut(self, a: int, b: int) -> bool:
        """Is the a<->b path severed right now by a partition or flap?"""
        now = self.sim.now
        for start, end, grp in self.partitions:
            if start <= now < end and ((a in grp) != (b in grp)):
                return True
        for n in (a, b):
            f = self.flaps.get(n)
            if f is not None:
                period, duty, phase = f
                if ((now - phase) % period) < duty * period:
                    return True
        return False

    def node(self, node_id: int) -> SimNode:
        if node_id not in self.nodes:
            self.nodes[node_id] = SimNode(self.sim, self.cfg, node_id)
        return self.nodes[node_id]

    def _trace_ctx(self, meta: dict):
        """Wire-bucket trace context for a sampled packet (None when
        tracing is off, the packet carries no request id, or the request
        is sampled out — the zero-cost-when-off guard)."""
        tr = self.sim.tracer
        if tr is None:
            return None
        rid = meta.get("rid")
        if rid is None or not tr.sampled(rid):
            return None
        return (rid, meta.get("pid"), "wire")

    def _trace_link(self, trace, src: int, dst: int, t0: float, ctrl: bool) -> None:
        """Record the link-propagation leg [egress end, arrival)."""
        rid, pid, _ = trace
        self.sim.tracer.record(
            "link", "wire", t0, t0 + self.cfg.link_latency_ns, rid=rid, pid=pid,
            resource=f"n{src}->n{dst}", args={"ctrl": True} if ctrl else None,
        )

    def _count_drop(self, wire_size: int, ctrl: bool) -> None:
        if ctrl:
            self.ctrl_packets_dropped += 1
            self.ctrl_bytes_dropped += wire_size
        else:
            self.packets_dropped += 1
            self.bytes_dropped += wire_size

    def send(
        self,
        src: int,
        dst: int,
        wire_size: int,
        meta: dict | None = None,
        on_sent: Callable[[], None] | None = None,
    ) -> None:
        """Transmit one packet src -> dst.

        ``on_sent`` fires when the sender's egress finishes serializing
        (the moment a NIC handler that blocks on egress can retire).  On
        batched engines it may also be a pre-bound ``(fn, args)`` record
        (the closure-free lane); either form fires at the same time.
        """
        if self.sim.batched:
            return self._send_batched(src, dst, wire_size, meta, on_sent)
        meta = meta or {}
        ctrl = bool(meta.get("ctrl"))
        if src in self.crashed or dst in self.crashed:
            # A crashed endpoint neither sends nor receives; the sender's
            # handler (if any) retires immediately — its DMA completes
            # into the void.
            self._count_drop(wire_size, ctrl)
            if on_sent is not None:
                self.sim.after(0.0, on_sent)
            return
        # Loss (and partition/flap cuts) are decided at send time
        # (deterministic event order) but take effect after egress: the
        # sender still pays serialization.
        p = self.loss.get(dst, 0.0)
        lost = (p > 0.0 and self._loss_rng.random() < p) or self.cut(src, dst)
        s, d = self.node(src), self.node(dst)
        ser = self.cfg.ser_ns(wire_size)
        s.bytes_out += wire_size
        if ctrl:
            self.ctrl_packets_sent += 1
            self.ctrl_bytes_sent += wire_size
        else:
            self.packets_sent += 1

        trace = self._trace_ctx(meta)

        def after_egress(start: float, end: float) -> None:
            if on_sent is not None:
                on_sent()
            if lost:
                self._count_drop(wire_size, ctrl)
                return
            if trace is not None:
                self._trace_link(trace, src, dst, end, ctrl)
            arrive = end + self.cfg.link_latency_ns

            def at_ingress() -> None:
                def delivered(_s: float, _e: float) -> None:
                    d.bytes_in += wire_size
                    d.on_receive(SimPacket(src, dst, wire_size, meta))

                d.ingress.acquire(ser, delivered, trace=trace)

            self.sim.at(arrive, at_ingress)

        s.egress.acquire(ser, after_egress, trace=trace)

    def _send_batched(self, src, dst, wire_size, meta, on_sent) -> None:
        """:meth:`send` for batched engines: the egress interval is booked
        synchronously and the arrival/delivery steps are scheduled as
        pre-bound module-level functions — same timeline as the discrete
        closure chain (on_sent at egress end, loss counted at egress end,
        ingress FIFO acquired at arrival), zero closures per packet."""
        sim = self.sim
        if meta is None:
            meta = {}
        ctrl = bool(meta.get("ctrl"))
        if self.crashed and (src in self.crashed or dst in self.crashed):
            self._count_drop(wire_size, ctrl)
            if on_sent is not None:
                if type(on_sent) is tuple:
                    sim.call(sim.now, on_sent[0], on_sent[1])
                else:
                    sim.call(sim.now, on_sent)
            return
        if self.loss:
            p = self.loss.get(dst, 0.0)
            lost = (p > 0.0 and self._loss_rng.random() < p)
        else:
            lost = False
        if (self.partitions or self.flaps) and not lost:
            lost = self.cut(src, dst)
        s = self.node(src)
        ser = self.cfg.ser_ns(wire_size)
        s.bytes_out += wire_size
        if ctrl:
            self.ctrl_packets_sent += 1
            self.ctrl_bytes_sent += wire_size
        else:
            self.packets_sent += 1
        trace = self._trace_ctx(meta)
        _start, end = s.egress.book(ser, trace=trace)
        if on_sent is not None:
            if type(on_sent) is tuple:
                sim.call(end, on_sent[0], on_sent[1])
            else:
                sim.call(end, on_sent)
        if lost:
            sim.call(end, self._count_drop, (wire_size, ctrl))
        else:
            if trace is not None:
                self._trace_link(trace, src, dst, end, ctrl)
            sim.call(
                end + self.cfg.link_latency_ns,
                _net_arrive,
                (self.node(dst), ser, src, dst, wire_size, meta),
            )


def _net_arrive(d: SimNode, ser, src, dst, wire_size, meta) -> None:
    """Batched-lane arrival step: occupy the receiver's ingress FIFO."""
    trace = None
    tr = d.sim.tracer
    if tr is not None:
        rid = meta.get("rid")
        if rid is not None and tr.sampled(rid):
            trace = (rid, meta.get("pid"), "wire")
    _start, end = d.ingress.book(ser, trace=trace)
    d.sim.call(end, _net_deliver, (d, src, dst, wire_size, meta))


def _net_deliver(d: SimNode, src, dst, wire_size, meta) -> None:
    """Batched-lane delivery step: hand the packet to receive dispatch."""
    d.bytes_in += wire_size
    d.on_receive(SimPacket(src, dst, wire_size, meta))
