"""Timed storage-protocol plane: shared Env, policy presets, runners.

The protocols the paper compares (sections IV-VI) —

  writes:      raw RDMA, RPC, RPC+RDMA, sPIN          (Fig. 6)
  replication: RDMA-Flat, RDMA-HyperLoop, CPU-Ring,
               CPU-PBT, sPIN-Ring, sPIN-PBT           (Fig. 9, 10)
  erasure:     INEC-TriEC, sPIN-TriEC                 (Fig. 15)
  reads:       sPIN-Read                              (first read path)

— are *policy presets*: declarative :class:`repro_torch.policy.PolicySpec`
values compiled by :mod:`repro_torch.policy.timed` into timed stage pipelines
over a shared :class:`Env` (one simulator + network + PsPIN units).
Install a compiled policy once, then :meth:`Protocol.issue` any number of
concurrent requests — from any number of client nodes, with per-request
sizes — that contend mechanistically for link ports, HPU pools, and host
CPUs.  Several policies can share one Env (and its storage nodes): every
pipeline packet carries a policy id (``pid``) that the per-node receive
dispatcher demultiplexes on, so mixed-policy scenarios (writes + EC on
the same nodes) compose without stealing each other's packets.

This module keeps the stable surface: the :class:`Env`/:class:`Protocol`
machinery the pipelines are built from, ``make_protocol`` and the
``run_*`` single-shot wrappers (thin shims over the presets), and — via
lazy re-export — the original hand-written protocol classes, now frozen
in :mod:`repro_torch.sim.legacy` as the bit-exactness parity reference.

Node ids: 0 = default client (extra clients use negative ids), 1..k =
storage (data) nodes, k+1..k+m = parity nodes.  All runners return latency
in ns (client request -> client ack(s)) or a sustained rate in GB/s for
the goodput/bandwidth scenarios.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.core.packets import ReplStrategy
from repro_torch.sim.engine import SerialResource, Simulator, make_engine
from repro_torch.sim.network import NetConfig, Network
from repro_torch.sim.pspin import PsPINConfig, PsPINUnit

CLIENT = 0
ACK_WIRE = 28
VERSION_WIRE = 44              # rdma header + 16 B version tag (chain/ABD
                               # version queries, tag responses)
DFS_HEADER_BYTES = 64          # DFSHeader.packed_size()
WRH_BASE_BYTES = 30
RRH_BYTES = 16                 # ReadRequestHeader.packed_size()
REPLICA_COORD_BYTES = 12
HYPERLOOP_CONFIG_WIRE = 156    # WQE descriptor write (HyperLoop [35])
HYPERLOOP_TRIGGER_NS = 300.0   # pre-posted WQE trigger on CQ event
INEC_PCIE_BW_GBPS = 12.0       # NIC <-> host staging bw (PCIe3 x16 practical)
INEC_EC_ENGINE_GBPS = 50.0     # on-NIC EC engine throughput
INEC_TRIGGER_NS = 2500.0       # per-stage triggered-op chain overhead
                               # (WAIT WQE + doorbell + engine dispatch)
INEC_WINDOW = 1                # outstanding blocks: triggered chains are
                               # consumed per block and re-armed by the host
EC_IPC = 0.62                  # calibrated so RS(3,2)/RS(6,3) PH times
                               # match Table II (16.7 us / 23.0 us @ 2 KiB)
HOST_DECODE_GBPS = 6.0         # host-CPU RS reconstruction throughput
                               # (vectorized GF LUT walk, single socket) —
                               # the CPU detour degraded reads pay without
                               # NIC offload


def ec_data_ph_ns(payload: int, m: int) -> float:
    """Data-node encode PH duration: (2m+1) instr/byte at IPC 0.62.

    Anchored to Table II: RS(3,2) -> 16.5 us, RS(6,3) -> 23.1 us per 2 KiB
    packet (measured: 16.681 / 23.018 us).
    """
    return payload * (2 * m + 1) / EC_IPC


def ec_parity_ph_ns(payload: int) -> float:
    """Parity-node XOR PH: ~1 instr/byte at the same IPC (assumption)."""
    return payload / EC_IPC


def ec_decode_ph_ns(payload: int, r: int) -> float:
    """Degraded-read decode PH duration, symmetric to the encode model:
    every surviving shard packet is multiply-accumulated into the ``r``
    missing chunks it reconstructs — (2r+1) instr/byte at the same
    calibrated EC IPC as :func:`ec_data_ph_ns` (``r == m`` erasures cost
    exactly what the streaming encode of ``m`` parities costs)."""
    return payload * (2 * r + 1) / EC_IPC


def write_header_extra(num_replicas: int = 0) -> int:
    return DFS_HEADER_BYTES + WRH_BASE_BYTES + REPLICA_COORD_BYTES * num_replicas


def read_header_extra() -> int:
    return DFS_HEADER_BYTES + RRH_BYTES


@dataclasses.dataclass
class Result:
    latency_ns: float
    extra: dict = dataclasses.field(default_factory=dict)


class Env:
    """One shared simulation world that protocol instances contend over.

    Lazily builds PsPIN units (one per storage node) and host CPUs (one
    serial dispatch+validate engine per storage node), so concurrent
    requests — from one client or many — queue on the same resources.

    Receive dispatch comes in two flavours: the legacy classes claim a
    node *exclusively* (:meth:`claim_node` — one protocol per node), while
    policy pipelines :meth:`bind` under a policy id and share nodes, with
    packets routed by their ``pid`` meta key."""

    def __init__(
        self,
        cfg: NetConfig | None = None,
        pcfg: PsPINConfig | None = None,
        failures=None,
        engine=None,
    ):
        self.cfg = cfg or NetConfig()
        self.pcfg = pcfg
        #: engine spec: None (discrete default), an ``ENGINES`` name,
        #: an :class:`repro_torch.sim.engine.Engine` subclass, or an instance
        self.sim = make_engine(engine)
        self.net = Network(self.sim, self.cfg)
        #: injected :class:`repro_torch.policy.FailureModel` (None == healthy);
        #: crashed/lossy nodes apply at the network, slow nodes stretch
        #: the node's NIC handler compute, and degraded-read pipelines
        #: compile their survivor fan-out against it.
        self.failures = failures
        if failures is not None:
            self.net.set_failures(
                failures.crashed, failures.loss_map, failures.seed,
                partitions=getattr(failures, "partitions", ()),
                flaps=getattr(failures, "flap_map", {}) or {},
                crash_at=getattr(failures, "crash_at", ()),
            )
        #: optional :class:`repro_torch.membership.HeartbeatService` (attach via
        #: :func:`repro_torch.membership.attach_membership`); when present,
        #: chain pipelines compile against *detected* views instead of
        #: the static ``chain_live_nodes`` fan-out.
        self.membership = None
        #: opt-out switch for the flight lane (see :meth:`flight_lane`);
        #: the workload layer clears it when telemetry sampling, a
        #: duration cap, or mixed policies need event-exact interleaving
        self.allow_flight = True
        self._flight = None
        self._pspin: dict[int, PsPINUnit] = {}
        self._cpu: dict[int, SerialResource] = {}
        self._node_owner: dict[int, "Protocol"] = {}
        self._bindings: dict[int, dict[int, Callable]] = {}
        self._next_pid = 0

    def crashed_nodes(self) -> set[int]:
        return set(self.failures.crashed) if self.failures is not None else set()

    def flight_lane(self):
        """The flight lane for this Env, or None when it must not engage.

        Flight (``repro_torch.policy.flight``) computes whole-request schedules
        analytically; it is only valid when nothing can perturb a booked
        schedule after the fact: batched engines, no failure axes, no
        membership service, and the workload layer left
        :attr:`allow_flight` set (no telemetry sampler, no duration cap,
        no mixed policies)."""
        if not (self.sim.batched and self.allow_flight):
            return None
        if self.failures is not None or self.membership is not None:
            return None
        net = self.net
        if net.crashed or net.loss or net.partitions or net.flaps:
            return None
        if self._flight is None:
            from repro_torch.policy.flight import EcFlight

            self._flight = EcFlight(self)
        return self._flight

    def claim_node(self, node: int, proto: "Protocol") -> None:
        """Register ``proto`` as the *exclusive* receive-handler owner of
        ``node`` (legacy protocols): a second protocol installing a handler
        on the same node would silently steal the first one's packets, so
        that is an error.  Shared-node scenarios use :meth:`bind`."""
        if self._bindings.get(node):
            raise ValueError(
                f"node {node} carries policy-pipeline bindings; "
                f"exclusive claim refused"
            )
        owner = self._node_owner.get(node)
        if owner is not None and owner is not proto:
            raise ValueError(
                f"node {node} receive handler already owned by "
                f"{type(owner).__name__}; one protocol per node per Env"
            )
        self._node_owner[node] = proto

    def new_pid(self) -> int:
        """Allocate a policy id for packet demultiplexing."""
        pid = self._next_pid
        self._next_pid += 1
        return pid

    def bind(self, node: int, pid: int, handler: Callable) -> None:
        """Bind ``handler`` for packets carrying ``meta['pid'] == pid`` at
        ``node``.  Many policies may bind the same node (mixed-policy
        contention); the dispatch itself costs no simulated time."""
        if self._node_owner.get(node) is not None:
            raise ValueError(
                f"node {node} receive handler already owned by "
                f"{type(self._node_owner[node]).__name__}; cannot bind"
            )
        table = self._bindings.get(node)
        if table is None:
            table = self._bindings[node] = {}

            def dispatch(pkt, _table=table, _node=node):
                h = _table.get(pkt.meta.get("pid"))
                if h is None:
                    raise ValueError(
                        f"packet with pid {pkt.meta.get('pid')!r} at node "
                        f"{_node} has no bound policy"
                    )
                h(pkt)

            self.net.node(node).on_receive = dispatch
        table[pid] = handler

    def pspin(self, node: int) -> PsPINUnit:
        if node not in self._pspin:
            scale = 1.0
            if self.failures is not None:
                scale = self.failures.slow_map.get(node, 1.0)
            self._pspin[node] = PsPINUnit(self.sim, self.net, node, self.pcfg,
                                          compute_scale=scale)
        return self._pspin[node]

    def host_cpu(self, node: int) -> SerialResource:
        if node not in self._cpu:
            self._cpu[node] = SerialResource(self.sim, name=f"n{node}.cpu")
        return self._cpu[node]

    def pspin_units(self) -> list[PsPINUnit]:
        return list(self._pspin.values())

    def host_cpus(self) -> list[SerialResource]:
        return list(self._cpu.values())


class _Pending:
    """One in-flight request as seen from its client."""

    __slots__ = ("rid", "client", "expected", "acks", "t_issue", "on_done",
                 "extra", "cfg_acks", "size")

    def __init__(self, rid: int, client: int, expected: int, t_issue: float,
                 on_done: Callable[[Result], None] | None):
        self.rid = rid
        self.client = client
        self.expected = expected
        self.acks = 0
        self.t_issue = t_issue
        self.on_done = on_done
        self.extra: dict = {}
        self.cfg_acks = 0
        self.size: int | None = None   # per-request payload (pipelines)


class Protocol:
    """Base per-request factory.

    Subclasses install storage-node receive handlers in ``__init__`` and
    implement :meth:`_start` (schedule the client-side posting/injection of
    one request).  Every packet's ``meta`` carries ``rid`` (globally unique
    per request) and acks are routed back to the issuing client node."""

    #: storage-side node ids this protocol uses (for queue-depth sampling)
    storage_nodes: tuple[int, ...] = (1,)
    #: payload bytes delivered per completed request (goodput accounting)
    request_bytes: int = 0

    def __init__(self, env: Env):
        self.env = env
        self._pending: dict[int, _Pending] = {}
        self._next_rid = 0
        self._clients: set[int] = set()
        self.completed = 0
        self.failed = 0     # requests abandoned (retry exhaustion, no view)
        self.fenced = 0     # stale-epoch packets dropped at a sink
        self.retries = 0    # client re-sends (membership-aware injectors)
        self.last_done_at: float = 0.0

    def _install(self, node: int, handler) -> None:
        """Install a receive handler, guarding against another protocol on
        the same Env silently clobbering it (and vice versa)."""
        self.env.claim_node(node, self)
        self.env.net.node(node).on_receive = handler

    # -- client side --------------------------------------------------------

    def issue(self, client: int = CLIENT,
              on_done: Callable[[Result], None] | None = None,
              size: int | None = None) -> int:
        """Post one request from ``client`` at the current sim time.

        ``size`` overrides the per-request payload where the protocol
        supports it (policy pipelines); the legacy classes ignore it."""
        if client in self.storage_nodes:
            raise ValueError(f"client id {client} collides with storage node")
        if client not in self._clients:
            self._clients.add(client)
            self._install(client, self._on_client_pkt)
        rid = self._next_rid
        self._next_rid += 1
        pend = _Pending(rid, client, 0, self.env.sim.now, on_done)
        pend.size = size
        pend.expected = self._expected_acks_of(pend)
        self._pending[rid] = pend
        self._start(pend)
        return rid

    def in_flight(self) -> int:
        return len(self._pending)

    def _expected_acks(self) -> int:
        return 1

    def _expected_acks_of(self, pend: _Pending) -> int:
        """Per-request ack count (size-dependent for read pipelines)."""
        return self._expected_acks()

    def _on_client_pkt(self, pkt) -> None:
        pend = self._pending.get(pkt.meta.get("rid"))
        if pend is None:
            return
        if pkt.meta.get("cfg_ack"):
            self._on_cfg_ack(pend)
            return
        self._register_ack(pend)

    def _register_ack(self, pend: _Pending) -> None:
        """Count one ack/response unit; completes the request on the last
        one (also the completion hook for decode-gated read pipelines)."""
        pend.acks += 1
        if pend.acks == pend.expected:
            del self._pending[pend.rid]
            self.completed += 1
            sim = self.env.sim
            self.last_done_at = sim.now
            latency = sim.now - pend.t_issue + self.env.cfg.client_complete_ns
            tr = sim.tracer
            if tr is not None and tr.sampled(pend.rid):
                pid = getattr(self, "pid", None)
                t_done = sim.now + self.env.cfg.client_complete_ns
                tr.record("client complete", "client", sim.now, t_done,
                          rid=pend.rid, pid=pid, resource=f"cl{pend.client}")
                tr.record("request", "request", pend.t_issue, t_done,
                          rid=pend.rid, pid=pid, resource=tr.policy_name(pid),
                          args={"latency_ns": latency})
            self._on_request_complete(pend)
            if pend.on_done is not None:
                pend.on_done(Result(latency, pend.extra))

    def _register_failure(self, pend: _Pending, reason: str) -> None:
        """Abandon an in-flight request cleanly (retry exhaustion, empty
        view): the request leaves the pending table, its ``on_done`` fires
        with ``extra["failed"]`` set, and late acks are ignored."""
        if self._pending.pop(pend.rid, None) is None:
            return
        self.failed += 1
        pend.extra["failed"] = reason
        if pend.on_done is not None:
            pend.on_done(Result(self.env.sim.now - pend.t_issue, pend.extra))

    # -- subclass hooks ------------------------------------------------------

    def _start(self, pend: _Pending) -> None:
        raise NotImplementedError

    def _on_cfg_ack(self, pend: _Pending) -> None:  # HyperLoop config phase
        pass

    def _on_request_complete(self, pend: _Pending) -> None:  # INEC pacing
        pass


def _send_message(
    net: Network,
    src: int,
    dst: int,
    payload: int,
    header_extra: int,
    meta_fn,
) -> int:
    """Inject all packets of one message; returns packet count."""
    sizes = net.cfg.packets_of(payload, header_extra)
    n = len(sizes)
    for i, w in enumerate(sizes):
        net.send(src, dst, w, meta_fn(i, n, w))
    return n


def _chunk_counts(size: int, chunk: int) -> list[int]:
    n = -(-size // chunk)
    sizes = [chunk] * n
    sizes[-1] = size - chunk * (n - 1)
    return sizes


# ---------------------------------------------------------------------------
# Protocol registry (used by the workload engine and benchmarks).
# ---------------------------------------------------------------------------


def make_protocol(
    env: Env,
    name: str,
    size: int,
    k: int = 4,
    m: int = 2,
    strategy: ReplStrategy = ReplStrategy.RING,
) -> Protocol:
    """Build a protocol instance by name on a shared :class:`Env`.

    ``size`` is the write/block payload; ``k``/``m``/``strategy`` apply to
    the replication and erasure protocols.

    .. deprecated:: PR 3
       This is a thin alias of the :func:`repro_torch.policy.compile` facade —
       the name is resolved with :func:`repro_torch.policy.preset_spec` and
       compiled onto ``env``.  New callers should use the facade (specs
       compose; names don't)."""
    import repro_torch.policy as policy

    return policy.compile(name, env, size, k=k, m=m, strategy=strategy)


PROTOCOL_NAMES = (
    "raw-write", "spin-write", "rpc-write", "rpc-rdma-write", "rdma-flat",
    "cpu-ring", "cpu-pbt", "hyperloop", "spin-ring", "spin-pbt",
    "spin-triec", "inec-triec",
)


def run_single_shot(
    name: str,
    size: int,
    k: int = 4,
    m: int = 2,
    cfg: NetConfig | None = None,
) -> Result:
    """One-request reference latency for protocol ``name`` via the
    single-shot runners (the N=1 parity baseline used by the contention
    benchmark and the workload tests)."""
    runners: dict[str, Callable[[], Result]] = {
        "raw-write": lambda: run_raw_write(size, cfg=cfg),
        "spin-write": lambda: run_spin_auth_write(size, cfg=cfg),
        "rpc-write": lambda: run_rpc_write(size, cfg=cfg),
        "rpc-rdma-write": lambda: run_rpc_rdma_write(size, cfg=cfg),
        "rdma-flat": lambda: run_rdma_flat(size, k, cfg=cfg),
        "cpu-ring": lambda: run_cpu_ring(size, k, cfg=cfg),
        "cpu-pbt": lambda: run_cpu_pbt(size, k, cfg=cfg),
        "hyperloop": lambda: run_hyperloop(size, k, cfg=cfg),
        "spin-ring": lambda: run_spin_replication(
            size, k, ReplStrategy.RING, cfg=cfg),
        "spin-pbt": lambda: run_spin_replication(
            size, k, ReplStrategy.PBT, cfg=cfg),
        "spin-triec": lambda: run_spin_triec(size, k, m, cfg=cfg),
        "inec-triec": lambda: run_inec_triec(size, k, m, cfg=cfg),
        "spin-read": lambda: run_spin_read(size, cfg=cfg),
        "spin-read-ec": lambda: _run_preset(
            "spin-read-ec", size, k=k, m=m, cfg=cfg)[2],
        "cpu-read-ec": lambda: _run_preset(
            "cpu-read-ec", size, k=k, m=m, cfg=cfg)[2],
        "spin-read-repl": lambda: _run_preset(
            "spin-read-repl", size, k=k, cfg=cfg)[2],
        "chain-spin-write": lambda: _run_preset(
            "chain-spin-write", size, k=k, cfg=cfg)[2],
        "chain-host-write": lambda: _run_preset(
            "chain-host-write", size, k=k, cfg=cfg)[2],
        "chain-spin-read": lambda: _run_preset(
            "chain-spin-read", size, k=k, cfg=cfg)[2],
        "abd-spin-write": lambda: _run_preset(
            "abd-spin-write", size, k=k, cfg=cfg)[2],
        "abd-spin-read": lambda: _run_preset(
            "abd-spin-read", size, k=k, cfg=cfg)[2],
    }
    if name not in runners:
        raise ValueError(
            f"unknown protocol {name!r}; available: {sorted(runners)}"
        )
    return runners[name]()


# ---------------------------------------------------------------------------
# Single-shot runners (original API): one client, sequential requests.
# All are thin shims over the policy presets (deprecation: prefer
# ``compile_policy(env, preset_spec(name, ...), size)`` directly).
# ---------------------------------------------------------------------------


def _run_single(proto: Protocol, env: Env) -> Result:
    out: dict[str, Result] = {}
    proto.issue(CLIENT, on_done=lambda res: out.setdefault("res", res))
    env.sim.run()
    assert "res" in out, "request did not complete"
    return out["res"]


def _run_preset(
    name: str,
    size: int,
    k: int = 4,
    m: int = 2,
    strategy: ReplStrategy = ReplStrategy.RING,
    cfg: NetConfig | None = None,
    pcfg: PsPINConfig | None = None,
    tracer=None,
) -> tuple[Protocol, Env, Result]:
    env = Env(cfg, pcfg)
    if tracer is not None:
        env.sim.tracer = tracer
    proto = make_protocol(env, name, size, k=k, m=m, strategy=strategy)
    res = _run_single(proto, env)
    return proto, env, res


def run_degraded_read(
    name: str,
    size: int,
    k: int = 4,
    m: int = 2,
    failures=None,
    cfg: NetConfig | None = None,
    pcfg: PsPINConfig | None = None,
) -> Result:
    """Single-shot read preset under an injected
    :class:`repro_torch.policy.FailureModel` (None == healthy): the pipeline
    compiles its survivor fan-out / decode stage against the failures."""
    env = Env(cfg, pcfg, failures=failures)
    proto = make_protocol(env, name, size, k=k, m=m)
    return _run_single(proto, env)


def run_under_failures(
    name: str,
    size: int,
    k: int = 4,
    m: int = 2,
    failures=None,
    cfg: NetConfig | None = None,
    pcfg: PsPINConfig | None = None,
) -> Result:
    """Single-shot preset under an injected
    :class:`repro_torch.policy.FailureModel` — the general (read *or* write)
    spelling of :func:`run_degraded_read`: chain pipelines compile their
    survivor chain against the crashes, quorum pipelines complete on the
    surviving majority."""
    return run_degraded_read(name, size, k=k, m=m, failures=failures,
                             cfg=cfg, pcfg=pcfg)


def run_raw_write(size: int, cfg: NetConfig | None = None) -> Result:
    return _run_preset("raw-write", size, cfg=cfg)[2]


def run_spin_auth_write(
    size: int,
    cfg: NetConfig | None = None,
    pcfg: PsPINConfig | None = None,
) -> Result:
    _, env, res = _run_preset("spin-write", size, cfg=cfg, pcfg=pcfg)
    unit = env.pspin(1)
    res.extra.update(
        {"handler_ns": unit.handler_time_ns, "handlers": unit.handler_count}
    )
    return res


def run_spin_read(
    size: int,
    cfg: NetConfig | None = None,
    pcfg: PsPINConfig | None = None,
) -> Result:
    """sPIN read: authenticated request up, data streamed back by the NIC."""
    return _run_preset("spin-read", size, cfg=cfg, pcfg=pcfg)[2]


def run_rpc_write(size: int, cfg: NetConfig | None = None) -> Result:
    return _run_preset("rpc-write", size, cfg=cfg)[2]


def run_rpc_rdma_write(size: int, cfg: NetConfig | None = None) -> Result:
    return _run_preset("rpc-rdma-write", size, cfg=cfg)[2]


def run_rdma_flat(size: int, k: int, cfg: NetConfig | None = None) -> Result:
    return _run_preset("rdma-flat", size, k=k, cfg=cfg)[2]


def run_chunked_tree(
    size: int,
    k: int,
    strategy: ReplStrategy,
    per_chunk_overhead_ns: float,
    copy_GBps: float | None,
    chunk: int | None = None,
    cfg: NetConfig | None = None,
    config_phase_writes: int = 0,
) -> Result:
    """Generic chunked-tree runner with explicit stage knobs (the escape
    hatch under the cpu-ring / cpu-pbt / hyperloop presets)."""
    from repro_torch.policy.timed import chunked_tree_protocol

    env = Env(cfg)
    proto = chunked_tree_protocol(
        env, size, k, strategy, per_chunk_overhead_ns, copy_GBps,
        chunk=chunk, config_phase_writes=config_phase_writes,
    )
    res = _run_single(proto, env)
    res.extra["chunk"] = proto.chunk
    return res


def run_cpu_ring(size: int, k: int, cfg: NetConfig | None = None) -> Result:
    # Per-chunk host notify + PCIe; data moves *to and from* host memory
    # (two traversals => half the effective single-copy bandwidth) — the
    # paper's stated penalty for CPU-based strategies.
    proto, _, res = _run_preset(
        "cpu-ring", size, k=k, strategy=ReplStrategy.RING, cfg=cfg)
    res.extra["chunk"] = proto.chunk
    return res


def run_cpu_pbt(size: int, k: int, cfg: NetConfig | None = None) -> Result:
    proto, _, res = _run_preset(
        "cpu-pbt", size, k=k, strategy=ReplStrategy.PBT, cfg=cfg)
    res.extra["chunk"] = proto.chunk
    return res


def run_hyperloop(size: int, k: int, cfg: NetConfig | None = None) -> Result:
    # HyperLoop's pre-posted WQE chains trigger on *message* completion
    # (WAIT on CQE -> RDMA WRITE of the full received buffer), so the ring
    # is store-and-forward at message granularity; the client pays an
    # explicit configuration phase first (Fig. 8).
    proto, _, res = _run_preset("hyperloop", size, k=k, cfg=cfg)
    res.extra["chunk"] = proto.chunk
    return res


def run_spin_replication(
    size: int,
    k: int,
    strategy: ReplStrategy,
    cfg: NetConfig | None = None,
    pcfg: PsPINConfig | None = None,
    num_writes: int = 1,
    measure: str = "latency",
) -> Result:
    """sPIN-Ring / sPIN-PBT single-shot runner.

    ``num_writes > 1`` streams back-to-back writes for the goodput plot
    (Fig. 9 right): returns ingested GB/s at the primary in ``extra``.
    """
    env = Env(cfg, pcfg)
    proto = make_protocol(env, "spin-repl", size, k=k, strategy=strategy)
    cfg = env.cfg
    for w in range(num_writes):
        # back-to-back posts: one batched WQE every client_post_extra_ns
        env.sim.at(w * cfg.client_post_extra_ns, lambda: proto.issue(CLIENT))
    env.sim.run()
    assert proto.completed == num_writes
    res = Result(proto.last_done_at + cfg.client_complete_ns)
    if num_writes > 1:
        primary = env.pspin(1)
        ingested = size * num_writes
        res.extra["goodput_GBps"] = ingested / proto.last_done_at
        res.extra["hpu_peak"] = primary.hpus.peak
        res.extra["stall_ns"] = primary.stall_time_ns
        res.extra["mean_handler_ns"] = (
            primary.handler_time_ns / max(1, primary.handler_count)
        )
    return res


def run_spin_triec(
    block: int,
    k: int,
    m: int,
    cfg: NetConfig | None = None,
    pcfg: PsPINConfig | None = None,
    num_blocks: int = 1,
) -> Result:
    env = Env(cfg, pcfg)
    proto = make_protocol(env, "spin-triec", block, k=k, m=m)
    for _ in range(num_blocks):
        proto.issue(CLIENT)
    env.sim.run()
    assert proto.completed == num_blocks
    res = Result(proto.last_done_at + env.cfg.client_complete_ns)
    if num_blocks > 1:
        elapsed = proto.last_done_at - proto.first_inject_ns
        res.extra["bandwidth_GBps"] = block * num_blocks / elapsed
    return res


def run_inec_triec(
    block: int,
    k: int,
    m: int,
    cfg: NetConfig | None = None,
    num_blocks: int = 1,
) -> Result:
    env = Env(cfg)
    proto = make_protocol(env, "inec-triec", block, k=k, m=m)
    for _ in range(num_blocks):
        proto.issue(CLIENT)
    env.sim.run()
    assert proto.completed == num_blocks
    res = Result(proto.last_done_at + env.cfg.client_complete_ns)
    if num_blocks > 1:
        elapsed = proto.last_done_at - proto.first_inject_ns
        res.extra["bandwidth_GBps"] = block * num_blocks / elapsed
    return res


# ---------------------------------------------------------------------------
# Goodput of non-replicated sPIN writes (Fig. 9 right baseline).
# ---------------------------------------------------------------------------


def run_spin_goodput(
    size: int,
    k: int,
    strategy: ReplStrategy,
    num_writes: int = 64,
    cfg: NetConfig | None = None,
    pcfg: PsPINConfig | None = None,
) -> float:
    res = run_spin_replication(
        size, k, strategy, cfg=cfg, pcfg=pcfg, num_writes=num_writes
    )
    return res.extra["goodput_GBps"]


# ---------------------------------------------------------------------------
# Lazy re-export of the frozen hand-written classes (parity reference).
# ---------------------------------------------------------------------------

_LEGACY_CLASSES = (
    "RawWriteProtocol", "SpinAuthWriteProtocol", "RpcWriteProtocol",
    "RpcRdmaWriteProtocol", "RdmaFlatProtocol", "ChunkedTreeProtocol",
    "SpinReplicationProtocol", "SpinTriecProtocol", "InecTriecProtocol",
)


def __getattr__(name: str):
    if name in _LEGACY_CLASSES:
        from repro_torch.sim import legacy

        return getattr(legacy, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
