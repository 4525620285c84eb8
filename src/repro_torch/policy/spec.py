"""Declarative storage-policy specs: the building blocks, as data.

The paper's thesis is that DFS storage policies are *composable building
blocks* on the NIC data path: authentication (section IV), replication
(section V), and erasure coding (section VI) stack onto a base transport
and are recombined per deployment.  :class:`PolicySpec` is that idea as a
value: one small declarative record naming each stage, which every plane
of the reproduction compiles for itself:

  * ``repro_torch.policy.timed``      -> a timed stage pipeline over a shared
    simulation :class:`~repro_torch.sim.protocols.Env` (latency/goodput studies);
  * ``repro_torch.policy.functional`` -> the byte-accurate handler pipeline of
    ``repro_torch.core.handlers`` (Listing 1, actual payload bytes);
  * ``repro_torch.checkpoint``        -> the checkpoint plane's shard encoding
    (client-batched RS via ``RSCode.encode_stripes`` or NIC streaming).

Stage vocabulary (paper section in parentheses):

  transport    "rdma" (plain one-sided write), "rpc" (host-CPU delivery),
               or "spin" (per-packet NIC handlers, section II-B)
  auth         :class:`NoAuth`, :class:`SpongeAuth` (on-NIC capability
               check, section IV), :class:`HostAuth` (CPU validation; with
               ``rdma_read`` it is the validate-then-RDMA-read of Fig. 5)
  replication  :class:`Flat` (client fan-out), :class:`Tree` (chunked
               ring/PBT broadcast, section V; ``engine`` picks the
               forwarding plane: "spin", "host", or "hyperloop")
  erasure      :class:`RS` (RS(k, m), section VI; ``engine`` picks "spin"
               streaming, "inec" chunk-granularity offload, or "client"
               batched host encode via ``RSCode.encode_stripes``)
  consistency  :class:`Chain` (CRAQ-style chain replication: head->tail
               forwarding, commit at the tail, acks back up the chain,
               reads from any replica) or :class:`Quorum` (ABD quorum
               read/write); ``None`` keeps the fire-and-forget
               replication stages as the baseline
  op           "write" or "read" (read path: request up, data stream back)

The 12 hand-written protocol simulators of ``repro_torch.sim.legacy`` are the
:data:`PRESETS` of this module; ``repro_torch.sim.protocols.make_protocol`` and
the ``run_*`` wrappers are thin shims over them.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.packets import ReplStrategy

TRANSPORTS = ("rdma", "rpc", "spin")
OPS = ("write", "read", "lookup", "open", "commit")
#: namespace RPCs (the metadata plane): small fixed-size request/reply
#: pairs against the NameNode, costed either as NIC handlers
#: (``HANDLER_NS["ns_*"]``) or as a host-CPU RPC detour.  They carry no
#: data payload and book their wire bytes as *control* traffic.
METADATA_OPS = ("lookup", "open", "commit")


@dataclasses.dataclass(frozen=True)
class NoAuth:
    """No request validation: the raw-RDMA speed-of-light baseline."""


@dataclasses.dataclass(frozen=True)
class SpongeAuth:
    """Section IV: on-NIC capability validation (sponge MAC) in the
    header handler; payload handlers are gated on its completion."""

    handler: str = "auth"  # HANDLER_NS key for the (HH, PH, CH) costs


@dataclasses.dataclass(frozen=True)
class HostAuth:
    """Host-CPU request validation (the RPC baselines of Fig. 6).

    ``rdma_read=True`` is the RPC+RDMA hybrid of Fig. 5: validate via RPC,
    then RDMA-read the payload from the client."""

    rdma_read: bool = False


@dataclasses.dataclass(frozen=True)
class Flat:
    """Section V baseline: the client fans out one write per replica."""

    k: int = 2


@dataclasses.dataclass(frozen=True)
class Tree:
    """Section V: broadcast along a ring / perfectly-balanced tree.

    ``engine`` selects the forwarding plane: "spin" (per-packet NIC
    handlers), "host" (chunked store-and-forward through host memory), or
    "hyperloop" (pre-posted WQE chains with a client config phase)."""

    k: int = 2
    strategy: ReplStrategy = ReplStrategy.RING
    engine: str = "spin"


@dataclasses.dataclass(frozen=True)
class RS:
    """Section VI: RS(k, m) erasure coding.

    ``engine``: "spin" (streaming per-packet TriEC encode), "inec"
    (chunk-granularity NIC engine with host staging), or "client"
    (host-side batched encode through ``RSCode.encode_stripes`` — the
    checkpoint plane's bulk path; not a timed-sim engine)."""

    k: int = 4
    m: int = 2
    engine: str = "spin"


@dataclasses.dataclass(frozen=True)
class Chain:
    """Consistency axis: chain replication with CRAQ-style reads.

    Writes enter at the head, forward replica-to-replica down the chain,
    and *commit* at the tail (the version bump); acks propagate back up
    the chain marking the version clean, so the client's ack means every
    replica holds the committed version.  Reads go to *any* replica
    (CRAQ): a clean object is served locally, a dirty one first resolves
    the committed version with a small round-trip to the tail
    (``dirty_read=True``); ``dirty_read=False`` is classic chain
    replication — only the tail serves reads, no version query.

    ``engine`` picks the forwarding plane: "spin" (per-packet NIC
    handlers, the offloaded path) or "host" (chunked store-and-forward
    through host memory — the CPU baseline the replication claim is
    measured against)."""

    k: int = 3
    dirty_read: bool = True
    engine: str = "spin"


@dataclasses.dataclass(frozen=True)
class Quorum:
    """Consistency axis: ABD-style quorum register over ``n`` replicas.

    Writes are two round-trips (query the majority's max version tag,
    then write tag+1 to a majority); reads query a majority for the
    highest tagged value and write it back to a majority before
    returning (the ABD read write-back).  No replica is special, so a
    minority of crashed/lossy/straggling replicas never blocks an
    operation — the availability story chain replication buys with
    reconfiguration, bought with quorums instead."""

    n: int = 3
    engine: str = "spin"


_CHAIN_ENGINES = ("spin", "host")
_QUORUM_ENGINES = ("spin",)


@dataclasses.dataclass(frozen=True)
class ReadPolicy:
    """How a read policy behaves when storage nodes are unavailable.

    ``mode``:

      direct           read one extent from one node (the spin-read
                       baseline; no resiliency stage on the spec)
      degraded-rs      the object is RS(k, m)-striped; the read fans out
                       to k surviving shards (data first, then parity)
                       and reconstructs missing data chunks
      replica-failover the object is k-way replicated; the read targets
                       the first surviving replica

    ``engine`` picks the reconstruction locus for degraded-rs: "spin"
    runs a per-packet decode stage on the client NIC's HPUs (cost model
    symmetric to the SpinStream encode handlers), "host" stages all
    shards through client host memory and decodes on the (serial) CPU —
    the host-CPU detour the paper's offloads avoid."""

    mode: str = "direct"        # direct | degraded-rs | replica-failover
    engine: str = "spin"        # spin | host (degraded-rs decode locus)


_READ_MODES = ("direct", "degraded-rs", "replica-failover")
_READ_ENGINES = ("spin", "host")


@dataclasses.dataclass(frozen=True)
class FailureModel:
    """Injected storage-node failures, attached to a workload Scenario.

    ``crashed``: node ids that are gone — every packet to (or from) them
    is blackholed and counted as dropped.  ``loss``: per-node ingress
    packet-loss probabilities ``(node, p)`` — packets still occupy the
    sender's egress port, then vanish (a lossy link/NIC).  ``slow``:
    straggler factors ``(node, f)`` — the node's NIC handler compute
    runs ``f``x slower (a thermally-throttled / contended PsPIN unit).
    ``seed`` drives the deterministic loss draw.

    Detection-era axes (PR 7): ``partitions`` are time-windowed group
    cuts ``(start_ns, end_ns, (nodes...))`` — during the window no
    packet crosses the group boundary in either direction; ``flap`` is
    gray failure ``(node, period_ns, duty)`` — the node is unreachable
    for the first ``duty`` fraction of every period; ``crash_at``
    schedules mid-run crashes ``(t_ns, node)``.  None of these are
    visible to any protocol except through missed heartbeats."""

    crashed: tuple[int, ...] = ()
    loss: tuple[tuple[int, float], ...] = ()
    slow: tuple[tuple[int, float], ...] = ()
    partitions: tuple[tuple[float, float, tuple[int, ...]], ...] = ()
    flap: tuple[tuple[int, float, float], ...] = ()
    crash_at: tuple[tuple[float, int], ...] = ()
    seed: int = 0

    def __post_init__(self):
        for node, p in self.loss:
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"loss probability {p} for node {node} "
                                 "outside [0, 1]")
        for node, f in self.slow:
            if f < 1.0:
                raise ValueError(f"slowdown factor {f} for node {node} "
                                 "must be >= 1")
        for start, end, grp in self.partitions:
            if not (start < end and grp):
                raise ValueError(f"bad partition window ({start}, {end}, "
                                 f"{grp})")
        for node, period, duty in self.flap:
            if period <= 0 or not 0.0 < duty < 1.0:
                raise ValueError(f"bad flap ({node}, {period}, {duty}): "
                                 "need period > 0 and duty in (0, 1)")
        for t, _node in self.crash_at:
            if t < 0:
                raise ValueError(f"crash_at time {t} must be >= 0")

    @property
    def loss_map(self) -> dict[int, float]:
        return dict(self.loss)

    @property
    def slow_map(self) -> dict[int, float]:
        return dict(self.slow)

    @property
    def flap_map(self) -> dict[int, tuple[float, float, float]]:
        """{node: (period, duty, phase)} for :meth:`Network.set_failures`."""
        return {node: (period, duty, 0.0) for node, period, duty in self.flap}

    def is_healthy(self) -> bool:
        return not (self.crashed or self.loss or self.slow
                    or self.partitions or self.flap or self.crash_at)


_TREE_ENGINES = ("spin", "host", "hyperloop")
_RS_ENGINES = ("spin", "inec", "client")


@dataclasses.dataclass(frozen=True)
class PolicySpec:
    """One storage policy: transport x auth x replication x erasure x op.

    Example::

        PolicySpec(transport="spin", auth=SpongeAuth(),
                   replication=Tree(k=8, strategy=ReplStrategy.PBT),
                   op="write")
    """

    transport: str = "rdma"
    auth: NoAuth | SpongeAuth | HostAuth = NoAuth()
    replication: Flat | Tree | None = None
    erasure: RS | None = None
    op: str = "write"
    read: ReadPolicy | None = None  # read-path behavior (op == "read")
    #: consistency axis: :class:`Chain` (CRAQ chain replication) or
    #: :class:`Quorum` (ABD); ``None`` keeps the fire-and-forget
    #: replication/erasure stages as the baseline.
    consistency: Chain | Quorum | None = None
    name: str | None = None  # preset name (reports / registries)

    def __post_init__(self):
        self.validate()

    # -- structure ----------------------------------------------------------

    def validate(self) -> None:
        if self.transport not in TRANSPORTS:
            raise ValueError(f"unknown transport {self.transport!r}")
        if self.op not in OPS:
            raise ValueError(f"unknown op {self.op!r}")
        if self.replication is not None and self.erasure is not None:
            raise ValueError("replication and erasure stages are exclusive "
                             "(nest objects instead)")
        if self.op in METADATA_OPS:
            if (self.replication is not None or self.erasure is not None
                    or self.consistency is not None or self.read is not None):
                raise ValueError(
                    "metadata ops are namespace RPCs against the NameNode; "
                    "they carry no replication/erasure/consistency/read "
                    "stages"
                )
            if self.transport == "rdma":
                raise ValueError(
                    "metadata ops need request validation and a namespace "
                    "walk: use spin (NIC handler) or rpc (host CPU), not "
                    "raw rdma"
                )
        if isinstance(self.auth, HostAuth) and self.transport != "rpc":
            raise ValueError("HostAuth requires the rpc transport")
        if self.transport == "rpc" and not isinstance(self.auth, HostAuth):
            raise ValueError("rpc transport requires HostAuth")
        if isinstance(self.auth, SpongeAuth) and self.transport != "spin":
            raise ValueError(
                "SpongeAuth runs in NIC handlers; it requires the spin "
                "transport"
            )
        if self.transport == "spin" and not isinstance(self.auth, SpongeAuth):
            raise ValueError(
                "spin transport requires SpongeAuth (the NIC handler "
                "pipeline validates every request)"
            )
        if isinstance(self.replication, Tree):
            if self.replication.engine not in _TREE_ENGINES:
                raise ValueError(
                    f"unknown Tree engine {self.replication.engine!r}")
            if self.replication.engine == "spin" and self.transport != "spin":
                raise ValueError("Tree(engine='spin') requires spin transport")
        if self.erasure is not None:
            if self.erasure.engine not in _RS_ENGINES:
                raise ValueError(f"unknown RS engine {self.erasure.engine!r}")
            if (self.erasure.engine == "spin" and self.transport != "spin"
                    and self.op != "read"):
                raise ValueError("RS(engine='spin') requires spin transport")
        if self.consistency is not None:
            c = self.consistency
            if self.replication is not None or self.erasure is not None:
                raise ValueError(
                    "the consistency stage carries its own replica set; "
                    "it is exclusive with replication/erasure stages"
                )
            if self.read is not None:
                raise ValueError(
                    "consistency protocols define their own read "
                    "semantics; drop the ReadPolicy stage"
                )
            if isinstance(c, Chain):
                if c.engine not in _CHAIN_ENGINES:
                    raise ValueError(f"unknown Chain engine {c.engine!r}")
                if c.k < 1:
                    raise ValueError(f"Chain needs k >= 1, got {c.k}")
                if c.engine == "spin" and self.transport != "spin":
                    raise ValueError(
                        "Chain(engine='spin') requires the spin transport")
                if c.engine == "host" and self.transport != "rdma":
                    raise ValueError(
                        "Chain(engine='host') is the plain-RDMA + host-CPU "
                        "forwarding baseline; it requires the rdma transport"
                    )
                if c.engine == "host" and self.op == "read":
                    raise ValueError(
                        "chain reads are only compiled for the spin engine")
            elif isinstance(c, Quorum):
                if c.engine not in _QUORUM_ENGINES:
                    raise ValueError(f"unknown Quorum engine {c.engine!r}")
                if c.n < 1:
                    raise ValueError(f"Quorum needs n >= 1, got {c.n}")
                if self.transport != "spin":
                    raise ValueError(
                        "Quorum(engine='spin') requires the spin transport")
            else:
                raise ValueError(f"unknown consistency stage {c!r}")
        if self.read is not None:
            if self.op != "read":
                raise ValueError("ReadPolicy only applies to op='read'")
            if self.read.mode not in _READ_MODES:
                raise ValueError(f"unknown read mode {self.read.mode!r}")
            if self.read.engine not in _READ_ENGINES:
                raise ValueError(
                    f"unknown read decode engine {self.read.engine!r}")
        if self.op == "read":
            mode = self.read.mode if self.read is not None else "direct"
            if mode == "direct" and (self.replication or self.erasure):
                raise ValueError(
                    "direct reads hit one target; use "
                    "ReadPolicy('degraded-rs') / ('replica-failover') for "
                    "resilient read policies"
                )
            if mode == "degraded-rs" and self.erasure is None:
                raise ValueError("ReadPolicy('degraded-rs') needs an RS "
                                 "erasure stage (the object's geometry)")
            if mode == "replica-failover" and self.replication is None:
                raise ValueError("ReadPolicy('replica-failover') needs a "
                                 "replication stage (the replica set)")

    @property
    def storage_node_count(self) -> int:
        """Storage-side nodes this policy occupies (1..count on an Env)."""
        if self.erasure is not None:
            return self.erasure.k + self.erasure.m
        if self.replication is not None:
            return self.replication.k
        if self.consistency is not None:
            c = self.consistency
            return c.k if isinstance(c, Chain) else c.n
        return 1

    def with_geometry(self, k: int, m: int | None = None) -> "PolicySpec":
        """This policy with its fan-out resized: RS(k, m) for erasure
        specs, k replicas for replication specs — the second actuator of
        the control plane's autoscaler (``repro_torch.control``), which picks
        the cheapest fan-out meeting an SLO."""
        if self.erasure is not None:
            e = dataclasses.replace(
                self.erasure, k=k, m=self.erasure.m if m is None else m
            )
            return dataclasses.replace(self, erasure=e)
        if self.replication is not None:
            if m is not None:
                raise ValueError("replication fan-out has no parity count m")
            r = dataclasses.replace(self.replication, k=k)
            return dataclasses.replace(self, replication=r)
        if self.consistency is not None:
            if m is not None:
                raise ValueError("consistency fan-out has no parity count m")
            c = self.consistency
            c = (dataclasses.replace(c, k=k) if isinstance(c, Chain)
                 else dataclasses.replace(c, n=k))
            return dataclasses.replace(self, consistency=c)
        raise ValueError(
            "policy has no replication/erasure stage; nothing to resize"
        )

    def describe(self) -> str:
        stages = [self.op, self.transport, type(self.auth).__name__]
        if self.replication is not None:
            r = self.replication
            stages.append(
                f"Flat(k={r.k})" if isinstance(r, Flat)
                else f"Tree(k={r.k},{r.strategy.name.lower()},{r.engine})"
            )
        if self.erasure is not None:
            e = self.erasure
            stages.append(f"RS({e.k},{e.m},{e.engine})")
        if self.consistency is not None:
            c = self.consistency
            stages.append(
                f"Chain(k={c.k},{'craq' if c.dirty_read else 'tail'},"
                f"{c.engine})" if isinstance(c, Chain)
                else f"Quorum(n={c.n},{c.engine})"
            )
        if self.read is not None:
            stages.append(f"Read({self.read.mode},{self.read.engine})")
        return " | ".join(stages)


# ---------------------------------------------------------------------------
# Presets: the named policies of the paper's figures.
# ---------------------------------------------------------------------------


def preset_spec(
    name: str,
    k: int = 4,
    m: int = 2,
    strategy: ReplStrategy = ReplStrategy.RING,
) -> PolicySpec:
    """Build a named preset.  ``k``/``m``/``strategy`` parameterize the
    replication / erasure presets; write presets ignore them."""
    builders = {
        "raw-write": lambda: PolicySpec("rdma", NoAuth()),
        "spin-write": lambda: PolicySpec("spin", SpongeAuth()),
        "rpc-write": lambda: PolicySpec("rpc", HostAuth()),
        "rpc-rdma-write": lambda: PolicySpec("rpc", HostAuth(rdma_read=True)),
        "rdma-flat": lambda: PolicySpec("rdma", NoAuth(), Flat(k)),
        "cpu-ring": lambda: PolicySpec(
            "rdma", NoAuth(), Tree(k, ReplStrategy.RING, "host")),
        "cpu-pbt": lambda: PolicySpec(
            "rdma", NoAuth(), Tree(k, ReplStrategy.PBT, "host")),
        "hyperloop": lambda: PolicySpec(
            "rdma", NoAuth(), Tree(k, ReplStrategy.RING, "hyperloop")),
        "spin-ring": lambda: PolicySpec(
            "spin", SpongeAuth(), Tree(k, ReplStrategy.RING, "spin")),
        "spin-pbt": lambda: PolicySpec(
            "spin", SpongeAuth(), Tree(k, ReplStrategy.PBT, "spin")),
        "spin-repl": lambda: PolicySpec(
            "spin", SpongeAuth(), Tree(k, strategy, "spin")),
        "spin-triec": lambda: PolicySpec(
            "spin", SpongeAuth(), erasure=RS(k, m, "spin")),
        "inec-triec": lambda: PolicySpec(
            "rdma", NoAuth(), erasure=RS(k, m, "inec")),
        "spin-read": lambda: PolicySpec("spin", SpongeAuth(), op="read"),
        "spin-read-ec": lambda: PolicySpec(
            "spin", SpongeAuth(), erasure=RS(k, m, "spin"), op="read",
            read=ReadPolicy("degraded-rs", "spin")),
        "cpu-read-ec": lambda: PolicySpec(
            "rpc", HostAuth(), erasure=RS(k, m, "inec"), op="read",
            read=ReadPolicy("degraded-rs", "host")),
        "spin-read-repl": lambda: PolicySpec(
            "spin", SpongeAuth(), replication=Tree(k, strategy, "spin"),
            op="read", read=ReadPolicy("replica-failover")),
        "chain-spin-write": lambda: PolicySpec(
            "spin", SpongeAuth(), consistency=Chain(k)),
        "chain-host-write": lambda: PolicySpec(
            "rdma", NoAuth(), consistency=Chain(k, engine="host")),
        "chain-spin-read": lambda: PolicySpec(
            "spin", SpongeAuth(), consistency=Chain(k), op="read"),
        "abd-spin-write": lambda: PolicySpec(
            "spin", SpongeAuth(), consistency=Quorum(k)),
        "abd-spin-read": lambda: PolicySpec(
            "spin", SpongeAuth(), consistency=Quorum(k), op="read"),
        # metadata plane (PR 8): namespace RPCs on the NameNode's NIC
        # handlers vs the host-CPU RPC detour
        "ns-lookup-spin": lambda: PolicySpec(
            "spin", SpongeAuth(), op="lookup"),
        "ns-lookup-host": lambda: PolicySpec("rpc", HostAuth(), op="lookup"),
        "ns-open-spin": lambda: PolicySpec("spin", SpongeAuth(), op="open"),
        "ns-open-host": lambda: PolicySpec("rpc", HostAuth(), op="open"),
        "ns-commit-spin": lambda: PolicySpec(
            "spin", SpongeAuth(), op="commit"),
        "ns-commit-host": lambda: PolicySpec("rpc", HostAuth(), op="commit"),
    }
    if name not in builders:
        raise ValueError(
            f"unknown policy preset {name!r}; available: {sorted(builders)}"
        )
    return dataclasses.replace(builders[name](), name=name)


#: every named preset ("spin-repl" is the parameterized alias of
#: spin-ring/spin-pbt; "spin-read" is the direct read-path policy;
#: "spin-read-ec"/"cpu-read-ec" are the degraded-capable striped EC reads
#: with NIC- vs host-side reconstruction; "spin-read-repl" is the
#: replica-failover read).
PRESET_NAMES = (
    "raw-write", "spin-write", "rpc-write", "rpc-rdma-write", "rdma-flat",
    "cpu-ring", "cpu-pbt", "hyperloop", "spin-ring", "spin-pbt",
    "spin-triec", "inec-triec", "spin-read", "spin-read-ec", "cpu-read-ec",
    "spin-read-repl", "chain-spin-write", "chain-host-write",
    "chain-spin-read", "abd-spin-write", "abd-spin-read",
    "ns-lookup-spin", "ns-lookup-host", "ns-open-spin", "ns-open-host",
    "ns-commit-spin", "ns-commit-host",
)

#: presets parameterized by the EC geometry (their anchors and latency
#: runs take ``k`` from the RS stage, not the replication factor) — the
#: single source of truth for tests/test_policy.py and
#: tools/check_anchors.py
EC_GEOMETRY_PRESETS = (
    "spin-triec", "inec-triec", "spin-read-ec", "cpu-read-ec",
)
