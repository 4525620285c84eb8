"""Multi-client workload engine over the protocol simulators.

The paper's headline numbers (Figs. 6/9/15) are single-request latencies
and streamed single-client goodput; the ROADMAP's north-star scenario is
*contention* — many clients with many outstanding requests fighting over
link ports, HPU pools, and host CPUs.  This module drives N concurrent
clients with configurable arrival processes against any protocol factory
from :mod:`repro_torch.sim.protocols` and collects per-request latency
percentiles, sustained goodput, and queue-depth statistics.

Arrival processes (per client):

  closed   closed-loop: next request issues when the previous completes
           (plus optional think time) — classic benchmark loop.
  poisson  open-loop: exponential inter-arrival times at a configured
           offered load, independent of completions (models millions of
           independent users behind a load balancer).
  bursty   open-loop: back-to-back bursts of ``burst_size`` requests every
           ``burst_gap_ns`` — models batched commits / checkpoint flushes.

Open-loop arrivals admit at most ``max_outstanding`` in-flight requests
per client (admission control); excess arrivals are *dropped* and counted,
so overload shows up as drops + queueing rather than an unbounded heap.

Mixed-policy scenarios: ``Scenario.policies`` takes a list of
:class:`PolicyLoad` — ``(PolicySpec | preset name, weight, size_dist)`` —
all compiled onto *one* shared :class:`Env` (policy-id packet demux lets
them share storage nodes), and every request picks its policy by weighted
draw and its payload from the load's :class:`SizeDist` (``fixed`` /
``lognormal`` / ``bimodal``).  That is the regime the paper's scaling
claims live in: writes and EC contending for the same links and HPUs.

Mixed *read/write* scenarios share extents: with
``Scenario.shared_extents`` writers populate an object space and read
policies consume it — every read draws its payload size from a
previously *completed* write (a read arriving before anything was
written is shed and counted as a drop), so ``bytes_read`` only ever
covers bytes that were actually written.  ``Scenario.failures`` attaches
a :class:`repro_torch.policy.FailureModel` (crashed / lossy / slow nodes) to
the shared Env: degraded-read policies compile their survivor fan-out
against it, lost packets are counted by the network (``lost_packets`` /
``lost_bytes`` in the report), and requests whose packets were lost
remain in flight — conservation (issued == completed + in_flight +
dropped) holds under every failure mix, so no byte goes silently
missing.

Control-plane hooks (PR 5, :mod:`repro_torch.control`): a
:class:`~repro_torch.control.Telemetry` passed to :class:`Workload` receives
every issue/drop/completion in event-time windows plus periodic queue
gauges (the ring the SLO autoscaler steers on);
``Scenario.admission_GBps`` sheds arrivals through a global token bucket
(counted as drops, conservation holds); ``PolicyLoad.pace_GBps`` shapes
one load's injection through a per-load bucket (repair/rebuild traffic
paced against the foreground — delayed, never lost), with
``PolicyLoad.background`` routing its bytes into the telemetry ring's
repair ledger.

Everything is deterministic: a seeded ``random.Random`` drives arrivals,
policy picks, and size draws, and the discrete-event core has no other
nondeterminism, so the same :class:`Scenario` always produces the
identical event trace and metrics.
"""

from __future__ import annotations

import dataclasses
import math
import random

from repro_torch.core.packets import ReplStrategy
from repro_torch.sim.network import NetConfig
from repro_torch.sim.protocols import (
    CLIENT,
    Env,
    Protocol,
    Result,
)
from repro_torch.sim.pspin import PsPINConfig

KiB = 1024


def client_node_ids(n: int) -> list[int]:
    """Client ids 0, -1, -2, ... (storage nodes are the positive ids)."""
    return [CLIENT - i for i in range(n)]


@dataclasses.dataclass(frozen=True)
class SizeDist:
    """Per-request payload size distribution.

    ``fixed``: always ``mean``.  ``lognormal``: mean ``mean`` with shape
    ``sigma`` (heavy right tail — many small requests, occasional large
    ones).  ``bimodal``: ``small`` with probability ``1 - p_large`` else
    ``large`` (metadata-ops vs bulk-data mix)."""

    kind: str = "fixed"          # fixed | lognormal | bimodal
    mean: int = 64 * KiB
    sigma: float = 0.6
    small: int = 4 * KiB
    large: int = 256 * KiB
    p_large: float = 0.125
    min_bytes: int = 64
    max_bytes: int = 4 << 20

    def sample(self, rnd: random.Random) -> int:
        if self.kind == "fixed":
            return self.mean
        if self.kind == "lognormal":
            mu = math.log(self.mean) - self.sigma ** 2 / 2.0
            v = int(rnd.lognormvariate(mu, self.sigma))
            return max(self.min_bytes, min(v, self.max_bytes))
        if self.kind == "bimodal":
            return self.large if rnd.random() < self.p_large else self.small
        raise ValueError(f"unknown size distribution {self.kind!r}")

    def upper_bound(self) -> int:
        """Largest payload this distribution can produce (admission
        buckets must be at least this deep or the request can never be
        admitted)."""
        if self.kind == "fixed":
            return self.mean
        if self.kind == "lognormal":
            return self.max_bytes
        if self.kind == "bimodal":
            return max(self.small, self.large)
        raise ValueError(f"unknown size distribution {self.kind!r}")


@dataclasses.dataclass
class PolicyLoad:
    """One component of a mixed scenario: a policy (a
    :class:`repro_torch.policy.PolicySpec` or preset name), its share of the
    request traffic, and its request-size distribution (None: the
    scenario's ``size_dist`` / fixed ``size``).

    ``pace_GBps`` shapes this load through a per-load token bucket
    (:class:`repro_torch.control.TokenBucket`): each request reserves its
    payload bytes and its injection is *delayed* until the bucket's debt
    is repaid — repair/rebuild traffic paced against the foreground.
    ``background=True`` marks the load as background work: its completed
    bytes land in the telemetry ring's ``repair_bytes`` (not foreground
    goodput)."""

    spec: object                      # PolicySpec | preset name
    weight: float = 1.0
    size_dist: SizeDist | None = None
    pace_GBps: float | None = None    # token-bucket injection shaping
    pace_burst_bytes: int = 1 << 20   # bucket depth for a paced load
    background: bool = False          # repair/rebuild traffic (telemetry)


@dataclasses.dataclass
class Scenario:
    """One contention experiment: who sends what, how fast, to which
    protocol."""

    protocol: str = "spin-write"
    size: int = 64 * KiB               # payload per request (EC: block)
    num_clients: int = 4
    arrival: str = "closed"            # closed | poisson | bursty
    requests_per_client: int = 8
    think_ns: float = 0.0              # closed-loop think time
    offered_load_GBps: float | None = None  # open-loop aggregate offered load
    burst_size: int = 4
    burst_gap_ns: float = 100_000.0
    max_outstanding: int = 64          # per-client admission cap (open loop)
    duration_ns: float | None = None   # optional horizon (leaves in-flight)
    seed: int = 0
    # protocol parameters:
    k: int = 4
    m: int = 2
    strategy: ReplStrategy = ReplStrategy.RING
    # per-request size distribution (None: fixed ``size``):
    size_dist: SizeDist | None = None
    # mixed-policy mode: compile every load onto ONE shared Env (weighted
    # per-request policy pick); ``protocol`` is ignored when set.
    policies: list[PolicyLoad] | None = None
    # injected failures (repro_torch.policy.FailureModel | None == healthy)
    failures: object | None = None
    # mixed read/write extent sharing: reads draw their size from
    # completed writes (and are shed while nothing has been written yet)
    shared_extents: bool = False
    # global token-bucket admission (bytes): requests arriving when the
    # bucket is empty are shed and counted as drops (None == unlimited)
    admission_GBps: float | None = None
    admission_burst_bytes: int = 1 << 20
    # failure detection (repro_torch.membership.MembershipConfig | None): attach
    # a heartbeat service over the storage nodes — heartbeats become timed
    # NIC traffic, booked in the ctrl_* counters, never in data goodput
    membership: object | None = None
    # simulator core: None (discrete default) | "discrete" | "batched" |
    # "hybrid" | an Engine subclass/instance (see repro_torch.sim.engine)
    engine: object | None = None

    def run(
        self,
        engine=None,
        cfg: NetConfig | None = None,
        pcfg: PsPINConfig | None = None,
        telemetry=None,
        tracer=None,
    ) -> dict:
        """Run this scenario to completion and return the report dict.

        The one public entry point for scenario execution — ``engine``
        selects the simulator core (falling back to ``self.engine``,
        then the discrete default) so callers never touch ``Simulator``
        internals.  ``tracer`` attaches a :class:`repro_torch.trace.Tracer`
        for sampled request tracing (None: tracing off, zero cost)."""
        return Workload(
            self, cfg, pcfg, telemetry=telemetry, tracer=tracer,
            engine=engine if engine is not None else self.engine,
        ).run()

    def per_client_gap_ns(self, cfg: NetConfig | None = None) -> float:
        """Mean open-loop inter-arrival gap per client (``cfg``: the
        workload's actual network config, for the default load)."""
        if self.offered_load_GBps is None:
            # default: a moderate load — each client offers a quarter of
            # the configured line rate's per-request service time
            return 4.0 * self.size / (cfg or NetConfig()).bytes_per_ns
        per_client = self.offered_load_GBps / self.num_clients  # bytes/ns
        return self.size / per_client


class Metrics:
    """Shared metrics sink: request ledger + queue-depth samples.

    With a :class:`repro_torch.control.Telemetry` attached (``telemetry``),
    every issue / drop / completion is also recorded into the windowed
    event-time ring the control plane steers on."""

    def __init__(self, telemetry=None) -> None:
        self.telemetry = telemetry
        self.latencies_ns: list[float] = []
        self.issued = 0
        self.completed = 0
        self.dropped = 0
        self.failed = 0          # requests abandoned after retry exhaustion
                                 # (a subset of ``dropped`` — conservation
                                 # still balances against ``issued``)
        self.bytes_completed = 0
        self.bytes_written = 0   # completed write-op request payloads
        self.bytes_read = 0      # completed read-op request payloads
        self.meta_ops = 0        # completed namespace RPCs (no data bytes)
        self.first_issue_ns: float | None = None
        self.last_done_ns = 0.0
        self.hpu_queue_peak = 0
        self.ingress_queue_peak = 0
        self.cpu_queue_peak = 0

    # -- ledger -------------------------------------------------------------

    def on_issue(self, now: float) -> None:
        self.issued += 1
        if self.first_issue_ns is None:
            self.first_issue_ns = now
        if self.telemetry is not None:
            self.telemetry.record_issue(now)

    def on_drop(self, now: float | None = None) -> None:
        self.dropped += 1
        if self.telemetry is not None and now is not None:
            self.telemetry.record_drop(now)

    def on_complete(self, now: float, latency_ns: float, nbytes: int,
                    op: str = "write", background: bool = False,
                    policy: str | None = None) -> None:
        self.completed += 1
        self.latencies_ns.append(latency_ns)
        self.bytes_completed += nbytes
        if op == "read":
            self.bytes_read += nbytes
        elif op == "write":
            self.bytes_written += nbytes
        else:
            # namespace RPC (lookup/open/commit): an operation, not
            # bytes — its wire traffic is already booked under ctrl_*
            self.meta_ops += 1
        self.last_done_ns = now
        if self.telemetry is not None:
            self.telemetry.record_complete(now, latency_ns, nbytes,
                                           background=background,
                                           policy=policy)

    @property
    def in_flight(self) -> int:
        return self.issued - self.completed - self.dropped

    # -- queue stats (exact peaks from the engine's resource counters) -------

    def finalize_queues(self, env: Env, storage_nodes) -> None:
        """Pull the exact peak queue depths tracked by the resources
        themselves (SerialResource/Pool.peak_queued) — event-time sampling
        would systematically under-report the maxima."""
        self.hpu_queue_peak = max(
            (u.hpus.peak_queued for u in env.pspin_units()), default=0
        )
        self.ingress_queue_peak = max(
            (env.net.node(s).ingress.peak_queued for s in storage_nodes),
            default=0,
        )
        self.cpu_queue_peak = max(
            (c.peak_queued for c in env.host_cpus()), default=0
        )

    # -- summary ------------------------------------------------------------

    def percentile_ns(self, p: float) -> float:
        """Nearest-rank percentile of completed-request latency."""
        if not self.latencies_ns:
            return math.nan
        s = sorted(self.latencies_ns)
        rank = max(1, math.ceil(p / 100.0 * len(s)))
        return s[rank - 1]

    def goodput_GBps(self) -> float:
        if self.first_issue_ns is None or not self.bytes_completed:
            return 0.0
        elapsed = self.last_done_ns - self.first_issue_ns
        return self.bytes_completed / elapsed if elapsed > 0 else 0.0

    def report(self) -> dict:
        lat = self.latencies_ns
        return {
            "issued": self.issued,
            "completed": self.completed,
            "dropped": self.dropped,
            "failed": self.failed,
            "in_flight": self.in_flight,
            "p50_us": self.percentile_ns(50) / 1e3,
            "p95_us": self.percentile_ns(95) / 1e3,
            "p99_us": self.percentile_ns(99) / 1e3,
            "mean_us": (sum(lat) / len(lat) / 1e3) if lat else math.nan,
            "max_us": (max(lat) / 1e3) if lat else math.nan,
            "goodput_GBps": self.goodput_GBps(),
            "hpu_queue_peak": self.hpu_queue_peak,
            "ingress_queue_peak": self.ingress_queue_peak,
            "cpu_queue_peak": self.cpu_queue_peak,
        }


def _unique_names(loads) -> list[str]:
    names = []
    for pl in loads:
        if isinstance(pl.spec, str):
            names.append(pl.spec)
        else:
            names.append(pl.spec.name or pl.spec.describe())
    seen: dict[str, int] = {}
    out = []
    for n in names:
        c = seen.get(n, 0)
        seen[n] = c + 1
        out.append(n if c == 0 else f"{n}@{c}")
    return out


class Workload:
    """Drive one :class:`Scenario` to completion on a fresh :class:`Env`.

    Single-policy scenarios compile ``scenario.protocol``; mixed scenarios
    compile every :class:`PolicyLoad` onto the same Env (shared storage
    nodes, pid-demultiplexed) and draw the policy per request."""

    def __init__(
        self,
        scenario: Scenario,
        cfg: NetConfig | None = None,
        pcfg: PsPINConfig | None = None,
        telemetry=None,
        engine=None,
        tracer=None,
    ):
        self.sc = scenario
        self.telemetry = telemetry
        self.tracer = tracer
        self.env = Env(cfg, pcfg, failures=scenario.failures,
                       engine=engine if engine is not None else scenario.engine)
        # installed before compilation so policy-name registration and
        # every stage's sampling guard see the tracer from request 0
        self.env.sim.tracer = tracer
        sc = scenario
        # The flight lane books whole-request schedules at inject time;
        # anything that needs event-exact interleaving mid-request —
        # telemetry gauge sampling, a duration cap that truncates
        # in-flight work, or a second policy contending packet-by-packet
        # — forces the event-exact batched lane instead.
        if (telemetry is not None or sc.duration_ns is not None
                or (sc.policies and len(sc.policies) > 1)):
            self.env.allow_flight = False
        import repro_torch.policy as policy

        if sc.policies:
            self.loads: list[PolicyLoad] = list(sc.policies)
        else:
            self.loads = [PolicyLoad(sc.protocol, 1.0, sc.size_dist)]
        self.protos: list[Protocol] = [
            policy.compile(pl.spec, self.env, sc.size,
                           k=sc.k, m=sc.m, strategy=sc.strategy)
            for pl in self.loads
        ]
        self.proto = self.protos[0]
        self.policy_names = _unique_names(self.loads)
        total_w = sum(pl.weight for pl in self.loads)
        acc = 0.0
        self._cum_weights = []
        for pl in self.loads:
            acc += pl.weight / total_w
            self._cum_weights.append(acc)
        self.metrics = Metrics(telemetry=telemetry)
        # the unified counter namespace (repro_torch.trace.counters): one
        # live registry over every layer's tallies; the engine snapshots
        # it into EventBudgetExceeded and the report embeds a snapshot
        from repro_torch.trace import registry_for

        self.registry = registry_for(self.env, metrics=self.metrics,
                                     telemetry=telemetry)
        self.env.sim.counters = self.registry
        self.per_policy = [
            {"issued": 0, "completed": 0, "dropped": 0, "bytes": 0,
             "latencies_ns": []}
            for _ in self.loads
        ]
        # control plane: global admission bucket + per-load pacing buckets
        # (rate in bytes/ns == GB/s; the sim clock is nanoseconds)
        self._admission = None
        if sc.admission_GBps is not None:
            from repro_torch.control.governor import TokenBucket

            # a request larger than the bucket depth could *never* be
            # admitted (the level caps at the burst): reject the
            # misconfiguration instead of silently shedding 100%
            need = 0
            for pl, proto in zip(self.loads, self.protos):
                dist = pl.size_dist or sc.size_dist
                bound = (dist.upper_bound() if dist is not None
                         else proto.request_bytes)
                need = max(need, bound)
            if need > sc.admission_burst_bytes:
                raise ValueError(
                    f"admission_burst_bytes={sc.admission_burst_bytes} is "
                    f"smaller than the largest possible request "
                    f"({need} B); such requests would always be shed"
                )
            self._admission = TokenBucket(sc.admission_GBps,
                                          sc.admission_burst_bytes)
        self._pacers: list[object | None] = []
        for pl in self.loads:
            if pl.pace_GBps is not None:
                from repro_torch.control.governor import TokenBucket

                self._pacers.append(TokenBucket(pl.pace_GBps,
                                                pl.pace_burst_bytes))
            else:
                self._pacers.append(None)
        self._outstanding: dict[int, int] = {}
        self._fluid_plans: list[dict] = []
        # failure detection: heartbeats over the compiled storage nodes.
        # Attached AFTER compilation on purpose — the policies here keep
        # their static (healthy-view) pipelines and the heartbeat plane
        # rides alongside as pure control traffic, so its cost shows up
        # in the ctrl_* counters without perturbing the data-path
        # anchors.  Detection-driven reconfiguration is exercised by
        # benchmarks/membership.py, which attaches before compiling.
        if sc.membership is not None:
            from repro_torch.membership import attach_membership

            attach_membership(self.env, self.storage_nodes(), sc.membership)
        # cumulative network loss counters at the last telemetry sample
        self._loss_seen = (0, 0)
        #: shared object space: payload sizes of completed writes, drawn
        #: from by read policies when ``scenario.shared_extents`` is set
        self.extents: list[int] = []

    @staticmethod
    def _op_of(proto: Protocol) -> str:
        spec = getattr(proto, "spec", None)
        return spec.op if spec is not None else "write"

    def storage_nodes(self) -> tuple[int, ...]:
        nodes: set[int] = set()
        for proto in self.protos:
            nodes.update(proto.storage_nodes)
        return tuple(sorted(nodes))

    # -- request plumbing ----------------------------------------------------

    def _pick(self, rnd: random.Random) -> int:
        if len(self.loads) == 1:
            return 0
        x = rnd.random()
        for i, c in enumerate(self._cum_weights):
            if x <= c:
                return i
        return len(self.loads) - 1

    def _shed(self, i: int, after_done=None) -> None:
        """Count one shed request (counted — no silent loss).  The
        closed-loop continuation goes through the event queue so a long
        run of sheds iterates instead of recursing."""
        sim = self.env.sim
        self.metrics.on_issue(sim.now)
        self.per_policy[i]["issued"] += 1
        self.per_policy[i]["dropped"] += 1
        self.metrics.on_drop(sim.now)
        if after_done is not None:
            sim.after(0.0, after_done)

    def _issue(self, client: int, rnd: random.Random, after_done=None) -> None:
        sim = self.env.sim
        i = self._pick(rnd)
        proto = self.protos[i]
        pl = self.loads[i]
        op = self._op_of(proto)
        dist = pl.size_dist or self.sc.size_dist
        size = dist.sample(rnd) if dist is not None else None
        if op not in ("read", "write"):
            # namespace RPC: fixed small wire, no data payload — a size
            # distribution on the scenario must not leak into goodput
            size = None
        if self.sc.shared_extents and op == "read":
            if not self.extents:
                # nothing written yet: the read targets unpopulated space
                self._shed(i, after_done)
                return
            size = self.extents[rnd.randrange(len(self.extents))]
        nbytes = proto.request_bytes if size is None else size
        if self._admission is not None and not self._admission.try_take(
                nbytes, sim.now):
            if after_done is not None:
                # closed loop: the client can be backpressured — hold the
                # request until the bucket has refilled enough, then try
                # again (tokens may have been taken by other clients in
                # the meantime, so this re-checks rather than consumes).
                # Shedding here would drain the whole remaining budget at
                # one instant: the delay-0 continuation re-issues at the
                # same sim time, where the bucket is still empty.
                wait = self._admission.delay_until(nbytes, sim.now)
                sim.after(
                    max(wait, 1.0),
                    lambda: self._issue_admitted(
                        client, i, size, nbytes, after_done),
                )
                return
            # open loop: arrivals cannot be pushed back — the request is
            # shed before reaching the network (counted, no silent loss)
            self._shed(i, after_done)
            return
        self._start_request(client, i, size, nbytes, after_done)

    def _issue_admitted(self, client: int, i: int, size, nbytes: int,
                        after_done) -> None:
        """Closed-loop admission retry: take the tokens or wait again."""
        sim = self.env.sim
        if not self._admission.try_take(nbytes, sim.now):
            wait = self._admission.delay_until(nbytes, sim.now)
            sim.after(
                max(wait, 1.0),
                lambda: self._issue_admitted(
                    client, i, size, nbytes, after_done),
            )
            return
        self._start_request(client, i, size, nbytes, after_done)

    def _start_request(self, client: int, i: int, size, nbytes: int,
                       after_done) -> None:
        sim = self.env.sim
        proto = self.protos[i]
        pl = self.loads[i]
        op = self._op_of(proto)
        policy_name = self.policy_names[i]
        self.metrics.on_issue(sim.now)
        pp = self.per_policy[i]
        pp["issued"] += 1
        self._outstanding[client] = self._outstanding.get(client, 0) + 1

        def done(res: Result) -> None:
            self._outstanding[client] -= 1
            if res.extra.get("failed"):
                # the protocol gave up (retry budget exhausted / no live
                # replicas): counted as a drop so conservation holds —
                # issued == completed + in_flight + dropped
                self.metrics.failed += 1
                self.metrics.on_drop(sim.now)
                pp["dropped"] += 1
                if after_done is not None:
                    after_done()
                return
            self.metrics.on_complete(sim.now, res.latency_ns, nbytes, op,
                                     background=pl.background,
                                     policy=policy_name)
            if self.sc.shared_extents and op == "write":
                self.extents.append(nbytes)
            pp["completed"] += 1
            pp["bytes"] += nbytes
            pp["latencies_ns"].append(res.latency_ns)
            if after_done is not None:
                after_done()

        pacer = self._pacers[i]
        if pacer is not None:
            # injection shaping: reserve the bytes now, inject once the
            # bucket's debt is repaid (FIFO — later requests queue behind)
            wait = pacer.reserve(nbytes, sim.now)
            if wait > 0:
                sim.after(wait,
                          lambda: proto.issue(client, on_done=done, size=size))
                return
        proto.issue(client, on_done=done, size=size)

    # -- arrival processes ---------------------------------------------------

    def _fluid_ok(self) -> bool:
        """May this run use the hybrid engine's calibrated fast-forward?

        Only steady closed loops qualify: one policy, constant request
        size, no think time, no admission/pacing control, no telemetry,
        no duration cap, no failures — anything else perturbs the
        steady-state gap the extrapolation relies on, so the run falls
        back to full event simulation."""
        sc = self.sc
        return (
            getattr(self.env.sim, "fluid", False)
            and sc.arrival == "closed"
            and sc.think_ns == 0
            and len(self.loads) == 1
            and self.telemetry is None
            and sc.duration_ns is None
            and self._admission is None
            and self._pacers[0] is None
            and not sc.shared_extents
            and (self.loads[0].size_dist or sc.size_dist) is None
            and sc.failures is None
            and sc.requests_per_client
            > max(2, getattr(self.env.sim, "calibration_requests", 3))
        )

    def _schedule_closed_fluid(self, client: int, rnd: random.Random) -> None:
        """Hybrid-engine closed loop: simulate a calibration prefix per
        client (all clients calibrate concurrently, so the measured
        steady-state inter-completion gap includes full contention),
        then record an extrapolation plan for the remaining requests.
        The plans are applied after the event heap drains (``run``), so
        no event ever observes a fast-forwarded clock."""
        sc, sim = self.sc, self.env.sim
        total = sc.requests_per_client
        ncal = min(total, max(2, sim.calibration_requests))
        state = {"done": 0, "prev": 0.0}

        def next_request() -> None:
            self._issue(client, rnd, after_done=after)

        def after() -> None:
            state["done"] += 1
            if state["done"] < ncal:
                state["prev"] = sim.now
                next_request()
            elif total > ncal:
                lats = self.per_policy[0]["latencies_ns"]
                self._fluid_plans.append({
                    "t_base": sim.now,
                    "gap": sim.now - state["prev"],
                    "lat": lats[-1] if lats else 0.0,
                    "n": total - ncal,
                    "nbytes": self.protos[0].request_bytes,
                })

        sim.at(0.0, next_request)

    def _apply_fluid_plans(self) -> None:
        """Synthesize the extrapolated completions (exact bookkeeping,
        approximate times) and advance the clock past them."""
        if not self._fluid_plans:
            return
        pp = self.per_policy[0]
        op = self._op_of(self.protos[0])
        sim = self.env.sim
        # extrapolated requests never touch the wire, but they DID
        # happen as far as the model is concerned — scale the packet
        # ledger so conservation (packets, data bytes) matches the
        # discrete engine exactly.  The workload is uniform (the
        # _fluid_ok guard: one load, fixed size), so packets-per-request
        # is the measured prefix's exact ratio.
        extra = sum(p["n"] for p in self._fluid_plans)
        if self.metrics.completed:
            per_req = self.env.net.packets_sent / self.metrics.completed
            self.env.net.packets_sent += round(per_req * extra)
        for plan in self._fluid_plans:
            t, gap, lat, nbytes = (plan["t_base"], plan["gap"],
                                   plan["lat"], plan["nbytes"])
            for r in range(1, plan["n"] + 1):
                self.metrics.on_issue(t + (r - 1) * gap)
                pp["issued"] += 1
                self.metrics.on_complete(t + r * gap, lat, nbytes, op)
                pp["completed"] += 1
                pp["bytes"] += nbytes
                pp["latencies_ns"].append(lat)
            sim.advance_to(t + plan["n"] * gap)

    def _schedule_closed(self, client: int, rnd: random.Random) -> None:
        sc, sim = self.sc, self.env.sim
        if self._fluid_ok():
            self._schedule_closed_fluid(client, rnd)
            return
        remaining = {"n": sc.requests_per_client}

        def next_request() -> None:
            if remaining["n"] == 0:
                return
            remaining["n"] -= 1
            self._issue(client, rnd, after_done=maybe_next)

        def maybe_next() -> None:
            if remaining["n"] > 0:
                if sc.think_ns > 0:
                    sim.after(sc.think_ns, next_request)
                else:
                    next_request()

        sim.at(0.0, next_request)

    def _open_loop_arrivals(self, client: int, rnd: random.Random) -> list[float]:
        sc = self.sc
        times: list[float] = []
        if sc.arrival == "poisson":
            gap = sc.per_client_gap_ns(self.env.cfg)
            t = 0.0
            for _ in range(sc.requests_per_client):
                t += rnd.expovariate(1.0 / gap)
                times.append(t)
        elif sc.arrival == "bursty":
            issued = 0
            burst = 0
            while issued < sc.requests_per_client:
                t = burst * sc.burst_gap_ns
                for _ in range(min(sc.burst_size,
                                   sc.requests_per_client - issued)):
                    times.append(t)
                    issued += 1
                burst += 1
        else:
            raise ValueError(f"unknown arrival process {sc.arrival!r}")
        return times

    def _schedule_open(self, client: int, rnd: random.Random) -> None:
        sc, sim = self.sc, self.env.sim
        for t in self._open_loop_arrivals(client, rnd):
            def arrive(client=client) -> None:
                if self._outstanding.get(client, 0) >= sc.max_outstanding:
                    # admission control: the arrival happened (issued) but
                    # is shed before reaching the network
                    self.metrics.on_issue(self.env.sim.now)
                    self.metrics.on_drop(self.env.sim.now)
                    return
                self._issue(client, rnd)

            sim.at(t, arrive)

    # -- run -----------------------------------------------------------------

    def _policy_report(self) -> dict:
        elapsed = self.metrics.last_done_ns - (self.metrics.first_issue_ns
                                               or 0.0)
        out = {}
        for name, pp in zip(self.policy_names, self.per_policy):
            lat = sorted(pp["latencies_ns"])

            def pct(p):
                if not lat:
                    return math.nan
                return lat[max(1, math.ceil(p / 100.0 * len(lat))) - 1] / 1e3

            out[name] = {
                "issued": pp["issued"],
                "completed": pp["completed"],
                "dropped": pp["dropped"],
                "bytes": pp["bytes"],
                "p50_us": pct(50),
                "p99_us": pct(99),
                "goodput_GBps": (pp["bytes"] / elapsed) if elapsed > 0 else 0.0,
            }
        return out

    def _sample_telemetry(self) -> None:
        """Record one gauge/loss sample at the current event time (the
        loss counters are cumulative at the network, so deltas since the
        previous sample are attributed to the current window)."""
        tel, env = self.telemetry, self.env
        units = env.pspin_units()
        nodes = self.storage_nodes()
        pkts, nbytes = env.net.packets_dropped, env.net.bytes_dropped
        tel.sample(
            env.sim.now,
            hpu_queued=max((u.hpus.queued() for u in units), default=0),
            hpu_in_use=max((u.hpus.in_use for u in units), default=0),
            ingress_queued=max(
                (env.net.node(s).ingress.queued() for s in nodes),
                default=0,
            ),
            cpu_queued=max(
                (c.queued() for c in env.host_cpus()), default=0
            ),
            lost_packets=pkts - self._loss_seen[0],
            lost_bytes=nbytes - self._loss_seen[1],
        )
        self._loss_seen = (pkts, nbytes)

    def _schedule_sampler(self) -> None:
        """Periodic event-time gauge sampling into the telemetry ring.

        Ticks are pinned to *absolute* window boundaries
        (``epoch + i * window_ns``) rather than rescheduled relative to
        the previous tick (``now + window_ns``): relative rescheduling
        accumulates floating-point error, so sample timestamps slowly
        drift off the boundary grid and gauges are no longer emitted at
        identical simulated times on every engine.  The tick reschedules
        itself only while other events are pending, so it never keeps
        the simulation alive on its own; ``run`` flushes one final
        sample so the trailing partial window (and sub-window runs,
        where no tick ever fires) still reach the ring."""
        tel, env = self.telemetry, self.env
        epoch = env.sim.now
        boundary = [1]

        def tick() -> None:
            self._sample_telemetry()
            if env.sim.pending() > 0:
                boundary[0] += 1
                env.sim.at(epoch + boundary[0] * tel.window_ns, tick)

        env.sim.at(epoch + tel.window_ns, tick)

    def run(self) -> dict:
        sc = self.sc
        for idx, client in enumerate(client_node_ids(sc.num_clients)):
            rnd = random.Random((sc.seed * 1_000_003) ^ (idx * 7919))
            if sc.arrival == "closed":
                self._schedule_closed(client, rnd)
            else:
                self._schedule_open(client, rnd)
        if self.telemetry is not None:
            self._schedule_sampler()
        self.env.sim.run(until=sc.duration_ns)
        self._apply_fluid_plans()
        if self.telemetry is not None:
            # flush the trailing partial window (loss deltas + gauges
            # since the last periodic tick)
            self._sample_telemetry()
        storage_nodes = self.storage_nodes()
        self.metrics.finalize_queues(self.env, storage_nodes)
        rep = self.metrics.report()
        ingress = [self.env.net.node(s).ingress for s in storage_nodes]
        rep.update(
            {
                "protocol": "+".join(self.policy_names),
                "per_policy": self._policy_report(),
                "clients": sc.num_clients,
                "arrival": sc.arrival,
                "size": sc.size,
                "bytes_written": self.metrics.bytes_written,
                "bytes_read": self.metrics.bytes_read,
                # namespace RPCs completed + their rate (ops, not bytes;
                # their wire traffic is under ctrl_bytes)
                "meta_ops": self.metrics.meta_ops,
                "meta_qps": (
                    self.metrics.meta_ops
                    / ((self.metrics.last_done_ns
                        - (self.metrics.first_issue_ns or 0.0)) / 1e9)
                    if self.metrics.meta_ops
                    and self.metrics.last_done_ns
                    > (self.metrics.first_issue_ns or 0.0) else 0.0
                ),
                "lost_packets": self.env.net.packets_dropped,
                "lost_bytes": self.env.net.bytes_dropped,
                # control traffic (heartbeats, view management) is booked
                # apart from data: goodput and loss stay pure data-plane
                "ctrl_packets": self.env.net.ctrl_packets_sent,
                "ctrl_bytes": self.env.net.ctrl_bytes_sent,
                "ctrl_lost_packets": self.env.net.ctrl_packets_dropped,
                "ctrl_lost_bytes": self.env.net.ctrl_bytes_dropped,
                "events": self.env.sim.events_processed,
                "sim_ns": self.env.sim.now,
                "packets": self.env.net.packets_sent,
                "hpu_peak": max(
                    (u.hpus.peak for u in self.env.pspin_units()), default=0
                ),
                "hpu_wait_us": sum(
                    u.hpu_wait_ns() for u in self.env.pspin_units()
                ) / 1e3,
                "ingress_util": max(
                    (r.utilization() for r in ingress), default=0.0
                ),
                "ingress_mean_wait_ns": (
                    sum(r.total_wait_ns for r in ingress)
                    / max(1, sum(r.acquires for r in ingress))
                ),
                # control plane: injection-shaping debt served and
                # admission sheds (0 when no governor is configured)
                "paced_wait_us": sum(
                    b.total_wait for b in self._pacers if b is not None
                ) / 1e3,
                "admission_shed": (
                    self._admission.shed if self._admission is not None else 0
                ),
            }
        )
        # one snapshot of the unified counter namespace, embedded so
        # bench artifacts can diff runs without re-deriving the union
        rep["counters"] = self.registry.snapshot()
        if self.tracer is not None:
            rep["trace_spans"] = len(self.tracer)
            rep["trace_dropped"] = self.tracer.dropped
        return rep


def run_scenario(
    scenario: Scenario,
    cfg: NetConfig | None = None,
    pcfg: PsPINConfig | None = None,
    engine=None,
) -> dict:
    """Convenience one-shot: build the workload, run it, return the report."""
    return Workload(scenario, cfg, pcfg, engine=engine).run()
