"""Timed-plane heartbeat service: liveness as first-class NIC traffic.

Every monitored node's PsPIN unit runs a cheap ``HANDLER_NS["heartbeat"]``
handler each interval that emits one 44 B heartbeat packet to a monitor
node through the shared :class:`~repro_torch.sim.network.Network` — so
heartbeats pay the same pipeline, HPU-pool, egress-serialization, and
link costs as data traffic, straggler ``compute_scale`` stretches their
emission, and loss/partition/flap injectors drop them like anything
else.  Heartbeat packets carry ``meta["ctrl"] = 1`` so the network books
them in the control-byte counters, keeping data-goodput claims clean.

The monitor feeds a :class:`~repro_torch.membership.view.ViewManager`; sinks
and injectors consult ``service.views.view`` at packet time, which is
the *detected* view — failover happens only after real heartbeats went
missing for the configured timeouts, never by reading the fault
schedule.  View dissemination back to the replicas is modeled as
instantaneous once detected (the functional plane models the full
hba/vi install path with leases); the monitor itself is assumed
replicated/out-of-band and does not crash.

A single periodic tick drives all emissions.  It reschedules only while
the simulation still has other pending events (or a view change is
waiting out a lease), the same self-termination idiom as the workload
telemetry sampler — so a drained run ends instead of heartbeating
forever.
"""

from __future__ import annotations

from repro_torch.membership.detector import MembershipConfig
from repro_torch.membership.view import ViewManager
from repro_torch.sim.pspin import HANDLER_NS, Emit, HandlerSpec

#: monitor node id — far below the negative ids extra clients use
MONITOR = -(1 << 16)
#: heartbeat wire size: rdma header + 16 B node/seq/epoch payload
HB_WIRE = 44


class HeartbeatService:
    def __init__(self, env, nodes, cfg: MembershipConfig | None = None):
        self.env = env
        self.nodes = tuple(nodes)
        self.cfg = cfg or MembershipConfig()
        self.views = ViewManager(self.nodes, self.cfg, now=env.sim.now)
        self.pid = env.new_pid()
        self.hb_emitted = 0
        self.hb_received = 0
        hh, ph, _ = HANDLER_NS["heartbeat"]
        self._emit_ns = hh + ph
        env.bind(MONITOR, self.pid, self._on_heartbeat)
        self._stopped = False
        env.sim.after(self.cfg.interval, self._tick)

    # -- monitor side --------------------------------------------------------

    def _on_heartbeat(self, pkt) -> None:
        self.hb_received += 1
        now = self.env.sim.now
        self.views.record_heartbeat(pkt.meta["hb"], now)
        self.views.poll(now)

    # -- emission tick -------------------------------------------------------

    def _tick(self) -> None:
        if self._stopped:
            return
        sim = self.env.sim
        self.views.poll(sim.now)
        # decide *before* emitting: our own emissions must not count as
        # the pending work that keeps the service alive
        keep = sim.pending() > 0 or self.views.pending_change()
        for n in self.nodes:
            if n in self.env.net.crashed:
                continue   # a crashed node's NIC runs no handlers
            meta = {"pid": self.pid, "hb": n, "ctrl": 1}
            self.env.pspin(n).process(
                HB_WIRE,
                HandlerSpec(self._emit_ns, [Emit(MONITOR, HB_WIRE, meta)]),
            )
            self.hb_emitted += 1
        if keep:
            sim.after(self.cfg.interval, self._tick)
        else:
            self._stopped = True

    def stop(self) -> None:
        self._stopped = True


def attach_membership(env, nodes, cfg: MembershipConfig | None = None
                      ) -> HeartbeatService:
    """Create a heartbeat service over ``nodes`` and register it as
    ``env.membership`` so membership-aware pipelines compile against it."""
    if getattr(env, "membership", None) is not None:
        raise ValueError("Env already has a membership service attached")
    svc = HeartbeatService(env, nodes, cfg)
    env.membership = svc
    return svc
