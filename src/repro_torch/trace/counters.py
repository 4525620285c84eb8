"""One named, snapshot-diffable namespace over the sim's scattered counters.

Every layer of the timed plane keeps its own tallies — ``Network`` has
``packets_sent`` / ``ctrl_*`` / drop counters, each :class:`PsPINUnit`
tracks handler time and HPU-pool occupancy, every
:class:`SerialResource` knows its busy/wait time, ``Metrics`` and
``Telemetry`` keep workload-level gauges.  Debugging a regression in a
``BENCH_*.json`` today means re-deriving that union by hand.

:class:`CounterRegistry` flattens them behind dotted names
(``net.packets_sent``, ``pspin.handler_ns``, ``egress.busy_ns``, ...):

* ``register(name, fn)`` — one leaf counter (``fn`` reads the live value)
* ``register_group(name, fn)`` — ``fn`` returns a dict, flattened as
  ``name.key``; groups re-read lazily so resources created *after*
  registration (the sim builds them on demand) still show up
* ``snapshot()`` — ``{name: value}`` at this instant
* ``diff(a, b)`` — per-name deltas between two snapshots

``registry_for(env, ...)`` wires a registry over an
:class:`~repro_torch.sim.protocols.Env` (network + PsPIN + serial resources +
engine), aggregating per-node resources into per-class totals so the
namespace — which ``Workload.run`` reports under ``rep["counters"]`` and
bench artifacts can embed — stays small at fleet scale.
"""

from __future__ import annotations

from typing import Callable


class CounterRegistry:
    """Named counter sources, snapshot at will, diff snapshots."""

    def __init__(self):
        self._leaves: dict[str, Callable[[], float]] = {}
        self._groups: dict[str, Callable[[], dict]] = {}

    def register(self, name: str, fn: Callable[[], float]) -> None:
        self._leaves[name] = fn

    def register_group(self, name: str, fn: Callable[[], dict]) -> None:
        self._groups[name] = fn

    def names(self) -> list[str]:
        out = list(self._leaves)
        for gname, fn in self._groups.items():
            out.extend(f"{gname}.{k}" for k in fn())
        return sorted(out)

    def snapshot(self) -> dict:
        out = {name: fn() for name, fn in self._leaves.items()}
        for gname, fn in self._groups.items():
            for k, v in fn().items():
                out[f"{gname}.{k}"] = v
        return dict(sorted(out.items()))

    @staticmethod
    def diff(a: dict, b: dict) -> dict:
        """Per-name ``b - a`` for names present in both (numeric only)."""
        out = {}
        for k, vb in b.items():
            va = a.get(k)
            if isinstance(va, (int, float)) and isinstance(vb, (int, float)):
                out[k] = vb - va
        return out


def _serial_totals(resources) -> dict:
    """Aggregate a collection of SerialResources into class totals."""
    busy = wait = 0.0
    acquires = 0
    peak_q = 0
    for r in resources:
        busy += r.busy_ns
        wait += r.total_wait_ns
        acquires += r.acquires
        peak_q = max(peak_q, r.peak_queued)
    return {"busy_ns": busy, "wait_ns": wait, "acquires": acquires,
            "peak_queued": peak_q}


def registry_for(env, metrics=None, telemetry=None) -> CounterRegistry:
    """Build the standard registry over one :class:`Env` (plus optional
    workload-level sources).  Groups read lazily, so call order vs.
    resource creation does not matter."""
    reg = CounterRegistry()
    sim = env.sim
    net = env.net

    reg.register("sim.events", lambda: sim.events_processed)
    reg.register("sim.now_ns", lambda: sim.now)

    def net_group():
        return {
            "packets_sent": net.packets_sent,
            "packets_dropped": net.packets_dropped,
            "bytes_dropped": net.bytes_dropped,
            "ctrl_packets_sent": net.ctrl_packets_sent,
            "ctrl_bytes_sent": net.ctrl_bytes_sent,
            "ctrl_packets_dropped": net.ctrl_packets_dropped,
            "ctrl_bytes_dropped": net.ctrl_bytes_dropped,
            "bytes_out": sum(n.bytes_out for n in net.nodes.values()),
            "bytes_in": sum(n.bytes_in for n in net.nodes.values()),
        }

    def egress_group():
        return _serial_totals(n.egress for n in net.nodes.values())

    def ingress_group():
        return _serial_totals(n.ingress for n in net.nodes.values())

    def cpu_group():
        return _serial_totals(env._cpu.values())

    def pspin_group():
        handler_count = 0
        handler_ns = stall_ns = 0.0
        hpu_wait_ns = 0.0
        hpu_peak = hpu_queued_peak = 0
        for unit in env._pspin.values():
            handler_count += unit.handler_count
            handler_ns += unit.handler_time_ns
            stall_ns += unit.stall_time_ns
            hpu_wait_ns += unit.hpus.total_wait_ns
            hpu_peak = max(hpu_peak, unit.hpus.peak)
            hpu_queued_peak = max(hpu_queued_peak, unit.hpus.peak_queued)
        return {
            "handler_count": handler_count,
            "handler_ns": handler_ns,
            "stall_ns": stall_ns,
            "hpu_wait_ns": hpu_wait_ns,
            "hpu_peak": hpu_peak,
            "hpu_queued_peak": hpu_queued_peak,
        }

    reg.register_group("net", net_group)
    reg.register_group("egress", egress_group)
    reg.register_group("ingress", ingress_group)
    reg.register_group("cpu", cpu_group)
    reg.register_group("pspin", pspin_group)

    if metrics is not None:
        reg.register_group("metrics", lambda: {
            "issued": metrics.issued,
            "completed": metrics.completed,
            "dropped": metrics.dropped,
            "failed": metrics.failed,
            "bytes_completed": metrics.bytes_completed,
        })
    if telemetry is not None:
        reg.register_group("telemetry", lambda: {
            "windows": len(telemetry.windows),
            "evicted": telemetry.evicted,
            "lost_packets": sum(w.lost_packets for w in telemetry.windows),
        })
    return reg
