"""Critical-path / latency-attribution summaries over a trace buffer.

This is the layer that turns spans into the paper's *attribution*
story: the headline wins (2x writes / replication / EC) come from
removing PCIe and host-CPU hops from the data path, so every request's
latency is decomposed into six buckets —

  ``wire``       egress/link/ingress serialization (incl. port queues)
  ``hpu_queue``  waiting for a free HPU in the PsPIN pool
  ``hpu_exec``   handler execution on the HPUs (incl. INEC engine time)
  ``pcie``       NIC<->host PCIe crossings (incl. INEC staging DMA)
  ``host_cpu``   host software: notify/validate/memcpy/decode
  ``client``     client post + completion overheads

Bucket sums are *resource-time* totals: parallel spans (k+m fan-out
legs) add up, so a bucket can exceed the request's wall latency — the
point is comparing the same bucket across policies (e.g. spin-write's
``pcie + host_cpu`` vs host rpc-write's), which is exactly what
``benchmarks/trace.py`` gates.
"""

from __future__ import annotations

from .tracer import BUCKETS


def per_request(tracer) -> dict:
    """``{rid: {bucket: ns, ..., "wall_ns": span-of-request}}`` — bucket
    sums plus the wall interval covered by the request's spans."""
    out: dict = {}
    for s in tracer.spans:
        if s.rid is None:
            continue
        row = out.get(s.rid)
        if row is None:
            row = dict.fromkeys(BUCKETS, 0.0)
            row["t0"] = s.t0
            row["t1"] = s.t1
            row["pid"] = s.pid
            out[s.rid] = row
        if s.cat in row:
            row[s.cat] += s.t1 - s.t0
        row["t0"] = min(row["t0"], s.t0)
        row["t1"] = max(row["t1"], s.t1)
        if s.pid is None:
            row["pid"] = row["pid"]
        elif row["pid"] is None:
            row["pid"] = s.pid
    for row in out.values():
        row["wall_ns"] = row.pop("t1") - row.pop("t0")
    return out


def per_policy(tracer) -> dict:
    """Aggregate :func:`per_request` by policy name:
    ``{policy: {bucket: mean ns, "wall_ns": mean, "requests": n}}``."""
    reqs = per_request(tracer)
    agg: dict = {}
    for row in reqs.values():
        name = tracer.policy_name(row["pid"])
        acc = agg.setdefault(name, dict.fromkeys((*BUCKETS, "wall_ns"), 0.0))
        acc["requests"] = acc.get("requests", 0) + 1
        for b in (*BUCKETS, "wall_ns"):
            acc[b] += row[b]
    for acc in agg.values():
        n = acc["requests"]
        for b in (*BUCKETS, "wall_ns"):
            acc[b] /= n
    return dict(sorted(agg.items()))


def explained_fraction(host: dict, nic: dict) -> float:
    """How much of the NIC policy's latency edge over the host policy is
    explained by the PCIe + host-CPU spans the NIC path removed.

    ``host`` / ``nic`` are :func:`per_policy` rows.  Returns
    ``(removed pcie+host_cpu time) / (wall-latency edge)``, clamped to
    [0, inf); 1.0 means the entire edge is those removed hops."""
    edge = host["wall_ns"] - nic["wall_ns"]
    if edge <= 0:
        return 0.0
    removed = (host["pcie"] + host["host_cpu"]) - (nic["pcie"] + nic["host_cpu"])
    return max(0.0, removed / edge)


def render(policies: dict) -> str:
    """Text attribution table (one row per policy) for run logs."""
    cols = (*BUCKETS, "wall_ns")
    width = max((len(p) for p in policies), default=6)
    head = "policy".ljust(width) + "  req " + "".join(f"{c:>11}" for c in cols)
    lines = [head, "-" * len(head)]
    for name, acc in policies.items():
        cells = "".join(f"{acc[c] / 1e3:>10.1f}u" for c in cols)
        lines.append(f"{name.ljust(width)}  {acc['requests']:>3} {cells}")
    return "\n".join(lines)


def summarize(tracer) -> str:
    """One-call text summary (per-policy attribution table)."""
    return render(per_policy(tracer))
