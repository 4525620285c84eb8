"""Chrome/Perfetto ``trace.json`` export.

Emits the Chrome Trace Event JSON format (the ``traceEvents`` array of
``"ph": "X"`` complete events) that both ``chrome://tracing`` and
https://ui.perfetto.dev open directly.  Mapping:

* **process** (pid): the node-ish prefix of the resource track
  (``n3`` for ``n3.egress``, ``cl1`` for client tracks, the policy name
  for request root spans) — Perfetto groups tracks under it.
* **thread** (tid): the full resource name; queue-wait spans live on
  their own ``... (queue)`` track so service tracks stay non-overlapping.
* ``ts`` / ``dur`` are microseconds (the format's unit); sim times are
  nanoseconds, so everything is divided by 1e3.

The output is deterministic — spans sorted by ``(ts, tid, name)``,
track ids assigned in sorted-name order — so golden-file tests can
compare it byte-for-byte.
"""

from __future__ import annotations

import json


def _proc(span, policy_name) -> str:
    if span.cat == "request":
        return policy_name(span.pid)
    res = span.resource or "sim"
    return res.split(".", 1)[0]


def to_chrome_trace(tracer) -> dict:
    """Render a :class:`~repro_torch.trace.tracer.Tracer` buffer as a Chrome
    Trace Event document (pure data; callers json.dump it)."""
    spans = sorted(
        tracer.spans,
        key=lambda s: (s.t0, s.resource or "", s.name),
    )
    procs: dict[str, int] = {}
    tracks: dict[tuple[str, str], int] = {}
    for s in spans:
        p = _proc(s, tracer.policy_name)
        procs.setdefault(p, 0)
        tracks.setdefault((p, s.resource or s.name), 0)
    for i, p in enumerate(sorted(procs)):
        procs[p] = i + 1
    for i, key in enumerate(sorted(tracks)):
        tracks[key] = i + 1

    events: list[dict] = []
    for p, pid in sorted(procs.items()):
        events.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                       "args": {"name": p}})
    for (p, track), tid in sorted(tracks.items()):
        events.append({"ph": "M", "name": "thread_name", "pid": procs[p],
                       "tid": tid, "args": {"name": track}})
    for s in spans:
        p = _proc(s, tracer.policy_name)
        args = {"rid": s.rid, "policy": tracer.policy_name(s.pid)}
        if s.args:
            args.update(s.args)
        events.append({
            "ph": "X",
            "name": s.name,
            "cat": s.cat,
            "ts": round(s.t0 / 1e3, 6),
            "dur": round((s.t1 - s.t0) / 1e3, 6),
            "pid": procs[p],
            "tid": tracks[(p, s.resource or s.name)],
            "args": args,
        })
    doc = {"traceEvents": events, "displayTimeUnit": "ms"}
    if tracer.dropped:
        doc["otherData"] = {"dropped_spans": tracer.dropped}
    return doc


def write_chrome_trace(tracer, path: str) -> dict:
    """Export the tracer buffer to ``path`` (returns the document)."""
    doc = to_chrome_trace(tracer)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    return doc
