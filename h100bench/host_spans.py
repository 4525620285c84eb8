"""The program's own host spans over a traced run's window, for the readers
of the checkpoint plane's per-layer metrics.

The port records its spans (``repro_torch.trace.host``) while a profiler
runs, on ``time.time_ns()``: the Chrome trace's clock once its
``baseTimeNanoseconds`` is added to an event's ``ts``.  This reads the span
buffer in this process, and from the traced run's Chrome trace (where
``run.py`` writes it) the ``WINDOW`` range, the base and the device's busy
intervals.  Each span counts for its part inside the window.

Attribution of the card's idle time is a sweep over every thread's spans:
at each idle instant each thread offers its innermost open span, a thread
whose innermost span is a wait (``cat`` "wait") offers none, and the span
that started latest owns the instant.  An idle instant that no thread
claims is unnamed.  Spans are never looked up a bounded depth back.

Where the program has no span buffer, recorded nothing in the window, or
dropped spans past its bound, :func:`window_split` returns None and every
reader with it.
"""

from __future__ import annotations

import bisect
import gzip
import json
from pathlib import Path

import harness
import tracing

#: the spans of the host copies between the card and the host
HOST_COPIES = ("ckpt.snapshot", "copy.h2d", "copy.d2h")
#: the packet plane's request spans, which carry a ``packets`` count
PACKET_SPANS = ("pp.write", "pp.read")

_cache: dict = {}


def program_spans():
    """(spans, dropped) of the program's host-span buffer, or None where the
    program has none."""
    try:
        from repro_torch.trace import host
    except ImportError:
        return None
    return list(host.TRACER.spans), host.TRACER.dropped


def trace_path() -> Path | None:
    """The traced run's Chrome trace: the newest one written, which the run
    writes just before its readers run."""
    found = sorted((harness.CACHE / "traces").glob("*.json.gz"), key=lambda p: p.stat().st_mtime)
    return found[-1] if found else None


def read_trace(path: Path) -> tuple[tuple[float, float], int, list[tuple[float, float]]]:
    """(window (start, end) in the trace's microseconds, base in ns, the
    device's busy intervals inside the window, merged)."""
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt") as fh:
        doc = json.load(fh)
    events = doc["traceEvents"]
    start, end = float("-inf"), float("inf")
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" and \
                e.get("name") == tracing.WINDOW:
            start = float(e.get("ts", 0.0))
            end = start + float(e.get("dur", 0.0))
    busy = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat", "") in tracing.DEVICE_CATS:
            ts = float(e.get("ts", 0.0))
            lo, hi = max(ts, start), min(ts + float(e.get("dur", 0.0)), end)
            if hi > lo:
                busy.append((lo, hi))
    return (start, end), int(doc.get("baseTimeNanoseconds", 0)), tracing.union(busy)


def _length(intervals: list[tuple[float, float]]) -> float:
    return sum(hi - lo for lo, hi in tracing.union(intervals))


def attribute(window: tuple[float, float], busy: list[tuple[float, float]],
              spans: list[tuple]) -> dict:
    """The window's split over ``spans``, each (start, end, name, thread,
    is_wait, packets) on the trace's clock in microseconds:

    * ``window_us``;
    * ``intervals``: name -> that name's spans inside the window, merged;
    * ``time_us``: name -> their length;
    * ``span_us``: name -> the sum of them (nested spans of one name count
      once in ``time_us``, each in ``span_us``);
    * ``packets``: name -> packets carried, a span's count taken in the
      share of it that lies inside the window;
    * ``idle_us``: owner name (None: unnamed) -> the card's idle time it owns.
    """
    lo_w, hi_w = window
    inside = []
    for t0, t1, name, thread, wait, packets in spans:
        lo, hi = max(t0, lo_w), min(t1, hi_w)
        if hi > lo:
            inside.append((lo, hi, name, thread, wait, packets * (hi - lo) / (t1 - t0), t0))
    by_name: dict[str, list] = {}
    span_us: dict[str, float] = {}
    packets: dict[str, float] = {}
    for lo, hi, name, _, _, n, _ in inside:
        by_name.setdefault(name, []).append((lo, hi))
        span_us[name] = span_us.get(name, 0.0) + hi - lo
        packets[name] = packets.get(name, 0.0) + n
    intervals = {name: tracing.union(v) for name, v in by_name.items()}
    time_us = {name: sum(hi - lo for lo, hi in v) for name, v in intervals.items()}

    # the card's idle time before each instant, for any stretch's share of it
    idle = []
    at = lo_w
    for lo, hi in busy:
        if lo > at:
            idle.append((at, lo))
        at = max(at, hi)
    if hi_w > at:
        idle.append((at, hi_w))
    starts = [lo for lo, _ in idle]
    before = [0.0]
    for lo, hi in idle:
        before.append(before[-1] + hi - lo)

    def idle_until(t: float) -> float:
        i = bisect.bisect_right(starts, t) - 1
        if i < 0:
            return 0.0
        lo, hi = idle[i]
        return before[i] + min(t, hi) - lo

    # a sweep: ends before starts at one instant; an outer span opens first
    events = []
    for i, (lo, hi, _, _, _, _, t0) in enumerate(inside):
        events.append((lo, 1, -hi, t0, i))
        events.append((hi, 0, -t0, 0.0, i))
    events.sort()
    open_on: dict = {}
    owned: dict = {}
    prev = lo_w

    def owner():
        best = None
        for stack in open_on.values():
            if stack and not inside[stack[-1]][4]:
                top = stack[-1]
                if best is None or inside[top][6] > inside[best][6]:
                    best = top
        return None if best is None else inside[best][2]

    for t, kind, _, _, i in events:
        if t > prev:
            share = idle_until(t) - idle_until(prev)
            if share > 0:
                name = owner()
                owned[name] = owned.get(name, 0.0) + share
            prev = t
        stack = open_on.setdefault(inside[i][3], [])
        if kind == 1:
            stack.append(i)
        else:
            stack.remove(i)
    share = idle_until(hi_w) - idle_until(prev)
    if share > 0:
        owned[None] = owned.get(None, 0.0) + share
    return {"window_us": hi_w - lo_w, "intervals": intervals, "time_us": time_us,
            "span_us": span_us, "packets": packets, "idle_us": owned}


def window_split(ctx: dict) -> dict | None:
    """:func:`attribute` of this run's traced window, read once a run."""
    found = program_spans()
    path = trace_path()
    if found is None or path is None:
        return None
    spans, dropped = found
    key = (str(path), path.stat().st_mtime_ns, len(spans), dropped)
    if key in _cache:
        return _cache[key]
    window, base_ns, busy = read_trace(path)
    if window[0] == float("-inf"):
        harness.log(f"host spans: no {tracing.WINDOW} range in {path.name}; not read")
        return None
    rows = [((s.t0 - base_ns) / 1e3, (s.t1 - base_ns) / 1e3, s.name,
             s.node if s.node is not None else s.resource, s.cat == "wait",
             (s.args or {}).get("packets", 0))
            for s in spans]
    out = attribute(window, busy, rows)
    out["dropped"] = dropped
    if dropped or not out["time_us"]:
        harness.log(f"host spans: {len(spans)} recorded, {dropped} dropped, "
                    f"{len(out['time_us'])} names inside the window; not read")
        out = None
    else:
        owned = sorted(((name or "(unnamed)", us / 1e6) for name, us in out["idle_us"].items()),
                       key=lambda kv: -kv[1])
        harness.log(f"host spans: {len(spans)} recorded, 0 dropped; window "
                    f"{out['window_us'] / 1e6:.3f} s; seconds by span "
                    f"{json.dumps({k: round(v / 1e6, 4) for k, v in out['time_us'].items()})}; "
                    f"idle seconds by owner {json.dumps([[k, round(v, 4)] for k, v in owned])}")
    _cache[key] = out
    return out


def share(ctx: dict, names: tuple[str, ...]) -> float | None:
    """The union of ``names``' spans inside the window, in % of it."""
    split = window_split(ctx)
    if split is None:
        return None
    both = [iv for name in names for iv in split["intervals"].get(name, [])]
    return 100.0 * _length(both) / split["window_us"]
