"""The traced run: ``torch.profiler`` over the window, its Chrome trace written
gzipped under the checkout's ``build/``, and reduced to what the per-layer
readers take: the device's busy time, the device time of the kernels launched
inside each of the benchmark's ranges, the device operations that took most,
and the longest idle gaps with what the host was doing.

The ranges are ``record_function`` spans that the cell's traffic module wraps
around the program's functions from outside (:func:`ranged`); a kernel belongs
to the innermost range that encloses the call that launched it (the
profiler's correlation id ties the two).  A backward runs inside its autograd
node's range, since the wrapped ``backward`` opens it on autograd's thread.

The profiler starts before the window: one unit of the cell's work runs
under it first, so that its start-up lands there, and only what ran inside
the ``WINDOW`` range counts.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import gzip
import json
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
TOP = 10
#: the range around the measured window; events outside it are left out
WINDOW = "h100bench.window"


def ranged(label: str, fn):
    """``fn`` inside a ``record_function(label)`` range."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        from torch.profiler import record_function

        with record_function(label):
            return fn(*args, **kwargs)

    return wrapper


def wrap(owner, attr: str, label: str, static: bool = False) -> None:
    """Replace ``owner.attr`` by itself inside a range named ``label``."""
    fn = getattr(owner, attr)
    new = ranged(label, fn)
    setattr(owner, attr, staticmethod(new) if static else new)


@contextlib.contextmanager
def profiled(enabled: bool, out: Path):
    """The profiler over the block when ``enabled``; the trace lands at ``out``."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    out.parent.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield prof
    prof.export_chrome_trace(str(out))


def window_range(enabled: bool):
    """The ``WINDOW`` range when ``enabled``, else nothing."""
    if not enabled:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(WINDOW)


def union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return [(lo, hi) for lo, hi in merged]


class _Spans:
    """Intervals on one thread, for the innermost one holding a time."""

    def __init__(self, spans: list[tuple[float, float, str]]):
        self.spans = sorted(spans)
        self.starts = [s[0] for s in self.spans]

    def at(self, t: float, depth: int = 64) -> str | None:
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and depth:
            lo, hi, name = self.spans[i]
            if lo <= t <= hi:
                return name
            i -= 1
            depth -= 1
        return None


def summarize(path: Path, labels: tuple[str, ...]) -> dict:
    """The trace at ``path`` reduced to the ``WINDOW`` range (the whole trace
    where it has none): ``busy_s``; ``range_s`` (label -> device seconds of
    the kernels launched inside it); ``kernels_s`` (name -> device seconds);
    ``device_ops`` and ``idle_gaps`` (each the ``TOP`` largest, as [name,
    seconds]).  A device event that straddles an end of the window counts
    for its part inside."""
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt") as fh:
        events = json.load(fh)["traceEvents"]
    start, end = float("-inf"), float("inf")
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e.get("name") == WINDOW:
            start = float(e.get("ts", 0.0))
            end = start + float(e.get("dur", 0.0))
    device, launches = [], {}
    ranges: dict = {}
    host: dict = {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            lo, hi = max(ts, start), min(ts + dur, end)
            if hi > lo:
                device.append((lo, hi, e.get("name", "?"),
                               (e.get("args") or {}).get("correlation")))
        elif cat in LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = (e.get("tid"), ts)
        elif cat == "user_annotation" and e.get("name") in labels:
            ranges.setdefault(e.get("tid"), []).append((ts, ts + dur, e["name"]))
        if cat in ("user_annotation", "cpu_op"):
            host.setdefault("all", []).append((ts, ts + dur, e.get("name", "?")))
    spans = {tid: _Spans(v) for tid, v in ranges.items()}
    range_s = {label: 0.0 for label in labels}
    kernels_s: dict[str, float] = {}
    for lo, hi, name, corr in device:
        kernels_s[name] = kernels_s.get(name, 0.0) + (hi - lo) / 1e6
        launch = launches.get(corr)
        if launch is None or launch[0] not in spans:
            continue
        label = spans[launch[0]].at(launch[1])
        if label is not None:
            range_s[label] += (hi - lo) / 1e6
    busy = union([(lo, hi) for lo, hi, _, _ in device])
    busy_s = sum(hi - lo for lo, hi in busy) / 1e6
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    gaps.sort(key=lambda g: g[0] - g[1])
    on_host = _Spans(host.get("all", []))
    idle = {}
    for lo, hi in gaps[:200]:
        label = on_host.at((lo + hi) / 2) or "host (no profiled op)"
        idle[label] = idle.get(label, 0.0) + (hi - lo) / 1e6
    top_ops = sorted(kernels_s.items(), key=lambda kv: -kv[1])[:TOP]
    top_gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": busy_s, "range_s": range_s, "kernels_s": kernels_s,
            "device_events": len(device),
            "device_ops": [[name[:120], s] for name, s in top_ops],
            "idle_gaps": [[name[:120], s] for name, s in top_gaps]}
