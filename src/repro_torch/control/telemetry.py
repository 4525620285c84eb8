"""Windowed event-time telemetry: the control plane's sensor.

PR 1's :class:`~repro_torch.sim.workload.Metrics` reports end-of-run peaks and
aggregate percentiles — enough to *measure* a scenario, not enough to
*steer* one.  The controller (``repro_torch.control.autoscaler``) and the SLO
benchmarks both need the signal over time: goodput per window, tail
latency per window, queue depths sampled in event time, loss and repair
bytes as they happen.  :class:`Telemetry` is that signal: a bounded ring
of :class:`TelemetryWindow` records, each aggregating one fixed-width
slice of simulated time.

The ring is filled from two directions:

  * the workload's :class:`Metrics` forwards every issue / drop /
    completion (so counts and latencies land in the window of their
    event time), and
  * the workload schedules a periodic event-time sampler that records
    gauge readings (HPU queue depth and occupancy, ingress/CPU queue
    depth, cumulative network loss) every ``window_ns``.

Everything is deterministic: windows are keyed by ``now // window_ns``
and the ring holds the most recent ``capacity`` windows, so a long-running
scenario can stream forever in bounded memory while the controller reads
a steady-state summary of the recent past (:meth:`Telemetry.summary`
drops configurable warmup windows).
"""

from __future__ import annotations

import collections
import dataclasses
import math


@dataclasses.dataclass
class TelemetryWindow:
    """Aggregates of one ``window_ns``-wide slice of event time.

    ``latencies_ns`` and ``bytes`` cover *foreground* completions only —
    background (repair/rebuild) completions count into ``bg_completed``
    and ``repair_bytes`` so a paced rebuild's long transfers never
    masquerade as foreground tail latency in the SLO signal."""

    index: int
    t0_ns: float
    t1_ns: float
    issued: int = 0
    completed: int = 0
    bg_completed: int = 0
    dropped: int = 0
    bytes: int = 0
    repair_bytes: int = 0
    latencies_ns: list[float] = dataclasses.field(default_factory=list)
    # gauge samples (event-time sampler):
    samples: int = 0
    hpu_queued_max: int = 0
    hpu_in_use_max: int = 0
    ingress_queued_max: int = 0
    cpu_queued_max: int = 0
    lost_packets: int = 0
    lost_bytes: int = 0
    # per-policy completion split, keyed by the workload's policy names
    # (the same names the counter registry / per_policy reports use)
    by_policy: dict = dataclasses.field(default_factory=dict)

    def p99_ns(self) -> float:
        return self.percentile_ns(99.0)

    def percentile_ns(self, p: float) -> float:
        if not self.latencies_ns:
            return math.nan
        s = sorted(self.latencies_ns)
        rank = max(1, math.ceil(p / 100.0 * len(s)))
        return s[rank - 1]

    def goodput_GBps(self) -> float:
        span = self.t1_ns - self.t0_ns
        return self.bytes / span if span > 0 else 0.0


class Telemetry:
    """Bounded ring of event-time windows shared by controller and bench.

    ``window_ns`` is the sampling period; ``capacity`` bounds memory (the
    oldest windows fall off).  All ``record_*`` calls attribute to the
    window containing ``now``; windows are created on demand and are
    strictly ordered (event time never goes backwards in the sim).
    """

    def __init__(self, window_ns: float = 50_000.0, capacity: int = 4096):
        if window_ns <= 0:
            raise ValueError(f"window_ns must be positive, got {window_ns}")
        self.window_ns = float(window_ns)
        self.capacity = capacity
        self.windows: collections.deque[TelemetryWindow] = collections.deque(maxlen=capacity)
        self.evicted = 0  # windows that fell off the ring (no silent loss)

    # -- window bookkeeping --------------------------------------------------

    def _window(self, now: float) -> TelemetryWindow:
        idx = int(now // self.window_ns)
        if self.windows and self.windows[-1].index == idx:
            return self.windows[-1]
        if self.windows and self.windows[-1].index > idx:
            # late completion of a request issued in an earlier window:
            # attribute to the newest window rather than resurrecting a
            # possibly-evicted one (monotone ring)
            return self.windows[-1]
        if len(self.windows) == self.capacity:
            self.evicted += 1
        win = TelemetryWindow(
            index=idx,
            t0_ns=idx * self.window_ns,
            t1_ns=(idx + 1) * self.window_ns,
        )
        self.windows.append(win)
        return win

    # -- counter feeds (Metrics forwards these) ------------------------------

    def record_issue(self, now: float) -> None:
        self._window(now).issued += 1

    def record_drop(self, now: float) -> None:
        self._window(now).dropped += 1

    def record_complete(
        self,
        now: float,
        latency_ns: float,
        nbytes: int,
        background: bool = False,
        policy: str | None = None,
    ) -> None:
        win = self._window(now)
        win.completed += 1
        if background:
            # background work is accounted (conservation) but kept out
            # of the foreground latency/goodput the SLO scores
            win.bg_completed += 1
            win.repair_bytes += nbytes
        else:
            win.latencies_ns.append(latency_ns)
            win.bytes += nbytes
        if policy is not None:
            pp = win.by_policy.setdefault(
                policy, {"completed": 0, "bytes": 0, "latencies_ns": []}
            )
            pp["completed"] += 1
            if not background:
                pp["bytes"] += nbytes
                pp["latencies_ns"].append(latency_ns)

    # -- gauge feed (the workload's event-time sampler) ----------------------

    def sample(
        self,
        now: float,
        hpu_queued: int = 0,
        hpu_in_use: int = 0,
        ingress_queued: int = 0,
        cpu_queued: int = 0,
        lost_packets: int = 0,
        lost_bytes: int = 0,
    ) -> None:
        win = self._window(now)
        win.samples += 1
        win.hpu_queued_max = max(win.hpu_queued_max, hpu_queued)
        win.hpu_in_use_max = max(win.hpu_in_use_max, hpu_in_use)
        win.ingress_queued_max = max(win.ingress_queued_max, ingress_queued)
        win.cpu_queued_max = max(win.cpu_queued_max, cpu_queued)
        win.lost_packets += lost_packets
        win.lost_bytes += lost_bytes

    # -- reads ---------------------------------------------------------------

    def series(self, field: str) -> list[float]:
        """Per-window time series of one counter/gauge (bench plotting)."""
        out = []
        for win in self.windows:
            v = getattr(win, field)
            out.append(v() if callable(v) else v)
        return out

    def steady_windows(self, warmup_frac: float = 0.2) -> list[TelemetryWindow]:
        """The ring minus its leading warmup (at least one window kept)."""
        wins = list(self.windows)
        if not wins:
            return wins
        skip = min(int(len(wins) * warmup_frac), len(wins) - 1)
        return wins[skip:]

    def summary(self, warmup_frac: float = 0.2) -> dict:
        """Steady-state controller view: foreground goodput over the
        post-warmup span, foreground p99 across its completions, peak
        queue gauges.  Background (repair) traffic shows up only as
        ``repair_GBps`` — never in the SLO-scored latency or goodput.

        This is what the autoscaler steers on — the same numbers a
        benchmark reads back for its rows.  If the warmup trim left no
        foreground completions (a run shorter than a few windows), the
        summary recomputes over the whole ring so the controller always
        scores the same definition of the signal.
        """
        wins = self.steady_windows(warmup_frac)
        if warmup_frac > 0 and not any(w.latencies_ns for w in wins):
            return self.summary(warmup_frac=0.0)
        if not wins:
            return {
                "windows": 0,
                "completed": 0,
                "goodput_GBps": 0.0,
                "p99_ns": math.nan,
                "repair_GBps": 0.0,
                "hpu_queued_max": 0,
                "lost_packets": 0,
                "per_policy": {},
            }
        lat: list[float] = []
        for w in wins:
            lat.extend(w.latencies_ns)
        lat.sort()
        span = wins[-1].t1_ns - wins[0].t0_ns
        nbytes = sum(w.bytes for w in wins)
        repair = sum(w.repair_bytes for w in wins)
        if lat:
            p99 = lat[max(1, math.ceil(0.99 * len(lat))) - 1]
        else:
            p99 = math.nan
        # per-policy split over the same steady windows (keys are the
        # workload's policy names, shared with the counter registry and
        # the report's ``per_policy`` section)
        per_policy: dict[str, dict] = {}
        for w in wins:
            for name, pp in w.by_policy.items():
                agg = per_policy.setdefault(
                    name, {"completed": 0, "bytes": 0, "latencies_ns": []}
                )
                agg["completed"] += pp["completed"]
                agg["bytes"] += pp["bytes"]
                agg["latencies_ns"].extend(pp["latencies_ns"])
        for name, agg in per_policy.items():
            pl = sorted(agg.pop("latencies_ns"))
            agg["p99_ns"] = (pl[max(1, math.ceil(0.99 * len(pl))) - 1]
                             if pl else math.nan)
            agg["goodput_GBps"] = agg["bytes"] / span if span > 0 else 0.0
        return {
            "windows": len(wins),
            "completed": sum(w.completed for w in wins),
            "goodput_GBps": nbytes / span if span > 0 else 0.0,
            "p99_ns": p99,
            "repair_GBps": repair / span if span > 0 else 0.0,
            "hpu_queued_max": max(w.hpu_queued_max for w in wins),
            "lost_packets": sum(w.lost_packets for w in wins),
            "per_policy": dict(sorted(per_policy.items())),
        }
