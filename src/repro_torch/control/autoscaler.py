"""SLO-driven HPU autoscaler: closing the loop the sweeps left open.

Fig. 16 sizes the SmartNIC data plane statically — how many HPUs does a
handler need to sustain line rate — and PR 1's contention sweeps
confirmed the sim reproduces the compute-bound regime (sPIN-TriEC
saturates at ~11.7 GB/s with 32 HPUs).  This module makes that sizing a
*decision*: an :class:`SLO` (tail latency + goodput floor) plus an
:class:`Autoscaler` that reruns a :class:`~repro_torch.sim.workload.Scenario`
in epochs, reading each epoch's steady-state :class:`Telemetry` summary
and resizing ``PsPINConfig.num_hpus`` between epochs until it has
converged on the minimal HPU count meeting the SLO.

The search is doubling-then-bisection with hysteresis: while the SLO is
violated the HPU count doubles (the classic scale-up escalation); once it
is met the controller bisects the bracket downwards, but only while the
SLO is met with more than ``hysteresis`` headroom — an epoch that barely
meets its SLO is accepted rather than risking a flap.  Every epoch is a
fresh deterministic run of the same scenario, so the whole trajectory is
reproducible.

:meth:`Autoscaler.pick_fanout` adds the second actuator the tentpole
names: given candidate RS geometries (or replica counts), it converges
each one and returns the cheapest fan-out whose SLO is attainable —
HPU count first, storage overhead as the tie-break.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.control.telemetry import Telemetry
from repro_torch.sim.network import NetConfig
from repro_torch.sim.pspin import PsPINConfig
from repro_torch.sim.workload import Scenario, Workload


@dataclasses.dataclass(frozen=True)
class SLO:
    """A service-level objective over one scenario's steady state.

    ``p99_ns``: completed-request p99 latency ceiling (inf == don't
    care).  ``goodput_frac``: goodput floor as a fraction of the line
    rate (``NetConfig.bytes_per_ns`` GB/s; 0 == don't care)."""

    p99_ns: float = math.inf
    goodput_frac: float = 0.0

    def scores(self, p99_ns: float, goodput_GBps: float, line_GBps: float) -> dict:
        """Per-objective attainment scores (>= 1 means met)."""
        out = {}
        if math.isfinite(self.p99_ns):
            if math.isnan(p99_ns) or p99_ns <= 0:
                out["p99"] = 0.0
            else:
                out["p99"] = self.p99_ns / p99_ns
        if self.goodput_frac > 0:
            out["goodput"] = goodput_GBps / (self.goodput_frac * line_GBps)
        return out

    def attainment(self, p99_ns: float, goodput_GBps: float, line_GBps: float) -> float:
        """SLO attainment score: >= 1 means every objective is met; the
        minimum over objectives, so the binding constraint dominates."""
        s = self.scores(p99_ns, goodput_GBps, line_GBps)
        return min(s.values()) if s else math.inf

    def binding(self, p99_ns: float, goodput_GBps: float, line_GBps: float) -> str | None:
        """Name of the binding (minimum-score) objective, or None."""
        s = self.scores(p99_ns, goodput_GBps, line_GBps)
        return min(s, key=s.get) if s else None


@dataclasses.dataclass
class Epoch:
    """One controller step: the HPU count tried and what it measured."""

    num_hpus: int
    p99_ns: float
    goodput_GBps: float
    attainment: float
    binding: str | None = None  # which objective is the minimum score
    report: dict = dataclasses.field(repr=False, default_factory=dict)

    @property
    def met(self) -> bool:
        return self.attainment >= 1.0


@dataclasses.dataclass
class AutoscaleResult:
    """Converged controller state + the full epoch trajectory."""

    num_hpus: int
    met: bool
    epochs: list[Epoch]
    slo: SLO

    @property
    def epochs_run(self) -> int:
        return len(self.epochs)


class Autoscaler:
    """Epoch-based SLO controller over ``PsPINConfig.num_hpus``."""

    def __init__(
        self,
        slo: SLO,
        hpu_min: int = 1,
        hpu_max: int = 1024,
        hysteresis: float = 0.05,
        max_epochs: int = 24,
        warmup_frac: float = 0.2,
        window_ns: float = 50_000.0,
    ):
        if hpu_min < 1 or hpu_max < hpu_min:
            raise ValueError(f"bad HPU bounds [{hpu_min}, {hpu_max}]")
        if hysteresis < 0:
            raise ValueError(f"hysteresis must be >= 0, got {hysteresis}")
        self.slo = slo
        self.hpu_min = hpu_min
        self.hpu_max = hpu_max
        self.hysteresis = hysteresis
        self.max_epochs = max_epochs
        self.warmup_frac = warmup_frac
        self.window_ns = window_ns

    # -- one epoch -----------------------------------------------------------

    def run_epoch(
        self,
        scenario: Scenario,
        num_hpus: int,
        cfg: NetConfig | None = None,
        pcfg: PsPINConfig | None = None,
    ) -> Epoch:
        """Run the scenario once at ``num_hpus`` and score it against the
        SLO from the telemetry ring's steady-state summary."""
        pcfg_e = dataclasses.replace(pcfg or PsPINConfig(), num_hpus=num_hpus)
        tel = Telemetry(window_ns=self.window_ns)
        w = Workload(scenario, cfg, pcfg_e, telemetry=tel)
        rep = w.run()
        summ = tel.summary(warmup_frac=self.warmup_frac)
        # the telemetry ring is the single metric source (foreground-only
        # p99/goodput; summary() itself widens past the warmup trim when
        # a run is too short) — a NaN p99 here means the scenario truly
        # completed no foreground requests, which scores as violating
        p99 = summ["p99_ns"]
        goodput = summ["goodput_GBps"]
        line = w.env.cfg.bytes_per_ns
        att = self.slo.attainment(p99, goodput, line)
        rep["telemetry"] = summ
        return Epoch(num_hpus, p99, goodput, att, self.slo.binding(p99, goodput, line), rep)

    # -- the control loop ----------------------------------------------------

    def run(
        self,
        scenario: Scenario,
        cfg: NetConfig | None = None,
        pcfg: PsPINConfig | None = None,
        start_hpus: int | None = None,
    ) -> AutoscaleResult:
        """Converge on the minimal HPU count meeting the SLO.

        Doubling while violated, bisection once bracketed, hysteresis on
        the way down; stops when the bracket closes, the SLO is met with
        <= ``hysteresis`` headroom, or the epoch budget runs out."""
        if start_hpus is None:
            start_hpus = (pcfg or PsPINConfig()).num_hpus
        h = min(max(start_hpus, self.hpu_min), self.hpu_max)
        lo = self.hpu_min - 1  # highest HPU count known to violate
        hi: int | None = None  # lowest HPU count known to meet
        epochs: list[Epoch] = []
        seen: dict[int, Epoch] = {}
        while len(epochs) < self.max_epochs:
            ep = seen.get(h)
            if ep is None:
                ep = self.run_epoch(scenario, h, cfg, pcfg)
                seen[h] = ep
                epochs.append(ep)
            if not ep.met:
                lo = max(lo, h)
                if hi is not None:
                    if hi - lo <= 1:
                        return AutoscaleResult(hi, True, epochs, self.slo)
                    h = (lo + hi) // 2
                elif h >= self.hpu_max:
                    # SLO unattainable within bounds: report the ceiling
                    return AutoscaleResult(self.hpu_max, False, epochs, self.slo)
                else:
                    h = min(h * 2, self.hpu_max)
                continue
            hi = h if hi is None else min(hi, h)
            if hi - lo <= 1:
                return AutoscaleResult(hi, True, epochs, self.slo)
            if ep.binding == "p99" and ep.attainment <= 1.0 + self.hysteresis:
                # met with the *latency* objective binding and no real
                # headroom: p99 responds monotonically to HPUs, so one
                # step down would violate — accept instead of flapping.
                # (A binding goodput score is no such signal: goodput
                # saturates in H, so the controller keeps descending.)
                return AutoscaleResult(hi, True, epochs, self.slo)
            h = (lo + hi) // 2
        # epoch budget exhausted: best known operating point
        if hi is not None:
            return AutoscaleResult(hi, True, epochs, self.slo)
        return AutoscaleResult(h, epochs[-1].met, epochs, self.slo)

    # -- fan-out choice ------------------------------------------------------

    @staticmethod
    def _scenario_with_geometry(scenario: Scenario, k: int, m: int) -> Scenario:
        """The scenario at fan-out (k, m): the preset knobs are replaced
        directly, and any explicit :class:`~repro_torch.policy.PolicySpec`
        loads are resized through ``PolicySpec.with_geometry`` (loads
        without a replication/erasure stage pass through unchanged)."""
        sc = dataclasses.replace(scenario, k=k, m=m)
        if scenario.policies:
            loads = []
            for pl in scenario.policies:
                spec = pl.spec
                if getattr(spec, "erasure", None) is not None:
                    spec = spec.with_geometry(k, m)
                elif getattr(spec, "replication", None) is not None:
                    spec = spec.with_geometry(k)
                loads.append(dataclasses.replace(pl, spec=spec))
            sc = dataclasses.replace(sc, policies=loads)
        return sc

    def pick_fanout(
        self,
        scenario: Scenario,
        geometries: list[tuple[int, int]],
        cfg: NetConfig | None = None,
        pcfg: PsPINConfig | None = None,
    ) -> tuple[tuple[int, int], AutoscaleResult, dict]:
        """Converge every candidate ``(k, m)`` fan-out and return the
        cheapest one meeting the SLO: minimal converged HPU count, ties
        broken by storage overhead ``(k + m) / k``.  Raises if no
        candidate attains the SLO within the HPU bounds."""
        results: dict[tuple[int, int], AutoscaleResult] = {}
        for k, m in geometries:
            sc = self._scenario_with_geometry(scenario, k, m)
            results[(k, m)] = self.run(sc, cfg, pcfg)
        attained = [(km, r) for km, r in results.items() if r.met]
        if not attained:
            raise ValueError(
                f"no candidate fan-out attains {self.slo} within "
                f"[{self.hpu_min}, {self.hpu_max}] HPUs"
            )
        best = min(
            attained,
            key=lambda kr: (kr[1].num_hpus, (kr[0][0] + kr[0][1]) / kr[0][0]),
        )
        return best[0], best[1], {km: r.num_hpus for km, r in results.items()}
