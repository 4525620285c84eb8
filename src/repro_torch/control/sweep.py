"""Control-plane sweep driver: PolicySpec x HPU x failure grids.

Produces ``BENCH_control.json`` (gated by ``tools/check_anchors.py``),
the end-to-end reproduction of the paper's Fig. 16 scaling claim plus
the two control-loop claims this PR adds:

  fig16      goodput vs ``PsPINConfig.num_hpus`` for sPIN-TriEC under
             the multi-client workload engine: the curve saturates near
             line rate, with the knee within one doubling of the
             analytic per-handler model (``hpus_for_line_rate`` scaled
             by the per-data-node ingest share) — run healthy and with
             a straggler data node (the failure axis);
  autoscale  for >= 3 distinct PolicySpec presets, the SLO-driven
             autoscaler converges within one doubling of the
             static-optimal HPU count found by a brute-force ladder
             scan (both read the same telemetry summary, so the
             comparison is apples-to-apples);
  pacing     a token-bucket-paced background EC/rebuild stream keeps
             the foreground p99 within the configured SLO, while the
             same stream unpaced measurably violates it.

``benchmarks/autoscale.py`` is the CLI entry point and
``benchmarks/run.py --autoscale`` runs the same sweep in the harness.
"""

from __future__ import annotations

import dataclasses

from repro_torch.control.autoscaler import SLO, Autoscaler
from repro_torch.policy import FailureModel
from repro_torch.sim.network import NetConfig
from repro_torch.sim.pspin import HANDLER_NS, PsPINConfig, hpus_for_line_rate
from repro_torch.sim.workload import KiB, PolicyLoad, Scenario, SizeDist, run_scenario

MiB = 1 << 20

#: Fig. 16 grid: HPU counts swept for the goodput curve.
FIG16_HPUS = (32, 64, 128, 192, 256, 384, 512)
FIG16_HPUS_QUICK = (32, 128, 256)

#: foreground p99 SLO for the repair-pacing experiment (microseconds)
PACING_SLO_P99_US = 200.0
PACING_RATE_GBPS = 4.0


# ---------------------------------------------------------------------------
# Fig. 16: goodput vs num_hpus, healthy + straggler.
# ---------------------------------------------------------------------------


def fig16_scenario(quick: bool = False) -> Scenario:
    """The line-rate TriEC contention scenario: enough concurrent
    closed-loop clients that the client links can feed the HPU pools."""
    return Scenario(
        protocol="spin-triec",
        size=MiB,
        num_clients=4 if quick else 8,
        requests_per_client=4 if quick else 6,
        k=3,
        m=2,
        seed=3,
    )


def fig16_rows(quick: bool = False) -> tuple[list[tuple], dict]:
    grid = FIG16_HPUS_QUICK if quick else FIG16_HPUS
    sc = fig16_scenario(quick)
    variants = [("healthy", None)]
    if not quick:
        # failure axis: one 4x-straggler data node shifts the whole curve
        variants.append(("slow1x4", FailureModel(slow=((1, 4.0),))))
    rows: list[tuple] = []
    claims: dict = {}
    curves: dict[str, list[tuple[int, float]]] = {}
    line_GBps = NetConfig().bytes_per_ns  # GB/s == bytes/ns
    for tag, fm in variants:
        curve: list[tuple[int, float]] = []
        for h in grid:
            rep = run_scenario(
                dataclasses.replace(sc, failures=fm),
                pcfg=PsPINConfig(num_hpus=h),
            )
            curve.append((h, rep["goodput_GBps"]))
            rows.append(
                (
                    f"control/fig16/{tag}/h{h}",
                    round(rep["p99_us"], 2),
                    round(rep["goodput_GBps"], 2),
                )
            )
        curves[tag] = curve
    healthy = curves["healthy"]
    peak = max(g for _, g in healthy)
    knee = next(h for h, g in healthy if g >= 0.9 * peak)
    # analytic model: line-rate EC data handlers need hpus_for_line_rate
    # HPUs per NIC; in the k-wide stripe each data node ingests 1/k of
    # the goodput, so the measured knee sits at ~1/k of that
    predicted_nic = hpus_for_line_rate(HANDLER_NS["ec_data_rs32"][1], 400.0)
    predicted_knee = -(-predicted_nic // sc.k)
    rows.append(
        (
            "control/fig16/model/line-rate-hpus",
            float(predicted_nic),
            f"knee_model={predicted_knee}",
        )
    )
    claims.update(
        {
            "fig16_line_rate_GBps": line_GBps,
            "fig16_max_goodput_GBps": round(peak, 2),
            "fig16_goodput_frac": round(peak / line_GBps, 3),
            "fig16_saturation_gain": round(healthy[-1][1] / healthy[-2][1], 4),
            "fig16_knee_hpus": knee,
            "fig16_model_knee_hpus": predicted_knee,
            "fig16_knee_within_doubling": bool(predicted_knee / 2 <= knee <= 2 * predicted_knee),
        }
    )
    return rows, claims


# ---------------------------------------------------------------------------
# Autoscaler vs static-optimal, three distinct PolicySpec presets.
# ---------------------------------------------------------------------------

#: the HPU ladder the brute-force static scan walks (powers of two — the
#: same granularity Fig. 16 is usually plotted at)
STATIC_LADDER = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)


def autoscale_cases(quick: bool = False) -> list[tuple[str, Scenario, SLO]]:
    """Three distinct PolicySpec presets with SLOs whose static-optimal
    HPU count is interior to the ladder (calibrated against the probe
    sweeps; the claims re-derive the optimum every run).  The quick
    scenarios are smaller, so their achievable goodput plateau is lower
    and the SLOs are scaled to keep the optimum interior."""
    clients = 4 if quick else 8
    requests = 4 if quick else 8
    write_slo = (
        SLO(p99_ns=30_000.0, goodput_frac=0.5)
        if quick
        else SLO(p99_ns=60_000.0, goodput_frac=0.8)
    )
    ec_slo = (
        SLO(p99_ns=150_000.0, goodput_frac=0.4)
        if quick
        else SLO(p99_ns=250_000.0, goodput_frac=0.6)
    )
    return [
        (
            "spin-write",
            Scenario(
                protocol="spin-write",
                size=256 * KiB,
                num_clients=clients,
                requests_per_client=requests,
                seed=3,
            ),
            write_slo,
        ),
        (
            "spin-ring",
            Scenario(
                protocol="spin-ring",
                size=256 * KiB,
                num_clients=clients,
                requests_per_client=requests,
                k=4,
                seed=3,
            ),
            write_slo,
        ),
        (
            "spin-triec",
            Scenario(
                protocol="spin-triec",
                size=512 * KiB,
                num_clients=4 if quick else 6,
                requests_per_client=4 if quick else 5,
                k=3,
                m=2,
                seed=3,
            ),
            ec_slo,
        ),
    ]


def static_optimal(scaler: Autoscaler, sc: Scenario) -> int | None:
    """Brute-force ladder scan: the smallest ladder HPU count meeting
    the SLO (None if the SLO is unattainable on the ladder)."""
    for h in STATIC_LADDER:
        if scaler.run_epoch(sc, h).met:
            return h
    return None


def autoscale_rows(quick: bool = False) -> tuple[list[tuple], dict]:
    rows: list[tuple] = []
    claims: dict = {"autoscale_presets": [], "autoscale_within_doubling": 0}
    for name, sc, slo in autoscale_cases(quick):
        scaler = Autoscaler(slo, hpu_max=512)
        opt = static_optimal(scaler, sc)
        res = scaler.run(sc, start_hpus=32)
        within = opt is not None and res.met and res.num_hpus <= 2 * opt
        rows.append(
            (
                f"control/autoscale/{name}",
                float(res.num_hpus),
                f"static={opt},epochs={res.epochs_run},met={res.met}",
            )
        )
        claims["autoscale_presets"].append(
            {
                "preset": name,
                "converged_hpus": res.num_hpus,
                "static_opt_hpus": opt,
                "epochs": res.epochs_run,
                "met": res.met,
                "within_doubling": bool(within),
            }
        )
        claims["autoscale_within_doubling"] += int(within)
    return rows, claims


def fanout_rows() -> list[tuple]:
    """The second actuator: pick the cheapest RS fan-out meeting the
    SLO (HPU count first, storage overhead as tie-break).  The SLO is
    set below the quick scenario's saturation plateau so it is
    attainable for every candidate geometry."""
    _, sc, _ = autoscale_cases(quick=True)[2]
    slo = SLO(p99_ns=120_000.0, goodput_frac=0.5)
    scaler = Autoscaler(slo, hpu_max=512)
    best, res, all_h = scaler.pick_fanout(sc, [(3, 2), (6, 3)])
    detail = ";".join(f"rs{k}.{m}={h}" for (k, m), h in sorted(all_h.items()))
    return [(f"control/fanout/rs{best[0]}.{best[1]}", float(res.num_hpus), detail)]


# ---------------------------------------------------------------------------
# Repair pacing: token-bucket governor vs unpaced background rebuild.
# ---------------------------------------------------------------------------


def pacing_scenario(pace_GBps: float | None, quick: bool = False) -> Scenario:
    """Foreground small authenticated writes (open loop) against a
    background bulk EC stream standing in for a node rebuild — the two
    share storage node 1's link and HPU pool."""
    return Scenario(
        policies=[
            PolicyLoad("spin-write", 0.8, SizeDist("fixed", mean=64 * KiB)),
            PolicyLoad(
                "spin-triec",
                0.2,
                SizeDist("fixed", mean=MiB),
                background=True,
                pace_GBps=pace_GBps,
            ),
        ],
        size=64 * KiB,
        num_clients=4 if quick else 8,
        requests_per_client=8 if quick else 12,
        arrival="poisson",
        offered_load_GBps=12.0,
        k=3,
        m=2,
        seed=11,
    )


def pacing_rows(quick: bool = False) -> tuple[list[tuple], dict]:
    rows: list[tuple] = []
    claims: dict = {"pacing_slo_p99_us": PACING_SLO_P99_US}
    for tag, pace in (("unpaced", None), ("paced", PACING_RATE_GBPS)):
        rep = run_scenario(pacing_scenario(pace, quick))
        settled = rep["completed"] + rep["in_flight"] + rep["dropped"]
        assert rep["issued"] == settled, "conservation violated"
        fg = rep["per_policy"]["spin-write"]
        bg = rep["per_policy"]["spin-triec"]
        rows.append(
            (
                f"control/pacing/{tag}",
                round(fg["p99_us"], 2),
                f"bg_GBps={bg['goodput_GBps']:.2f},"
                f"paced_wait_us={rep['paced_wait_us']:.0f}",
            )
        )
        claims[f"{tag}_fg_p99_us"] = round(fg["p99_us"], 2)
    paced_ok = claims["paced_fg_p99_us"] <= PACING_SLO_P99_US
    unpaced_bad = PACING_SLO_P99_US < claims["unpaced_fg_p99_us"]
    claims["pacing_holds_slo"] = bool(paced_ok and unpaced_bad)
    return rows, claims


# ---------------------------------------------------------------------------
# Harness entry points.
# ---------------------------------------------------------------------------


def bench_rows(quick: bool = False) -> tuple[list[tuple], dict]:
    rows, claims = fig16_rows(quick)
    arows, aclaims = autoscale_rows(quick)
    rows += arows
    claims.update(aclaims)
    if not quick:
        rows += fanout_rows()
    prows, pclaims = pacing_rows(quick)
    rows += prows
    claims.update(pclaims)
    return rows, claims


def write_artifact(rows, claims, out, config=None) -> None:
    from repro_torch.bench import write_bench_artifact

    write_bench_artifact(
        out,
        "control",
        rows,
        metric="p99_us_or_hpus/derived",
        claims=claims,
        config=config or {},
    )
