"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``) on H100s.

    python3 h100bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` from the root of a checkout: set-up (the
cell's state made on the card from the seed, its shapes warmed up), a closed
loop for ``--seconds`` seconds, then the check of what the window produced
against a plain reference.  ``--trace 1`` starts the profiler, runs one
unit of the cell's work under it (the profiler's start-up lands there), then
the window for at most ``TRACE_WINDOW_S`` seconds, and reports the cell's
per-layer metrics, read over the window alone, instead of its end-to-end ones.
Prints the numbers compared beside their limits as the last lines of standard
error, and one JSON object as the last line of standard output.  Exits 2
without a result where the cell's cards are missing, and 1 where a forbidden
module (JAX, or the JAX package) was loaded in any of the cell's processes.
A cell on several cards runs one process a card (``rank_main``).
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
import harness as h  # noqa: E402

h.set_environment()

#: a traced run's window: the profiler's cost grows with the events it holds, and a 45 s traced
#: window of a four-card decode took 306-331 s of a run's 360
TRACE_WINDOW_S = 20.0


def limits_of(workload: str) -> dict:
    path = h.HERE / "limits" / f"{workload}.json"
    if not path.exists():
        return {}
    return {name: entry["limit"] for name, entry in json.loads(path.read_text()).items()}


def per_layer(spec: dict, workload: str, ctx: dict) -> dict:
    out = {}
    for metric in h.cell_metrics(spec, workload, trace=True):
        value = h.reader_of(metric["name"])(ctx)
        if value is not None:
            out[metric["name"]] = {"value": value, "unit": metric["unit"]}
    return out


def drive(cell, spec: dict, workload: str, seconds: float, trace: bool, device, chips: int,
          lead: bool = True, start: float = T_START) -> dict | None:
    """Set-up, window, check of one cell on this process's card; returns the
    result's pieces on the lead process."""
    import torch

    cell.setup()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if trace:
        cell.instrument()
    if hasattr(cell, "barrier"):
        cell.barrier()
    setup_s = time.time() - start
    out_trace = h.CACHE / "traces" / f"{workload}.json.gz"
    with h.tracing.profiled(trace and lead, out_trace):
        if trace:
            cell.window(0.0)
        with h.tracing.window_range(trace and lead):
            result = cell.window(min(seconds, TRACE_WINDOW_S) if trace else seconds)
    peak = cell.memory_peak() if hasattr(cell, "memory_peak") else (
        torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0)
    work_counts = cell.work() if trace else {}
    cell.release()
    numbers = cell.check()
    if not lead:
        return None
    power = h.power_line() if device.type == "cuda" else "cpu"
    out = {"result": result, "setup_s": setup_s, "peak": peak, "numbers": numbers,
           "power": power}
    if trace:
        summary = h.tracing.summarize(out_trace, cell.trace_labels())
        ctx = {"summary": summary, "window_s": result["window_s"], "work": work_counts,
               "chips": chips}
        out["per_layer"] = per_layer(spec, workload, ctx)
        out["summary"] = summary
    return out


def report(spec: dict, args, out: dict, chips: int) -> int:
    """The last lines: the numbers compared on standard error, the result
    object on standard output.  None where a forbidden module is loaded here
    or was in any rank of a cell on several cards (``out["forbidden"]``)."""
    found = {"main": h.forbidden_modules(), **out.get("forbidden", {})}
    found = {where: names for where, names in found.items() if names}
    if found:
        h.log(f"forbidden modules loaded: {found}")
        return 1
    result, numbers = out["result"], out["numbers"]
    limits = limits_of(args.workload)
    correct, compared = h.judge(numbers, limits)
    correct = correct and bool(limits) and result["failed"] == 0
    if args.trace:
        metrics = out["per_layer"]
    else:
        metrics = {"setup_s": {"value": out["setup_s"], "unit": "s"}}
        units = {m["name"]: m["unit"] for m in spec["end_to_end"]}
        for name, value in result["metrics"].items():
            metrics[name] = {"value": value, "unit": units[name]}
    device = {**h.card_info(chips), "memory_peak_bytes": int(out["peak"])}
    breakdown = None
    if args.trace:
        summary = out["summary"]
        device["busy_s"] = summary["busy_s"]
        device["window_s"] = result["window_s"]
        breakdown = {"device_ops": summary["device_ops"], "idle_gaps": summary["idle_gaps"]}
    extra = {k: v for k, v in numbers.items() if k.startswith("_")}
    h.log(f"card {out['power']}; window {result['window_s']:.3f} s, attempted "
          f"{result['attempted']}, failed {result['failed']}; set-up {out['setup_s']:.3f} s; "
          f"{json.dumps(extra, default=str)}")
    for name, entry in compared.items():
        h.log(f"compared {name} {entry['value']!r} limit {entry['limit']!r}")
    print(h.result_line(correct, result["attempted"], result["failed"], metrics, device,
                        compared, breakdown), flush=True)
    return 0


def forbidden_by_rank() -> dict:
    """Every rank's forbidden modules, gathered on rank 0 ({rank: names})."""
    import torch.distributed as dist

    names = [None] * dist.get_world_size()
    dist.all_gather_object(names, h.forbidden_modules())
    return {f"rank {r}": found for r, found in enumerate(names)}


def rank_main(rank: int, payload: dict) -> None:
    """One rank of a cell on several cards (spawned by ``harness.launch``):
    set-up, window and check on this rank's card, then the forbidden-module
    check of every rank; rank 0 writes the result's pieces."""
    import torch.distributed as dist

    spec = h.load_spec()
    h.port_path()
    kind = h.kind_of(payload["mix"])
    dev = h.join_world(payload, rank)
    try:
        cell = kind.Cell(h, payload["config"], payload["mix"], payload["seed"], dev,
                         payload["chips"])
        out = drive(cell, spec, payload["workload"], payload["seconds"], payload["trace"], dev,
                    payload["chips"], lead=rank == 0, start=payload["start"])
        forbidden = forbidden_by_rank()
        if rank == 0:
            out["forbidden"] = forbidden
            Path(payload["out"]).write_text(json.dumps(out, default=str))
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    spec = h.load_spec()
    cell = h.cell_of(spec, args.workload)
    config = h.config_of(spec, cell["config"])
    mix = h.mix_of(cell["traffic"])
    chips = cell["chips"]
    h.port_path()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        h.log(f"{args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    if chips > 1:
        out = h.launch(rank_main, {
            "workload": args.workload, "seed": args.seed, "seconds": args.seconds,
            "trace": bool(args.trace), "chips": chips, "config": config, "mix": mix,
            "start": T_START}, chips)
    else:
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        cell_obj = h.kind_of(mix).Cell(h, config, mix, args.seed, dev, chips)
        out = drive(cell_obj, spec, args.workload, args.seconds, bool(args.trace), dev, chips)
    return report(spec, args, out, chips)


if __name__ == "__main__":
    sys.exit(main())
