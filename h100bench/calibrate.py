"""Readings that the limits of ``limits/<cell>.json`` are set from: the
program's numbers over many seeds, the control's, and each planted fault's,
at the cell's own size, in one process.

    python3 h100bench/calibrate.py --workload <name> --seeds <n> ... \
        [--seconds S] [--control] [--faults half altered unchanged]

For a training cell the program's readings come from set-up's checked steps
(no window is needed, ``--seconds 0``); the control is the plain reference
in fp8 put in the program's place, compared with the fp32 reference.  For
the checkpoint cell each side runs set-up and a window of ``--seconds``.
Prints one JSON line a reading: side, seed, fault, numbers, seconds.  The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import faults  # noqa: E402
import harness as h  # noqa: E402

h.set_environment()


def free() -> None:
    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def one_run(kind, config, mix, seed, dev, seconds, fault=None, mode=None):
    cell = kind.Cell(h, config, mix, seed, dev)
    ctx = faults.FAULTS[mode](fault) if fault else None
    if ctx is not None:
        ctx.__enter__()
    try:
        cell.setup()
        if seconds:
            cell.window(seconds)
        cell.release()
        if mode != "train":
            numbers = cell.check()
    finally:
        if ctx is not None:
            ctx.__exit__(None, None, None)
    return cell, (None if mode == "train" else numbers)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, default=0.0)
    parser.add_argument("--control", action="store_true")
    parser.add_argument("--faults", nargs="*", default=[])
    args = parser.parse_args()
    spec = h.load_spec()
    cell = h.cell_of(spec, args.workload)
    config, mix = h.config_of(spec, cell["config"]), h.mix_of(cell["traffic"])
    h.port_path()
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    kind, mode = h.kind_of(mix), mix["kind"]
    print(json.dumps({"card": h.power_line()}), flush=True)
    def emit(side, seed, numbers, t0, fault=None):
        print(json.dumps({"side": side, "seed": seed, "fault": fault, "numbers": numbers,
                          "seconds": time.perf_counter() - t0}, default=str), flush=True)

    for seed in args.seeds:
        t0 = time.perf_counter()
        program, numbers = one_run(kind, config, mix, seed, dev, args.seconds, mode=mode)
        if mode == "train":
            ref = program.reference()
            numbers = kind.compare(program.readings, ref)
        emit("program", seed, numbers, t0)
        del program
        free()
        if args.control:
            t0 = time.perf_counter()
            if mode == "train":
                ctl = kind.Cell(h, config, mix, seed, dev)
                numbers = kind.compare(ctl.reference(control=True), ref)
                del ctl
            else:
                _, numbers = one_run(kind, config, mix, seed, dev, args.seconds, "control", mode)
            emit("control", seed, numbers, t0)
            free()
        for fault in args.faults:
            t0 = time.perf_counter()
            planted, numbers = one_run(kind, config, mix, seed, dev, args.seconds, fault, mode)
            if mode == "train":
                numbers = kind.compare(planted.readings, ref)
            emit("fault", seed, numbers, t0, fault)
            del planted
            free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
