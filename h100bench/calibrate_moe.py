"""Readings that a DeepSeek-V2 training cell's limits (``limits/<cell>.json``)
are set from: the program's numbers over many seeds, the fp8 control's, and
a planted fault's, at the cell's own size, in one process.

    python3 h100bench/calibrate_moe.py --workload dsv2lite-train4k --seeds <n> ... \
        [--control] [--planted]

The program's readings come from set-up's checked steps (no window); the
control is the plain reference in fp8 put in the program's place, compared
with the fp32 reference; the planted fault runs the program with the top-k
weights renormalised to sum 1 (``norm_topk_prob`` true, against the
published false) and compares it with the published reference.  Prints one
JSON line a reading: side, seed, numbers, seconds.  The benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import harness as h  # noqa: E402

h.set_environment()


def free() -> None:
    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def program_readings(kind, config, mix, seed, dev) -> dict:
    cell = kind.Cell(h, config, mix, seed, dev)
    cell.setup()
    cell.release()
    readings = cell.readings
    del cell
    free()
    return readings


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control", action="store_true")
    parser.add_argument("--planted", action="store_true")
    args = parser.parse_args()
    spec = h.load_spec()
    entry = h.cell_of(spec, args.workload)
    config, mix = h.config_of(spec, entry["config"]), h.mix_of(entry["traffic"])
    h.port_path()
    import torch

    if not torch.cuda.is_available():
        print("calibrate_moe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    kind = h.kind_of(mix)
    print(json.dumps({"card": h.power_line()}), flush=True)

    def emit(side, seed, numbers, t0):
        print(json.dumps({"side": side, "seed": seed, "numbers": numbers,
                          "seconds": time.perf_counter() - t0}, default=str), flush=True)

    for seed in args.seeds:
        t0 = time.perf_counter()
        ours = program_readings(kind, config, mix, seed, dev)
        ref = kind.Cell(h, config, mix, seed, dev).reference()
        emit("program", seed, kind.compare(ours, ref), t0)
        free()
        if args.control:
            t0 = time.perf_counter()
            control = kind.Cell(h, config, mix, seed, dev).reference(control=True)
            emit("control", seed, kind.compare(control, ref), t0)
            free()
        if args.planted:
            t0 = time.perf_counter()
            planted = program_readings(kind, {**config, "norm_topk_prob": True}, mix, seed, dev)
            emit("planted normalised top-k", seed, kind.compare(planted, ref), t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
