#!/usr/bin/env python3
"""The kernels that ran inside the training attention's ranges of a traced run.

    python3 tools/attention_range_kernels.py build/h100bench/traces/yi9b-train4k.json.gz

Reads a Chrome trace of the benchmark's traced run (``h100bench/run.py
--trace 1`` leaves it under ``build/h100bench/traces/``) and prints the
device seconds of each kernel launched inside its ``attention`` ranges
(the forward and backward of ``_BlockwiseAttention``), within its
``h100bench.window`` range, and the seconds of fp32 FFMA GEMMs among them:
which kernels the training attention ran.  One JSON object; with
``--out``, also written there.  The kernels' own times against their
plain versions and bounds are ``chip_smoke.py``'s phase 2 rows.
"""

from __future__ import annotations

import argparse
import bisect
import gzip
import json
import math
import sys
from pathlib import Path


def attention_kernels(path: Path) -> dict:
    """Device seconds by kernel name of the kernels launched inside the
    trace's ``attention`` ranges, within its window range."""
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt") as fh:
        events = [e for e in json.load(fh)["traceEvents"] if e.get("ph") == "X"]
    lo, hi = -math.inf, math.inf
    ranges, launches, kernels = {}, {}, []
    for e in events:
        cat, name = e.get("cat", ""), e.get("name", "")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if cat == "user_annotation" and name == "h100bench.window":
            lo, hi = ts, ts + dur
        elif cat == "user_annotation" and name == "attention":
            ranges.setdefault(e.get("tid"), []).append((ts, ts + dur))
        elif cat in ("cuda_runtime", "cuda_driver"):
            launches[(e.get("args") or {}).get("correlation")] = (e.get("tid"), ts)
        elif cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            kernels.append((ts, dur, name, (e.get("args") or {}).get("correlation")))
    starts = {tid: sorted(r) for tid, r in ranges.items()}
    seconds: dict[str, float] = {}
    for ts, dur, name, corr in kernels:
        if not lo <= ts <= hi or corr not in launches:
            continue
        tid, at = launches[corr]
        spans = starts.get(tid, [])
        i = bisect.bisect_right(spans, (at, math.inf)) - 1
        # the few ranges on the launching thread that began before the launch: one still open counts
        if any(a <= at <= b for a, b in spans[max(0, i - 8):i + 1]):
            seconds[name] = seconds.get(name, 0.0) + dur / 1e6
    return dict(sorted(seconds.items(), key=lambda kv: -kv[1]))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("trace", type=Path, help="the traced run's Chrome trace (.json[.gz])")
    parser.add_argument("--out", type=Path, help="also write the JSON object here")
    args = parser.parse_args(argv)
    res = {"trace": str(args.trace), "attention_kernels_s": attention_kernels(args.trace)}
    res["ffma_gemm_s"] = sum(s for name, s in res["attention_kernels_s"].items()
                             if "f32f32" in name or "sgemm" in name.lower())
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(res, indent=1))
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
