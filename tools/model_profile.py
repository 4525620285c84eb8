#!/usr/bin/env python3
"""Where yi-9b's serving time goes on one card: a torch.profiler trace.

    python3 tools/model_profile.py [--out-dir build/profiles]

Builds the kernels and makes ``chip_smoke.py``'s phase-6 main model (yi-9b
at its published size, seeded fp32 master weights, 35 GB), then traces one
B=1, S=4096 prefill (``forward`` and the last row's logits) and four B=4
decode steps (``decode_step`` over a cache of 128 rows), each after an
untraced warm-up, under ``torch.profiler`` (CPU and CUDA activities).  For
each it prints the wall time, the device's busy and idle shares and the
device time of the kernels that take the most, as
``tools/checkpoint_profile.py`` does, and the device time in three groups:
the flash kernel, the matrix products (cuBLAS/CUTLASS kernels) and
everything else.  Writes the Chrome traces to
``OUT_DIR/model_<step>_trace.json.gz``.  Prints the card's name and power
limit and, last, one JSON object with every number.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke  # noqa: E402
from checkpoint_profile import profiled  # noqa: E402

DECODE_STEPS = 4


def group(name: str) -> str:
    """The flash kernel, the matrix products (cuBLAS/CUTLASS) or the rest."""
    low = name.lower()
    if "flash_fwd" in low:
        return "flash"
    if any(k in low for k in ("gemm", "gemv", "nvjet", "cutlass", "xmma", "splitkreduce")):
        return "matmul"
    return "other"


def main() -> int:
    import numpy as np
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out-dir", default=str(ROOT / "build" / "profiles"))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("model_profile: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build
    from repro_torch.models import decode_step, forward, init_cache, init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda")
    card = chip_smoke.card_line()
    print(f"card: {card}", flush=True)
    _build.build()
    cfg = get_arch(chip_smoke.MAIN_ARCH).model
    rng = np.random.default_rng(chip_smoke.MODEL_SEED)
    res = {}
    with torch.no_grad():
        params = init_params(cfg, seed=chip_smoke.MODEL_SEED, device=dev)
        batch = chip_smoke.model_batch(cfg, dev, rng, chip_smoke.PREFILL_BATCH,
                                       chip_smoke.PREFILL_SEQ)

        def prefill():
            hidden = forward(params, cfg, batch)
            return chip_smoke.unembed(params, hidden[:, -1:])

        prefill()
        res["prefill"] = profiled("prefill", prefill, out_dir, prefix="model", top_n=12,
                                  group=group)
        b = chip_smoke.DECODE_BATCH
        cache = init_cache(cfg, b, chip_smoke.DECODE_MAX_LEN, device=dev)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (b, 1))).to(dev)
        for t in range(8):
            decode_step(params, cfg, cache, {"tokens": tokens, "cur_len": t})

        def decode():
            for t in range(8, 8 + DECODE_STEPS):
                decode_step(params, cfg, cache, {"tokens": tokens, "cur_len": t})

        res["decode"] = profiled("decode", decode, out_dir, prefix="model", top_n=12,
                                 group=group)
        res["decode"]["steps"] = DECODE_STEPS
    for name, step in res.items():
        print(f"  {name} device ms by group: {step['device_ms_by_group']}", flush=True)
    chip_smoke.check(all(r["device_events"] for r in res.values()),
                     "a step's trace holds no device activity")
    print(card)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
