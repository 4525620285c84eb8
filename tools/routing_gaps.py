#!/usr/bin/env python3
"""MoE router gaps at the published widths: where the flash kernel and
blockwise attention route a token apart, left free to.

    python3 tools/routing_gaps.py [--seeds 0 1 2 3] [--device cuda]

For ``chip_smoke.py``'s MoE models (deepseek-v2-lite-16b: its dense first
layer and one MoE layer; dbrx-132b: one layer; ``DEPTH_CUTS``) and each
seed: seeded params and a B=1 prefill of ``CUT_SEQ`` seeded tokens through
``forward``, once with the flash kernel and once with
``blockwise_attention`` in its place, as phase 6 runs the two but with
each prefill routing on its own (phase 6 pins the second's routing to the
first's, ``pinned_routing``).  For each MoE layer, every token's router
gap (the k-th minus the (k+1)-th probability) and whether the two prefills
routed it to other experts (a flip).  In these cuts the MoE layer follows
attention alone, so every flip comes from attention's rounding.  Prints,
per model and seed: the flips and the largest gap among them, the gaps' low
quantiles, the median k-th probability, and the share of tokens whose gap
lies under each of a few limits: the share a limit on the gap would let
flip unnoticed.  Prints the card's name and power limit and, last, one JSON
object with every reading.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402

ARCHS = ("deepseek-v2-lite-16b", "dbrx-132b")
LIMITS = (1e-4, 3e-4, 1e-3, 2e-3, 5e-3)
QUANTILES = (0.001, 0.01, 0.05, 0.5)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()

    import torch

    from repro_torch.kernels import _build
    from repro_torch.models import forward, init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(args.device)
    if dev.type == "cuda":
        print(chip_smoke.card_line(), flush=True)
        _build.build()
    configs = chip_smoke.model_configs()
    readings = []
    with torch.no_grad():
        for name in ARCHS:
            cfg = configs[name]
            for seed in args.seeds:
                params = init_params(cfg, seed=seed, device=dev)
                batch = chip_smoke.model_batch(cfg, dev, np.random.default_rng(seed), 1,
                                               chip_smoke.CUT_SEQ)
                ours, theirs = [], []
                with chip_smoke.recording(ours):
                    forward(params, cfg, batch)
                with chip_smoke.attention_entry(chip_smoke.blockwise_entry(cfg.attn_block)), \
                        chip_smoke.recording(theirs):
                    forward(params, cfg, batch)
                for layer, (a, b) in enumerate(zip(ours, theirs)):
                    (p, x, n_experts, top_k), factor = a[0][:4], a[1]["capacity_factor"]
                    probs, chosen, _ = chip_smoke.routing(p, x, n_experts, top_k, factor)
                    other = chip_smoke.routing(*b[0][:4], factor)[1]
                    top_p = torch.topk(probs, top_k + 1, dim=-1).values
                    gap = top_p[:, top_k - 1] - top_p[:, top_k]
                    flipped = (chosen.sort(dim=-1).values != other.sort(dim=-1).values).any(-1)
                    gaps = gap.double().cpu().numpy()
                    row = {
                        "arch": name, "seed": seed, "moe_layer": layer, "tokens": gaps.size,
                        "flips": int(flipped.sum()),
                        "largest_flip_gap": float(gap[flipped].max()) if flipped.any() else None,
                        "flip_gaps": sorted(gap[flipped].tolist()),
                        "gap_quantiles": dict(zip(map(str, QUANTILES),
                                                  np.quantile(gaps, QUANTILES).tolist())),
                        "median_kth_prob": float(top_p[:, top_k - 1].median()),
                        "share_under": {str(lim): float((gaps < lim).mean()) for lim in LIMITS},
                    }
                    print(json.dumps(row), flush=True)
                    readings.append(row)
                del params, batch, ours, theirs
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
    print(json.dumps({"readings": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
