"""Serving launcher: batched, capability-authenticated decoding (PyTorch
port of ``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-4b --smoke \
      --requests 12 [--slots 4] [--max-tokens 8] [--reject-rate 0.25] [--device cpu]

Runs on the GPU unless ``--device cpu`` is given, and raises without one.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE
from repro_torch.configs import arch_names, get_arch
from repro_torch.core.auth import CapabilityAuthority, Rights
from repro_torch.models import decode_step, init_cache, init_params
from repro_torch.runtime.serve_loop import Request, ServeLoop


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=arch_names())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-tokens", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--reject-rate", type=float, default=0.25,
                    help="fraction of requests given bad capabilities")
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)

    arch = get_arch(args.arch)
    cfg = arch.smoke if args.smoke else arch.model
    if cfg.family == "encdec":
        print("NOTE: enc-dec serving demo decodes against an empty encoder")
    print(f"arch={cfg.name} family={cfg.family} slots={args.slots}")

    params = init_params(cfg, seed=0, device=args.device)
    authority = CapabilityAuthority(b"serving-key-0123")

    def make_cache():
        cache = init_cache(cfg, args.slots, args.max_len, device=args.device)
        if cfg.family == "encdec":
            cache["enc_len"].fill_(1)
        return cache

    def step(p, c, b):
        with torch.no_grad():
            return decode_step(p, cfg, c, b)

    loop = ServeLoop(step, params, make_cache, args.slots, authority, eos_id=-1)

    now = int(time.time())
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(args.requests):
        bad = rng.random() < args.reject_rate
        cap = authority.issue(
            client_id=i, object_id=0, offset=0, length=1 << 20,
            rights=int(Rights.WRITE if bad else Rights.READ),
            expiry=now + 3600,
        )
        prompt = rng.integers(1, cfg.vocab, rng.integers(1, 6)).tolist()
        reqs.append(Request(i, prompt, args.max_tokens, cap))

    t0 = time.time()
    done = loop.run(reqs)
    dt = time.time() - t0
    served = [r for r in done if not r.rejected]
    rejected = [r for r in done if r.rejected]
    toks = sum(len(r.out) for r in served)
    print(f"served {len(served)} requests ({toks} tokens) in {dt:.1f}s "
          f"over {loop.steps} batched decode steps; "
          f"rejected {len(rejected)} bad tickets")
    assert all(len(r.out) == args.max_tokens for r in served)


if __name__ == "__main__":
    main()
