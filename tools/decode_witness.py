#!/usr/bin/env python3
"""Decode against forward for the recurrent models at their published widths.

    python3 tools/decode_witness.py reference [--seeds 0 1 2] [--save DIR]
    python3 tools/decode_witness.py port [--seeds 0 1 2] [--device cuda] [--load DIR]

For each of ``chip_smoke.py``'s recurrent models (xlstm-125m whole,
zamba2-2.7b cut to one group: ``DEPTH_CUTS``) and each seed: seeded params,
a B=1 prefill of ``CUT_SEQ`` seeded tokens through ``forward`` and the bf16
logits of its first ``CUT_DECODE_STEPS`` rows, then those tokens one a step
through ``decode_step`` from an empty cache; the decode logits against the
forward rows, as phase 6 holds them.

``reference`` runs the JAX package (``repro``) on the CPU; with ``--save``
it writes each seed's params, tokens and logits to ``DIR``.  ``port`` runs
``repro_torch`` (on the card unless ``--device cpu``), once in bf16 as
served and once with every product in fp32 (``chip_smoke.fp32_compute``);
with ``--load`` it takes the reference's saved params and tokens in place
of its own and also holds its forward rows and decode logits against the
reference's.  Each side imports only its own package.

Every comparison prints the largest share of phase 6's ``WHOLE_MODEL``
allowance (2^-7 |want| + 0.3 of the row's RMS) that an element uses and the
relative RMS error; the last line is one JSON object with every reading.
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

ARCHS = ("xlstm-125m", "zamba2-2.7b")


def closeness(got, want) -> dict:
    """Share of ``WHOLE_MODEL``'s allowance and relative RMS error, in numpy."""
    tol = chip_smoke.WHOLE_MODEL
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    diff = np.abs(got - want)
    allowed = tol["rtol"] * np.abs(want) + tol["row_atol"] * np.sqrt(
        np.square(want).mean(axis=-1, keepdims=True))
    share = float(np.where(diff == 0, 0.0, diff / allowed).max())
    return {"tolerance_share": share, "rel_rms_err": float(np.linalg.norm(diff) /
                                                          np.linalg.norm(want))}


def cut(cfg):
    import dataclasses

    layers = chip_smoke.DEPTH_CUTS[cfg.name]
    return cfg if layers is None else dataclasses.replace(cfg, n_layers=layers)


def path_of(keys) -> str:
    return "/".join(str(k) for k in keys)


def reference(seeds, save: Path | None) -> list[dict]:
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro import models
    from repro.configs import ARCHS as REGISTRY

    out = []
    steps = chip_smoke.CUT_DECODE_STEPS
    for name in ARCHS:
        cfg = dataclasses.replace(cut(REGISTRY[name].model), remat=False)
        init = jax.jit(lambda k: models.init_params(cfg, k))
        fwd = jax.jit(lambda p, t: models.forward(p, cfg, {"tokens": t}))
        step = jax.jit(lambda p, c, t, n: models.decode_step(p, cfg, c, {"tokens": t,
                                                                          "cur_len": n}))
        for seed in seeds:
            params = init(jax.random.PRNGKey(seed))
            tokens = np.random.default_rng(seed).integers(0, cfg.vocab, (1, chip_smoke.CUT_SEQ))
            hidden = fwd(params, jnp.asarray(tokens, jnp.int32))
            w = params["unembed"]["w"].astype(jnp.bfloat16)
            rows = np.asarray((hidden[:, :steps].astype(jnp.bfloat16) @ w).astype(jnp.float32))
            cache, logits = models.init_cache(cfg, 1, steps), []
            for t in range(steps):
                lg, cache = step(params, cache, jnp.asarray(tokens[:, t:t + 1], jnp.int32),
                                 jnp.int32(t))
                logits.append(np.asarray(lg[:, 0]))
            dec = np.stack(logits, axis=1)
            row = {"side": "reference", "arch": name, "seed": seed,
                   "bf16": closeness(dec, rows)}
            print(json.dumps(row), flush=True)
            out.append(row)
            if save is not None:
                save.mkdir(parents=True, exist_ok=True)
                leaves = jax.tree_util.tree_flatten_with_path(jax.device_get(params))[0]
                np.savez(save / f"{name}-{seed}.npz", tokens=tokens, rows=rows, dec=dec,
                         **{"p/" + path_of(getattr(k, "key", getattr(k, "idx", None))
                                           for k in keys): np.asarray(leaf, np.float32)
                            for keys, leaf in leaves})
    return out


def port(seeds, device: str, load: Path | None) -> list[dict]:
    import torch

    from repro_torch.configs import ARCHS as REGISTRY
    from repro_torch.models import decode_step, forward, init_cache, init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    if device == "cuda":
        from repro_torch.kernels import _build

        _build.build()
    dev = torch.device(device)
    steps = chip_smoke.CUT_DECODE_STEPS
    out = []

    def walk(tree, keys=()):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        for key, value in items:
            if isinstance(value, (dict, list, tuple)):
                yield from walk(value, keys + (key,))
            else:
                yield keys + (key,), tree, key

    def run(params, cfg, tokens):
        rows = chip_smoke.unembed(params, forward(params, cfg, {"tokens": tokens})[:, :steps])
        cache, logits = init_cache(cfg, 1, steps, device=dev), []
        for t in range(steps):
            lg, cache = decode_step(params, cfg, cache, {"tokens": tokens[:, t:t + 1],
                                                         "cur_len": t})
            logits.append(lg[:, 0])
        return rows.cpu().numpy(), torch.stack(logits, dim=1).cpu().numpy()

    for name in ARCHS:
        cfg = cut(REGISTRY[name].model)
        for seed in seeds:
            params = init_params(cfg, seed=seed, device=dev)
            tokens = np.random.default_rng(seed).integers(0, cfg.vocab, (1, chip_smoke.CUT_SEQ))
            saved = None
            if load is not None:
                saved = np.load(load / f"{name}-{seed}.npz")
                tokens = saved["tokens"]
                for keys, parent, key in list(walk(params)):
                    parent[key] = torch.from_numpy(saved["p/" + path_of(keys)]).to(dev)
            tokens = torch.from_numpy(tokens).to(dev)
            row = {"side": "port", "device": device, "arch": name, "seed": seed}
            with torch.no_grad():
                rows, dec = run(params, cfg, tokens)
                row["bf16"] = closeness(dec, rows)
                if saved is not None:
                    row["forward_vs_reference"] = closeness(rows, saved["rows"])
                    row["decode_vs_reference"] = closeness(dec, saved["dec"])
                with chip_smoke.fp32_compute():
                    rows32, dec32 = run(params, cfg, tokens)
                row["fp32"] = closeness(dec32, rows32)
                if saved is not None:
                    row["fp32_forward_vs_reference"] = closeness(rows32, saved["rows"])
            print(json.dumps(row), flush=True)
            out.append(row)
            del params
            if device == "cuda":
                torch.cuda.empty_cache()
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("side", choices=("reference", "port"))
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--save", type=Path)
    parser.add_argument("--load", type=Path)
    args = parser.parse_args()
    if args.side == "reference":
        rows = reference(args.seeds, args.save)
    else:
        if args.device == "cuda":
            print(chip_smoke.card_line(), flush=True)
        rows = port(args.seeds, args.device, args.load)
    print(json.dumps({"readings": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
