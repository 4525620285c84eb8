"""Why a DeepSeek-V2 training cell's routing is as uneven as it reads: the
program's forward on the cell's seeded weights, with each layer's parts
measured as they run.

    python3 h100bench/routing_load.py --workload dsv2lite-train4k --seeds <n> ...

For each seed, one forward without gradients on the cell's first batch
(Zipf-drawn token ids), again on ids drawn uniformly over the vocabulary,
and again on the Zipf ids with the embedding table scaled to an RMS of 1
(the seeded table's is 0.02), at the cell's shapes.  Per part, in the
order they run:

* ``embed``, ``attn``, ``mlp``: the part's output, its RMS over every
  element, and its shared share, ``|mean_t x_t|^2 / mean_t |x_t|^2`` over
  the T = B * S tokens (1: every token the same vector; about 1 / T for
  independent ones);
* ``route``: the router's input (the normed residual) and its shared
  share; the logits' spread over experts, averaged over tokens, beside the
  spread of the logits' mean over tokens (what every token shares); the
  busiest expert's choices over the mean; and that load again with the
  router's input less its mean over tokens.

Prints the card's name and power limit, then one JSON line a seed and
draw.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import harness as h  # noqa: E402

h.set_environment()


def shared_share(x) -> float:
    """``|mean_t x_t|^2 / mean_t |x_t|^2`` over the rows of ``x`` (T, d)."""
    x = x.float()
    return float(x.mean(0).square().sum() / x.square().sum(1).mean())


def load_max(ids, n_experts: int) -> float:
    """The busiest expert's choices over the mean."""
    import torch

    counts = torch.bincount(ids.reshape(-1), minlength=n_experts)
    return float(counts.max()) * n_experts / ids.numel()


def probe(params, cfg, tokens) -> list[dict]:
    """One forward of the program on ``tokens`` (B, S) with every part
    measured; the parts put back after."""
    import torch

    from repro_torch.models import attention, model, moe
    from repro_torch.models import transformer as tf

    rows: list[dict] = []
    kept = {(model, "embed_apply"): model.embed_apply,
            (attention, "mla_apply"): attention.mla_apply,
            (tf, "_mlp_apply"): tf._mlp_apply, (moe, "route"): moe.route}

    def measured(name, fn):
        def run(*args, **kwargs):
            out = fn(*args, **kwargs)
            flat = out.reshape(-1, out.shape[-1])
            rows.append({"part": name, "rms": float(flat.float().square().mean().sqrt()),
                         "shared": shared_share(flat)})
            return out
        return run

    def route(router, xf, top_k, *args, **kwargs):
        out = kept[(moe, "route")](router, xf, top_k, *args, **kwargs)
        logits = xf.float() @ router["w"].float()
        centred = (xf.float() - xf.float().mean(0)) @ router["w"].float()
        n_experts = logits.shape[-1]
        rows.append({"part": "route", "shared": shared_share(xf),
                     "logit_spread": float(logits.std(-1).mean()),
                     "common_logit_spread": float(logits.mean(0).std()),
                     "load_max": load_max(out[1], n_experts),
                     "load_max_centred": load_max(torch.topk(centred, top_k, -1).indices,
                                                  n_experts)})
        return out

    model.embed_apply = measured("embed", model.embed_apply)
    attention.mla_apply = measured("attn", attention.mla_apply)
    tf._mlp_apply = measured("mlp", tf._mlp_apply)
    moe.route = route
    try:
        with torch.no_grad():
            model.forward(params, cfg, {"tokens": tokens})
    finally:
        for (module, name), fn in kept.items():
            setattr(module, name, fn)
    return rows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    spec = h.load_spec()
    entry = h.cell_of(spec, args.workload)
    config, mix = h.config_of(spec, entry["config"]), h.mix_of(entry["traffic"])
    h.port_path()
    import numpy as np
    import torch

    from repro_torch.configs.base import ArchConfig
    from repro_torch.launch import steps

    dev = torch.device(args.device)
    kind = h.kind_of(mix)
    if dev.type == "cuda":
        print(json.dumps({"card": h.power_line()}), flush=True)
    for seed in args.seeds:
        cell = kind.Cell(h, config, mix, seed, dev)
        cfg = kind.model_config(config, remat=False)
        struct = steps.params_struct(ArchConfig(model=cfg, smoke=cfg))
        params = h.build_tree(struct, lambda index, path, leaf: cell.weight(
            index, path, tuple(leaf.shape)))
        zipf = cell.rows(0)[0]
        uniform = torch.from_numpy(np.random.default_rng(seed).integers(
            0, config["vocab_size"], zipf.shape, dtype=np.int64)).to(dev)
        for draw, tokens in (("zipf", zipf), ("uniform", uniform)):
            print(json.dumps({"seed": seed, "ids": draw, "parts": probe(params, cfg, tokens)}),
                  flush=True)
        table = params["embed"]["table"]
        params["embed"]["table"] = table / table.square().mean().sqrt()
        print(json.dumps({"seed": seed, "ids": "zipf, embedding RMS 1",
                          "parts": probe(params, cfg, zipf)}), flush=True)
        del params
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
