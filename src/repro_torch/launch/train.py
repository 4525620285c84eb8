"""Training launcher: ``--arch`` selects any assigned architecture (PyTorch
port of ``repro.launch.train``).

``--smoke`` scales the model down to its same-family smoke config, so every
arch trains end to end with the full runtime — deterministic pipeline,
async EC checkpoints, straggler monitor, simulated failure/restore.

  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b --smoke \\
      --steps 30 [--fail-at 20] [--policy ec|replicate] [--device cpu]

Runs on the GPU unless ``--device cpu`` is given, and raises without one.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE
from repro_torch.checkpoint.manager import CheckpointManager, CheckpointPolicy
from repro_torch.checkpoint.storage import StorageCluster
from repro_torch.configs import arch_names, get_arch
from repro_torch.core.packets import ReplStrategy, Resiliency
from repro_torch.data.pipeline import DataPipeline, PipelineConfig, SyntheticSource
from repro_torch.launch.steps import loss_and_grads
from repro_torch.models import init_params
from repro_torch.models.layers import tree_leaves
from repro_torch.optim.adamw import AdamWConfig, adamw_update, init_opt_state
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.runtime.train_loop import Trainer, TrainLoopConfig


def make_batch_extras(cfg, batch: dict) -> dict:
    """``batch`` with a frontend's stub inputs added, ones in bf16 on the
    tokens' device: whisper's frames (one a token) or llava's patch
    embeddings."""
    tokens = batch["tokens"]
    if cfg.family == "encdec":
        batch["frames"] = torch.ones((tokens.shape[0], tokens.shape[1], cfg.d_model),
                                     dtype=torch.bfloat16, device=tokens.device)
    if cfg.frontend == "vision_stub":
        batch["patch_embeds"] = torch.ones((tokens.shape[0], cfg.frontend_tokens, cfg.d_model),
                                           dtype=torch.bfloat16, device=tokens.device)
    return batch


def main(argv: list[str] | None = None) -> Trainer:
    """Runs the launcher and returns its trainer (``history``, ``restarts``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=arch_names())
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config (CPU-scale)")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--policy", choices=["ec", "replicate"], default="ec")
    ap.add_argument("--checkpoint-every", type=int, default=10)
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)

    arch = get_arch(args.arch)
    cfg = arch.smoke if args.smoke else arch.model
    print(f"arch={cfg.name} family={cfg.family} "
          f"params={cfg.param_count() / 1e6:.1f}M")

    params = init_params(cfg, seed=0, device=args.device)
    dev = tree_leaves(params)[0].device
    opt = init_opt_state(params)
    adam = AdamWConfig(lr=args.lr)

    def step_fn(p, o, batch):
        batch = make_batch_extras(cfg, dict(batch))
        loss, grads = loss_and_grads(p, cfg, batch)
        lr_scale = warmup_cosine(o["step"], warmup=max(args.steps // 5, 1),
                                 total=args.steps)
        p2, o2, m = adamw_update(p, grads, o, adam, lr_scale)
        m["loss"] = loss
        return p2, o2, m

    pipe = DataPipeline(SyntheticSource(cfg.vocab, seed=0),
                        PipelineConfig(batch=args.batch, seq=args.seq), device=dev)
    cluster = StorageCluster(num_nodes=8, node_capacity=1 << 28, device=dev)
    policy = (
        CheckpointPolicy(k=4, m=2)
        if args.policy == "ec"
        else CheckpointPolicy(resiliency=Resiliency.REPLICATION, k=3,
                              strategy=ReplStrategy.PBT)
    )
    mgr = CheckpointManager(cluster, policy)
    trainer = Trainer(
        step_fn, params, opt, pipe, mgr,
        TrainLoopConfig(total_steps=args.steps,
                        checkpoint_every=args.checkpoint_every),
    )

    fired = {"done": False}

    def inject(step, tr):
        if args.fail_at is not None and step == args.fail_at and not fired["done"]:
            fired["done"] = True
            cluster.fail_node(2)
            print(f"!! injected failure at step {step}; restoring")
            return True
        return False

    t0 = time.time()
    try:
        hist = trainer.run(inject_failure=inject)
    finally:
        pipe.close()
    losses = [h["loss"] for h in hist]
    print(f"ran {len(hist)} steps in {time.time() - t0:.1f}s "
          f"(restarts={trainer.restarts})")
    print(f"loss {np.mean(losses[:3]):.4f} -> {np.mean(losses[-3:]):.4f}")
    print(f"storage: {cluster.stats()}")
    return trainer


if __name__ == "__main__":
    main()
