"""AdamW with decoupled weight decay and global-norm clipping (PyTorch port
of ``repro.optim.adamw``).

The optimizer state ``{"m", "v", "step"}`` holds fp32 moment trees shaped
like the params and an int32 0-d step, all on the params' device.  The
update follows the reference's arithmetic, quirks included: weight decay
applies to every leaf with ``ndim >= 2`` (so the *stacked* norm scales,
(L, d), decay while an unstacked one does not), and the clip factor is
``min(1, grad_clip / max(norm, 1e-9))``.  ``torch.optim.AdamW`` is not
used: its decay multiplies ``p`` before the step and rounds elsewhere.
Leaves under the keys of ``models.layers.BUFFERS`` (a router's correction
bias) take no step and count in no norm: the update reads the trees
through ``trainable``, so the gradients may come with or without them.

Unlike the reference, which returns new trees, :func:`adamw_update`
writes params, ``m`` and ``v`` in place and returns the same trees: the
training state of a large model is then held once on the card, not twice.
A checkpoint taken before the update keeps its own copy
(``CheckpointManager.save`` snapshots on the caller's thread).

The norm and the per-leaf update run in ``kernels.adamw``: on CUDA leaves
a fused kernel pair (one read of the gradients for the norm, one pass over
g, p, m and v for the update), elsewhere the plain loop of PyTorch
operations.  The 0-d scalars of the step (clip factor, bias corrections,
learning rate) are computed here once, on the leaves' device, for either
route; given the same norm the two routes give the same bits.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.kernels import adamw as kadamw
from repro_torch.models.layers import trainable, tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def init_opt_state(params: Any) -> dict:
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    return {
        "m": zeros,
        "v": tree_map(torch.zeros_like, zeros),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree: Any) -> torch.Tensor:
    """The L2 norm over every leaf, in fp32: ``kernels.adamw.grad_norm`` of
    the tree's leaves (the sum of squares in fp64, by the fused kernel on
    the card)."""
    return kadamw.grad_norm(tree_leaves(tree))


@torch.no_grad()
def adamw_update(
    params: Any,
    grads: Any,
    opt_state: dict,
    cfg: AdamWConfig,
    lr_scale: torch.Tensor | float = 1.0,
    grad_norm: torch.Tensor | None = None,
) -> tuple[Any, dict, dict]:
    """Returns (params, opt_state, metrics); params, ``m`` and ``v`` are
    updated in place, ``step`` is a new 0-d tensor, and metrics hold the
    0-d ``grad_norm`` and ``lr``.  A sharded step passes the local shards
    and the whole tree's ``grad_norm``, which the shards alone do not give."""
    step = opt_state["step"] + 1
    grads = trainable(grads)
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    clip = torch.clamp(cfg.grad_clip / torch.clamp_min(gnorm, 1e-9), max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(b1, stepf)
    bc2 = 1.0 - torch.pow(b2, stepf)
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32, device=gnorm.device)

    kadamw.adamw_step(*(tree_leaves(trainable(t)) for t in
                        (params, grads, opt_state["m"], opt_state["v"])),
                      clip, bc1, bc2, lr, b1, b2, cfg.eps, cfg.weight_decay)
    return params, {"m": opt_state["m"], "v": opt_state["v"], "step": step}, \
        {"grad_norm": gnorm, "lr": lr}
