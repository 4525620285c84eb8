"""Gradient compression with error feedback for cross-pod reduction
(PyTorch port of ``repro.optim.compression``).

int8 quantization with per-tensor scales cuts the traffic of a gradient
all-reduce 4x (fp32) / 2x (bf16); error feedback (Seide et al.; EF-SGD)
accumulates the quantization residual locally and re-injects it next step.

Usage in a train step::

    comp_grads, new_err = compress_with_feedback(grads, err)
    # ... all-reduce comp_grads.q (int8) + use decompress(...) ...

``torch.round`` rounds half to even, as ``jnp.round`` does, so the int8
bytes equal the reference's on the same inputs.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models.layers import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass
class Compressed:
    q: Any          # int8 tree
    scale: Any      # fp32 per-tensor scales (0-d)


def init_error_state(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


def _quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    xf = x.float()
    scale = torch.clamp_min(xf.abs().max(), 1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_with_feedback(grads: Any, err: Any) -> tuple[Compressed, Any]:
    """Returns (compressed grads, new error state)."""
    corrected = [g.float() + e for g, e in
                 zip(tree_leaves(grads), tree_leaves(err), strict=True)]
    qs = [_quantize(c) for c in corrected]
    new_err = [c - q.float() * scale for c, (q, scale) in zip(corrected, qs)]
    return (Compressed(tree_unflatten(grads, [q for q, _ in qs]),
                       tree_unflatten(grads, [scale for _, scale in qs])),
            tree_unflatten(grads, new_err))


def decompress(comp: Compressed) -> Any:
    scales = iter(tree_leaves(comp.scale))
    return tree_map(lambda q: q.float() * next(scales), comp.q)


def compression_ratio(grads: Any) -> float:
    """Bytes saved on the wire: fp32 -> int8 + one fp32 scalar/tensor."""
    leaves = tree_leaves(grads)
    orig = sum(x.numel() * 4 for x in leaves)
    comp = sum(x.numel() + 4 for x in leaves)
    return orig / comp
