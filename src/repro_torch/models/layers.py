"""Shared model building blocks (PyTorch port of ``repro.models.layers``).

Conventions, as in the reference:
  * every layer is (init(gen, ...) -> params, apply(params, x, ...) -> y);
  * params are nested dicts of tensors, with the reference's names and
    layouts (a dense ``w`` is (d_in, d_out)), so a ``repro`` params tree
    carries across through :mod:`repro_torch.models.convert`;
  * compute dtype is bf16 by default with fp32 accumulation for norms,
    softmax and the loss; master weights are fp32 (cast at use).

Every ``*_init`` that draws numbers takes an explicit ``torch.Generator``
and puts its tensors on that generator's device; the draws differ from
``jax.random``'s, so tests carry the reference's params across instead.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch import DEFAULT_DEVICE
from repro_torch.kernels.ops import resolve_device

Params = dict[str, Any]


def tree_map(fn, tree: Any) -> Any:
    """``fn`` on every leaf of a nest of dicts, lists and tuples, which keep
    their type; lists and tuples keep their order, and dicts are walked, and
    rebuilt, in sorted key order (as ``jax.tree_util`` does), so two trees
    with the same keys give their leaves in the same order."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, tree[key]) for key in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, value) for value in tree)
    return fn(tree)


def tree_leaves(tree: Any) -> list:
    """The leaves of ``tree`` in :func:`tree_map`'s order."""
    found: list = []
    tree_map(found.append, tree)
    return found


#: leaves (by key) that training holds fixed: no gradient, no AdamW step,
#: weight decay included (a MoE router's correction bias)
BUFFERS = ("score_bias",)


def trainable(tree: Any) -> Any:
    """``tree`` without the :data:`BUFFERS`: the same leaves, in the same
    order, less those."""
    if isinstance(tree, dict):
        return {k: trainable(v) for k, v in tree.items() if k not in BUFFERS}
    if isinstance(tree, (list, tuple)):
        return type(tree)(trainable(v) for v in tree)
    return tree


def tree_unflatten(template: Any, leaves) -> Any:
    """``template``'s nest with its leaves replaced, in order, by ``leaves``."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def _init_dense(gen: torch.Generator, d_in: int, d_out: int, scale=None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32, device=gen.device)
    return w * scale


def dense_init(gen: torch.Generator, d_in: int, d_out: int, bias: bool = False,
               scale=None) -> Params:
    p = {"w": _init_dense(gen, d_in, d_out, scale)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=torch.float32, device=gen.device)
    return p


def dense_apply(p: Params, x: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    y = x.to(dtype) @ p["w"].to(dtype)
    if "b" in p:
        y = y + p["b"].to(dtype)
    return y


def rmsnorm_init(d: int, device: str | torch.device = DEFAULT_DEVICE) -> Params:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=resolve_device(device))}


def rmsnorm_apply(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * p["scale"]
    return y.to(x.dtype)


def layernorm_init(d: int, device: str | torch.device = DEFAULT_DEVICE) -> Params:
    dev = resolve_device(device)
    return {"scale": torch.ones((d,), dtype=torch.float32, device=dev),
            "bias": torch.zeros((d,), dtype=torch.float32, device=dev)}


def layernorm_apply(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return y.to(x.dtype)


def swiglu_init(gen: torch.Generator, d: int, d_ff: int) -> Params:
    return {
        "gate": dense_init(gen, d, d_ff),
        "up": dense_init(gen, d, d_ff),
        "down": dense_init(gen, d_ff, d, scale=1.0 / math.sqrt(d_ff)),
    }


def swiglu_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    g = dense_apply(p["gate"], x)
    u = dense_apply(p["up"], x)
    return dense_apply(p["down"], F.silu(g) * u)


def relu2_mlp_init(gen: torch.Generator, d: int, d_ff: int) -> Params:
    return {
        "up": dense_init(gen, d, d_ff),
        "down": dense_init(gen, d_ff, d, scale=1.0 / math.sqrt(d_ff)),
    }


def relu2_mlp_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    """down(relu(up(x))^2), the square taken in fp32 and rounded once."""
    u = dense_apply(p["up"], x)
    return dense_apply(p["down"], F.relu(u.float()).square().to(u.dtype))


def gelu_mlp_init(gen: torch.Generator, d: int, d_ff: int) -> Params:
    return {
        "up": dense_init(gen, d, d_ff, bias=True),
        "down": dense_init(gen, d_ff, d, bias=True, scale=1.0 / math.sqrt(d_ff)),
    }


def gelu_mlp_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return dense_apply(p["down"], F.gelu(dense_apply(p["up"], x), approximate="tanh"))


def embed_init(gen: torch.Generator, vocab: int, d: int) -> Params:
    table = torch.randn((vocab, d), generator=gen, dtype=torch.float32, device=gen.device)
    return {"table": table * 0.02}


def embed_apply(p: Params, tokens: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """The table's rows for ``tokens``, cast to ``dtype`` after the gather:
    the same values as gathering from the cast table, but the backward sums
    a repeated token's gradients into the table in its own dtype (fp32),
    not in ``dtype``."""
    return p["table"][tokens.long()].to(dtype)


# -- rotary position embeddings ---------------------------------------------


@dataclasses.dataclass(frozen=True)
class Yarn:
    """YaRN (arXiv:2309.00071) as DeepSeek-V2 sets it: a config's
    ``rope_scaling`` group of type ``yarn`` whose ``mscale`` equals its
    ``mscale_all_dim`` (as published), so that cos and sin keep their scale.

    The rotary frequencies of the pairs below the correction range (fast
    rotations, more than ``beta_fast`` turns over the original context)
    are kept, those from its end on (fewer than ``beta_slow`` turns) are
    divided by ``factor``, and a linear ramp blends the pairs between.  The
    softmax scale gains ``attention_scale()``, mscale(factor,
    mscale_all_dim) squared."""

    factor: float
    original_max_position: int
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale_all_dim: float = 0.0

    def correction_range(self, dim: int, theta: float) -> tuple[int, int]:
        """The first and last pair index of the ramp, ``yarn_find_correction_range``."""

        def pair_at(rotations: float) -> float:
            turns = self.original_max_position / (rotations * 2 * math.pi)
            return dim * math.log(turns) / (2 * math.log(theta))

        low = math.floor(pair_at(self.beta_fast))
        high = math.ceil(pair_at(self.beta_slow))
        return max(low, 0), min(high, dim - 1)

    def attention_scale(self) -> float:
        """``yarn_get_mscale(factor, mscale_all_dim)`` squared."""
        if self.factor <= 1:
            return 1.0
        return (0.1 * self.mscale_all_dim * math.log(self.factor) + 1.0) ** 2


def rope_freqs(head_dim: int, theta: float = 1e4,
               device: str | torch.device = DEFAULT_DEVICE,
               yarn: Yarn | None = None) -> torch.Tensor:
    dev = resolve_device(device)
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=dev) / head_dim
    if yarn is None:
        return 1.0 / (theta ** exponent)
    extra = 1.0 / (theta ** exponent)
    inter = 1.0 / (yarn.factor * theta ** exponent)
    low, high = yarn.correction_range(head_dim, theta)
    ramp = (torch.arange(head_dim // 2, dtype=torch.float32, device=dev) - low) / (
        max(high - low, 0.001))
    keep = 1.0 - torch.clamp(ramp, 0, 1)      # 1 below the range, 0 above it
    return inter * (1 - keep) + extra * keep


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4,
               yarn: Yarn | None = None) -> torch.Tensor:
    """x: (..., S, H, D) with D even; positions: broadcastable to (..., S).

    Angles, cos and sin in fp32 whatever ``x``'s dtype; the rotation is
    computed in fp32 (bf16 x fp32 promotes, as in JAX) and cast back.
    ``yarn`` takes YaRN's frequencies (:class:`Yarn`).
    """
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device, yarn)                         # (D/2,)
    angles = positions[..., :, None, None].to(torch.float32) * freqs     # (..,S,1,D/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    xr1 = x1 * cos - x2 * sin
    xr2 = x2 * cos + x1 * sin
    out = torch.stack([xr1, xr2], dim=-1).reshape(x.shape)
    return out.to(x.dtype)


class _CastPerUse(torch.autograd.Function):
    """``cast`` (``master`` already cast) as a view, whose backward hands
    ``master`` this use's gradient in ``master``'s dtype: where each use of
    one cast goes through its own view, the uses' gradients are summed in
    the master's dtype, as if each use cast it anew, with one copy of the
    cast in memory (a bf16 yi-9b unembedding is 0.5 GB)."""

    @staticmethod
    def forward(ctx, master, cast):
        ctx.dtype = master.dtype
        return cast.view_as(cast)

    @staticmethod
    def backward(ctx, grad):
        return grad.to(ctx.dtype), None


def chunked_cross_entropy(
    hidden: torch.Tensor,       # (B, S, d) final hidden states
    unembed: torch.Tensor,      # (d, V) projection (fp32 master)
    labels: torch.Tensor,       # (B, S) integer
    chunk: int = 128,
    dtype=torch.bfloat16,
    count: int | None = None,
) -> torch.Tensor:
    """Mean next-token CE without materializing (B, S, V) logits.

    Loops over sequence chunks; each chunk computes (B, chunk, V) logits
    in ``dtype`` (bf16, as in the reference) with an fp32 log-sum-exp.
    The reference's scan body casts ``unembed`` to bf16 in each chunk, so
    its backward rounds each chunk's gradient of ``unembed`` to bf16 and
    sums the chunks in fp32; here one cast serves every chunk
    (:class:`_CastPerUse`) with that backward.

    ``count`` (a sharded step's rank, which holds a slice of the positions)
    divides the sum by the whole batch's count of positions instead of
    ``B * S``, and lets the last chunk run short.
    """
    b, s, _ = hidden.shape
    if count is None and s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of chunk {chunk}")
    w = unembed.to(dtype)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, s, chunk):
        hc = hidden[:, c0:c0 + chunk].to(dtype)
        yc = labels[:, c0:c0 + chunk].long()
        logits = (hc @ _CastPerUse.apply(unembed, w)).float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, yc[..., None])[..., 0]
        total = total + (lse - gold).sum()
    return total / (b * s if count is None else count)
