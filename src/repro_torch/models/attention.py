"""Attention: GQA/MHA (+QKV bias), MLA, blockwise (flash-style) training
attention, and KV-cache decode (PyTorch port of ``repro.models.attention``).

Training attention is *blockwise*: an online-softmax loop over KV blocks,
so the (S, S) score matrix is never materialized, and a backward pass
(:class:`_BlockwiseAttention`) that recomputes block scores instead of
storing per-block residuals (O(S) memory).

The layers' attention goes through :func:`attention`, whose route
:func:`attention_route` decides once, before the call, from what the call
shows: the hand-written forward kernel (``kernels.flash_attention``) for
self-attention on CUDA tensors none of which needs a gradient; the
hand-written kernel pair (the flash forward writing each row's
log-sum-exp, and the fused backward), both directions, for any other call
on bf16 CUDA tensors of head dims the backward kernel takes; the plain
loops (``kernels.flash_attention``'s plain versions at the layer's block)
everywhere else.  Cross-attention (``kv_in``) never takes the forward-only
kernel.  A kernel that fails to build or launch, or refuses its operands,
raises; nothing falls back.

On a mesh (the sharded step, :mod:`repro_torch.parallel.spmd`) each model
rank holds a slice of the sequence.  The reference's hints take effect as
explicit collectives: with ``kv_spec`` (context-parallel attention) q
keeps its rows and the un-repeated K/V are all-gathered over the model
axis, the rows' causal positions starting at the rank's offset
(``q_offset``, which the flash kernel takes); ``q_spec`` (q rows over
model) is where q already lies.  With no hint the layer runs on the whole
sequence and keeps its slice.

Decode attention computes scores against the full cache with a length
mask (cost honestly proportional to the cache length).  Unlike the
reference, which returns updated copies, the decode functions write the
new token into the caches in place (no copy of a 32 K cache per token)
and return them; ``cur_len`` is taken as a 0-d tensor (shape-static: a
step traces on ``meta`` tensors).  On a mesh (``resid``: the sharded
decode's batch sharding) the caches are this rank's shards, the model
axis on each head's vector (or on the KV heads, or the MLA latent and
rope dims): the token's q, k and v are computed and rotated whole, the
rank writes its slice, its partial scores are summed over model before
the mask, and the output is gathered over model.  No cache is gathered.
"""

from __future__ import annotations

import math
from collections import Counter

import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.flash_attention import NEG_INF
from repro_torch.models.layers import (
    Params,
    Yarn,
    apply_rope,
    dense_apply,
    dense_init,
    rmsnorm_apply,
    rmsnorm_init,
)
from repro_torch.parallel import spmd

#: ``_BlockwiseAttention`` calls (forwards) that took the plain loops, by
#: device type: on the card, the share of training attention that did not
#: reach the kernel pair
PLAIN_CALLS: Counter = Counter()


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------


def gqa_init(
    gen: torch.Generator,
    d_model: int,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    qkv_bias: bool = False,
) -> Params:
    return {
        "wq": dense_init(gen, d_model, n_heads * head_dim, bias=qkv_bias),
        "wk": dense_init(gen, d_model, n_kv_heads * head_dim, bias=qkv_bias),
        "wv": dense_init(gen, d_model, n_kv_heads * head_dim, bias=qkv_bias),
        "wo": dense_init(
            gen, n_heads * head_dim, d_model, scale=1.0 / math.sqrt(n_heads * head_dim)
        ),
    }


def _scaled(x: torch.Tensor, scale: float) -> torch.Tensor:
    """``x * scale`` in x's dtype, the scale rounded to that dtype first (as
    JAX treats a weakly typed Python scalar)."""
    return x * torch.tensor(scale, dtype=x.dtype, device=x.device)


def _bw_attention_fwd_impl(q, k, v, causal, block, q_offset):
    """The plain loops' forward: ``fa._flash_fwd_scan`` over KV blocks of
    ``block`` keys, q scaled in q's dtype.  Returns (out, lse in the
    kernels' layout, which the plain backward takes)."""
    b, sq, h, d = q.shape
    block = min(block, k.shape[1])
    qg = fa._group_q(_scaled(q, 1.0 / math.sqrt(d)), k.shape[2])
    out, lse = fa._flash_fwd_scan(qg, k, v, causal, block, q_offset)
    return out.reshape(b, sq, h, v.shape[-1]).to(q.dtype), fa._to_kernel_lse(
        lse.reshape(b, sq, h))


def attention_route(device_type: str, dtypes, d: int, dv: int, needs_grad: bool,
                    cross: bool) -> str:
    """The route of an attention call, from what it shows: its operands'
    device type and dtypes, the head dims (D, Dv), whether autograd needs a
    gradient through it, and whether it is cross-attention (or asks for
    blockwise attention by name, :func:`blockwise_attention`).

    * ``"flash"``: self-attention on CUDA tensors, no gradient needed: the
      forward kernel ``fa.flash_attention_fwd``, which takes bf16 or fp32
      of ``fa.HEAD_DIMS`` and raises on anything else;
    * ``"pair"``: any other call on CUDA tensors, q, k and v all bf16, of
      head dims ``fa.BWD_HEAD_DIMS``: ``_BlockwiseAttention`` on the kernel
      pair, both directions, with a gradient or without;
    * ``"plain"``: everything else (the CPU; fp32 or other dims with a
      gradient; cross-attention off the pair): ``_BlockwiseAttention`` on
      the plain loops at the call's block.
    """
    if device_type != "cuda":
        return "plain"
    if not (needs_grad or cross):
        return "flash"
    if all(t == torch.bfloat16 for t in dtypes) and (d, dv) in fa.BWD_HEAD_DIMS:
        return "pair"
    return "plain"


class _BlockwiseAttention(torch.autograd.Function):
    """Blockwise attention with a backward that recomputes block scores from
    (q, k, v, out, lse), storing no per-block residuals.  ``kernels`` (the
    route, decided by the caller) runs both directions on the kernel pair;
    otherwise both run the plain loops."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block, q_offset, kernels):
        if kernels:
            out, lse = fa.flash_attention_fwd_lse(q, k, v, causal, q_offset)
        else:
            PLAIN_CALLS[q.device.type] += 1
            out, lse = _bw_attention_fwd_impl(q, k, v, causal, block, q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.block, ctx.q_offset, ctx.kernels = causal, block, q_offset, kernels
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if ctx.kernels:
            grads = fa.flash_attention_bwd(q, k, v, out, dout, lse, ctx.causal, ctx.q_offset)
        else:
            grads = fa.flash_attention_bwd_plain(q, k, v, out, dout, lse, ctx.causal,
                                                 ctx.q_offset, ctx.block)
        return (*grads, None, None, None, None)


def attention(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, Skv, Hkv, D)
    v: torch.Tensor,  # (B, Skv, Hkv, Dv)
    causal: bool = True,
    block: int = 512,
    q_offset: int = 0,
    cross: bool = False,
) -> torch.Tensor:
    """The layers' attention: q rows at positions ``q_offset + i`` against
    all of k/v, grouped GQA heads (no KV head repeat), on the route
    :func:`attention_route` decides.  ``block`` is the plain loops' KV
    block; the kernels walk their own tiles."""
    needs_grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    route = attention_route(q.device.type, (q.dtype, k.dtype, v.dtype), q.shape[-1],
                            v.shape[-1], needs_grad, cross)
    if route == "flash":
        return fa.flash_attention_fwd(q, k, v, causal, q_offset)
    return _BlockwiseAttention.apply(q, k, v, causal, block, q_offset, route == "pair")


def blockwise_attention(q, k, v, causal=True, block=512, q_offset=0):
    """Flash attention in plain PyTorch: online softmax over KV blocks and a
    backward that recomputes block scores instead of storing per-block
    residuals (O(S) memory); routed as cross-attention is, so never on the
    forward-only kernel (on the card, on the kernel pair where
    :func:`attention_route` takes it)."""
    return attention(q, k, v, causal, block, q_offset, cross=True)


def _blockwise_attention_autodiff(q, k, v, causal=True, block=512, q_offset=0):
    """Same forward, gradients by plain autograd through the block loop
    (stores per-block residuals): the gradient oracle of the tests."""
    out, _ = _bw_attention_fwd_impl(q, k, v, causal, block, q_offset)
    return out


def gqa_apply(
    p: Params,
    x: torch.Tensor,                    # (B, S, d)
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    positions: torch.Tensor | None = None,
    rope_theta: float = 1e4,
    causal: bool = True,
    block: int = 512,
    kv_in: torch.Tensor | None = None,  # cross-attention source (B, Skv, d)
    q_spec=None,                        # q rows over model: where they lie
    kv_spec=None,                       # K/V whole over model: all-gathered
    resid=None,                         # the residual stream's sharding
) -> torch.Tensor:
    sp = spmd.context(resid, kv_spec)
    if sp is not None and sp.seq_split and kv_spec is None:
        def whole(xx, *src):
            return gqa_apply(p, xx, n_heads, n_kv_heads, head_dim, positions, rope_theta,
                             causal, block, src[0] if src else None)

        return sp.whole_sequence(whole, x, *([] if kv_in is None else [kv_in]))
    b, s, _ = x.shape
    src = x if kv_in is None else kv_in
    q = dense_apply(p["wq"], x).reshape(b, s, n_heads, head_dim)
    k = dense_apply(p["wk"], src).reshape(b, src.shape[1], n_kv_heads, head_dim)
    v = dense_apply(p["wv"], src).reshape(b, src.shape[1], n_kv_heads, head_dim)
    offset = 0 if kv_spec is None else kv_spec.ctx.seq_offset(s)
    if positions is None:
        positions = offset + torch.arange(s, device=x.device)[None, :]
    if kv_in is None and rope_theta > 0:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    if kv_spec is not None:
        k, v = kv_spec.ctx.gather_seq(k), kv_spec.ctx.gather_seq(v)
    if kv_in is None:
        out = attention(q, k, v, causal, block, offset)
    else:
        out = attention(q, k, v, False, block, 0, cross=True)
    return dense_apply(p["wo"], out.reshape(b, s, n_heads * head_dim))


def _position(cur_len, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``cur_len`` (int or 0-d tensor) as a 0-d int64 tensor on ``device``
    and as (1, 1) positions: shape-static, so a decode step traces on
    ``meta`` tensors and reads no value back to the host."""
    t = torch.as_tensor(cur_len, dtype=torch.int64, device=device).reshape(())
    return t, t.reshape(1, 1)


def _cache_slot(t: torch.Tensor, smax: int) -> torch.Tensor:
    """The cache row a token at position ``t`` is written to: ``t`` clamped
    into ``[0, smax - 1]``, as ``jax.lax.dynamic_update_slice`` clamps its
    start, so a full cache overwrites its last row."""
    return t.clamp(0, smax - 1)


def _write_row(cache: torch.Tensor, slot, new: torch.Tensor) -> None:
    """``new`` (B, 1, ...) into row ``slot`` of ``cache`` (B, Smax, ...), in place."""
    index = torch.as_tensor(slot, dtype=torch.int64, device=cache.device).reshape(1)
    cache.index_copy_(1, index, new.to(cache.dtype))


def _decode_qkv(p, x, pos, n_heads, n_kv_heads, head_dim, rope_theta, sp=None, split=None):
    """One token's grouped, scaled q (B, 1, Hkv, rep, D) and its k and v
    (B, 1, Hkv, D), rotated whole; on a mesh whose model axis splits the
    cache (``split``: -1 for the head vector, -2 for the KV heads), this
    rank's part of each.  RoPE pairs dim i with dim i + D/2, so a slice of
    the head vector is cut only after the rotation."""
    b = x.shape[0]
    q = dense_apply(p["wq"], x).reshape(b, 1, n_heads, head_dim)
    k = dense_apply(p["wk"], x).reshape(b, 1, n_kv_heads, head_dim)
    v = dense_apply(p["wv"], x).reshape(b, 1, n_kv_heads, head_dim)
    if rope_theta > 0:
        q = apply_rope(q, pos, rope_theta)
        k = apply_rope(k, pos, rope_theta)
    qg = _scaled(q, 1.0 / math.sqrt(head_dim)).reshape(
        b, 1, n_kv_heads, n_heads // n_kv_heads, head_dim)
    if split is not None:
        qg = sp.own_model(qg, -1 if split == -1 else -3)
        k, v = sp.own_model(k, split), sp.own_model(v, split)
    return qg, k, v


def _grouped_attend(qg, cache_k, cache_v, valid, sp=None, split=None) -> torch.Tensor:
    """softmax(q . k) v of grouped q (B, 1, Hkv, rep, D) against a cache
    (B, S, Hkv, D), keys where ``valid`` (S,) holds; grouped GQA, never
    the head-repeated cache.  On a mesh the cache is this rank's shard:
    split on D, the partial scores are summed over model before the mask;
    the output (B, 1, Hkv, rep, Dv) is gathered whole over model."""
    scores = torch.einsum("bqgrd,bkgd->bgrqk", qg.float(), cache_k.float())
    if split == -1:
        scores = sp.sum_over_model(scores)
    scores = scores.masked_fill(~valid, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(cache_v.dtype)
    out = torch.einsum("bgrqk,bkgd->bqgrd", w.float(), cache_v.float()).to(cache_v.dtype)
    if split is not None:
        out = sp.gather_model(out, -1 if split == -1 else -3)
    return out


def gqa_decode(
    p: Params,
    x: torch.Tensor,                    # (B, 1, d)
    cache_k: torch.Tensor,              # (B, Smax, Hkv, D), updated in place
    cache_v: torch.Tensor,
    cur_len,                            # tokens already in cache
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    rope_theta: float = 1e4,
    resid=None,                         # the sharded decode's batch sharding
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode; returns (out, cache_k, cache_v).  On a mesh the
    caches are this rank's shards (``cache_specs``: the model axis on the
    head vector, or on the KV heads), written and attended where they lie."""
    b = x.shape[0]
    smax = cache_k.shape[1]
    t, pos = _position(cur_len, x.device)
    sp = spmd.context(resid)
    split = None if sp is None else sp.model_dim(cache_k, (n_kv_heads, head_dim))
    qg, k, v = _decode_qkv(p, x, pos, n_heads, n_kv_heads, head_dim, rope_theta, sp, split)
    slot = _cache_slot(t, smax)
    _write_row(cache_k, slot, k)
    _write_row(cache_v, slot, v)
    valid = torch.arange(smax, device=x.device) <= t
    out = _grouped_attend(qg, cache_k, cache_v, valid, sp, split)
    out = dense_apply(p["wo"], out.reshape(b, 1, n_heads * head_dim))
    return out, cache_k, cache_v


def cross_decode(
    p: Params,
    x: torch.Tensor,                    # (B, 1, d)
    cache_k: torch.Tensor,              # (B, S_enc, Hkv, D): the encoder's K/V
    cache_v: torch.Tensor,
    enc_len,                            # the encoder positions filled
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    resid=None,
) -> torch.Tensor:
    """One token's cross-attention against the static encoder K/V cache
    (whisper's decoder); on a mesh against this rank's shard of it, as
    :func:`gqa_decode`."""
    b = x.shape[0]
    sp = spmd.context(resid)
    split = None if sp is None else sp.model_dim(cache_k, (n_kv_heads, head_dim))
    q = dense_apply(p["wq"], x).reshape(b, 1, n_heads, head_dim)
    qg = _scaled(q, 1.0 / math.sqrt(head_dim)).reshape(
        b, 1, n_kv_heads, n_heads // n_kv_heads, head_dim)
    if split is not None:
        qg = sp.own_model(qg, -1 if split == -1 else -3)
    valid = torch.arange(cache_k.shape[1], device=x.device) < enc_len
    out = _grouped_attend(qg, cache_k, cache_v, valid, sp, split)
    return dense_apply(p["wo"], out.reshape(b, 1, -1))


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------


def mla_init(
    gen: torch.Generator,
    d_model: int,
    n_heads: int,
    kv_lora: int,
    qk_nope: int,
    qk_rope: int,
    v_head: int,
    kv_norm: bool = False,
) -> Params:
    """MLA's projections, and with ``kv_norm`` the latent's RMSNorm
    (DeepSeek-V2's ``kv_a_layernorm``)."""
    p = {
        "wq": dense_init(gen, d_model, n_heads * (qk_nope + qk_rope)),
        "w_dkv": dense_init(gen, d_model, kv_lora + qk_rope),
        "w_uk": dense_init(gen, kv_lora, n_heads * qk_nope),
        "w_uv": dense_init(gen, kv_lora, n_heads * v_head),
        "wo": dense_init(
            gen, n_heads * v_head, d_model, scale=1.0 / math.sqrt(n_heads * v_head)
        ),
    }
    if kv_norm:
        p["kv_norm"] = rmsnorm_init(kv_lora, device=gen.device)
    return p


def _latent(p: Params, c_kv: torch.Tensor, norm_eps: float) -> torch.Tensor:
    """The latent the up-projections (and the decode cache) take: normed
    where the layer has the latent's RMSNorm."""
    return rmsnorm_apply(p["kv_norm"], c_kv, norm_eps) if "kv_norm" in p else c_kv


def _yarn_scaled(q: torch.Tensor, yarn: Yarn | None) -> torch.Tensor:
    """q times YaRN's softmax scale (mscale squared; computed in fp32), so
    that the attention's own 1/sqrt(D) gives the published scale."""
    if yarn is None:
        return q
    return (q.float() * yarn.attention_scale()).to(q.dtype)


def mla_apply(
    p: Params,
    x: torch.Tensor,
    n_heads: int,
    kv_lora: int,
    qk_nope: int,
    qk_rope: int,
    v_head: int,
    rope_theta: float = 1e4,
    block: int = 512,
    q_spec=None,
    kv_spec=None,
    resid=None,
    yarn: Yarn | None = None,
    norm_eps: float = 1e-6,
) -> torch.Tensor:
    """Training-time MLA: expand the latent to per-head K/V.  On a mesh, as
    :func:`gqa_apply`: with ``kv_spec`` the expanded K/V are all-gathered
    over model once a layer (MLA has as many K/V heads as q heads).
    ``yarn`` (DeepSeek-V2's ``rope_scaling``) sets the rotary frequencies
    and the softmax scale; a layer with ``kv_norm`` params norms the latent
    (at ``norm_eps``) before the up-projections."""
    sp = spmd.context(resid, kv_spec)
    if sp is not None and sp.seq_split and kv_spec is None:
        return sp.whole_sequence(lambda xx: mla_apply(
            p, xx, n_heads, kv_lora, qk_nope, qk_rope, v_head, rope_theta, block,
            yarn=yarn, norm_eps=norm_eps), x)
    b, s, _ = x.shape
    q = dense_apply(p["wq"], x).reshape(b, s, n_heads, qk_nope + qk_rope)
    q_nope, q_rope = q[..., :qk_nope], q[..., qk_nope:]
    dkv = dense_apply(p["w_dkv"], x)                 # (B, S, kv_lora + qk_rope)
    c_kv, k_rope = _latent(p, dkv[..., :kv_lora], norm_eps), dkv[..., kv_lora:]
    offset = 0 if kv_spec is None else kv_spec.ctx.seq_offset(s)
    pos = offset + torch.arange(s, device=x.device)[None, :]
    q_rope = apply_rope(q_rope, pos, rope_theta, yarn)
    k_rope = apply_rope(k_rope[..., None, :], pos, rope_theta, yarn)[..., 0, :]
    k_nope = dense_apply(p["w_uk"], c_kv).reshape(b, s, n_heads, qk_nope)
    v = dense_apply(p["w_uv"], c_kv).reshape(b, s, n_heads, v_head)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, n_heads, qk_rope)], dim=-1)
    qq = _yarn_scaled(torch.cat([q_nope, q_rope], dim=-1), yarn)
    if kv_spec is not None:
        k, v = kv_spec.ctx.gather_seq(k), kv_spec.ctx.gather_seq(v)
    out = attention(qq, k, v, True, block, offset)
    return dense_apply(p["wo"], out.reshape(b, s, n_heads * v_head))


def _bf16_einsum(eq: str, *operands: torch.Tensor) -> torch.Tensor:
    """A bf16 einsum with fp32 accumulation and a bf16 result, on any device."""
    return torch.einsum(eq, *(x.to(torch.bfloat16).float() for x in operands)).to(
        torch.bfloat16)


def mla_decode(
    p: Params,
    x: torch.Tensor,                   # (B, 1, d)
    cache_c: torch.Tensor,             # (B, Smax, kv_lora) latents, updated in place
    cache_kr: torch.Tensor,            # (B, Smax, qk_rope), updated in place
    cur_len,
    n_heads: int,
    kv_lora: int,
    qk_nope: int,
    qk_rope: int,
    v_head: int,
    rope_theta: float = 1e4,
    resid=None,
    yarn: Yarn | None = None,
    norm_eps: float = 1e-6,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Matrix-absorbed MLA decode: attention in the compressed space.

    The cache stores only (kv_lora + qk_rope) per token (the latent as the
    up-projections take it: normed, where the layer norms it); the per-step
    up-projections are absorbed into q and the output.  ``yarn`` and the
    latent's norm act as in :func:`mla_apply`.  On a mesh the
    caches are this rank's shards, the model axis on the latent dim and on
    the rope dim: both score terms contract over a split dim, so their
    partial sums take one all-reduce over model, and the output is gathered
    in latent space before ``w_uv``.
    """
    b = x.shape[0]
    smax = cache_c.shape[1]
    t, pos = _position(cur_len, x.device)
    sp = spmd.context(resid)
    split_c = None if sp is None else sp.model_dim(cache_c, (kv_lora,))
    split_r = None if sp is None else sp.model_dim(cache_kr, (qk_rope,))
    q = dense_apply(p["wq"], x).reshape(b, 1, n_heads, qk_nope + qk_rope)
    q_nope, q_rope = q[..., :qk_nope], q[..., qk_nope:]
    q_rope = apply_rope(q_rope, pos, rope_theta, yarn)
    dkv = dense_apply(p["w_dkv"], x)
    c_new, kr_new = _latent(p, dkv[..., :kv_lora], norm_eps), dkv[..., kv_lora:]
    kr_new = apply_rope(kr_new[..., None, :], pos, rope_theta, yarn)[..., 0, :]
    # absorb W_uk into the query: q_c[h] = q_nope[h] @ W_uk[h]^T  (B,1,H,kv_lora)
    w_uk = p["w_uk"]["w"].reshape(kv_lora, n_heads, qk_nope)
    q_c = _bf16_einsum("bqhn,lhn->bqhl", q_nope, w_uk)
    if split_c is not None:
        c_new, q_c = sp.own_model(c_new, -1), sp.own_model(q_c, -1)
    if split_r is not None:
        kr_new, q_rope = sp.own_model(kr_new, -1), sp.own_model(q_rope, -1)
    slot = _cache_slot(t, smax)
    _write_row(cache_c, slot, c_new)
    _write_row(cache_kr, slot, kr_new)
    scale = 1.0 / math.sqrt(qk_nope + qk_rope)
    if yarn is not None:
        scale *= yarn.attention_scale()
    c16 = cache_c.to(torch.bfloat16).float()
    s_c = torch.einsum("bqhl,bkl->bhqk", q_c.float(), c16)
    s_r = torch.einsum("bqhr,bkr->bhqk", q_rope.to(torch.bfloat16).float(),
                       cache_kr.to(torch.bfloat16).float())
    if split_c is not None and split_r is not None:
        scores = sp.sum_over_model(s_c + s_r)
    else:
        if split_c is not None:
            s_c = sp.sum_over_model(s_c)
        if split_r is not None:
            s_r = sp.sum_over_model(s_r)
        scores = s_c + s_r
    scores = scores * scale
    valid = torch.arange(smax, device=x.device) <= t
    scores = scores.masked_fill(~valid, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out_c = _bf16_einsum("bhqk,bkl->bqhl", w, cache_c)              # (B,1,H,kv_lora)
    if split_c is not None:
        out_c = sp.gather_model(out_c, -1)
    w_uv = p["w_uv"]["w"].reshape(kv_lora, n_heads, v_head)
    out = _bf16_einsum("bqhl,lhv->bqhv", out_c, w_uv)
    return (
        dense_apply(p["wo"], out.reshape(b, 1, n_heads * v_head)),
        cache_c,
        cache_kr,
    )
