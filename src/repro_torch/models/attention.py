"""Attention: GQA/MHA (+QKV bias), MLA, blockwise (flash-style) training
attention, and KV-cache decode (PyTorch port of ``repro.models.attention``).

Training attention is *blockwise*: an online-softmax loop over KV blocks,
so the (S, S) score matrix is never materialized, and a backward pass
(:class:`_BlockwiseAttention`) that recomputes block scores instead of
storing per-block residuals (O(S) memory).  The models call it directly,
as the reference's do; the hand-written flash kernel is reached only
through :func:`repro_torch.kernels.ops.flash_attention`.

Decode attention computes scores against the full cache with a length
mask (cost honestly proportional to the cache length).  Unlike the
reference, which returns updated copies, the decode functions write the
new token into the caches in place (no copy of a 32 K cache per token)
and return them.
"""

from __future__ import annotations

import math

import torch

from repro_torch.models.layers import Params, apply_rope, dense_apply, dense_init

NEG_INF = -1e30


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


def _group_q(q: torch.Tensor, hkv: int) -> torch.Tensor:
    """(B, S, H, D) -> (B, S, Hkv, rep, D): grouped heads, no KV repeat."""
    b, s, h, d = q.shape
    return q.reshape(b, s, hkv, h // hkv, d)


def _scaled(x: torch.Tensor, scale: float) -> torch.Tensor:
    """``x * scale`` in x's dtype, the scale rounded to that dtype first (as
    JAX treats a weakly typed Python scalar)."""
    return x * torch.tensor(scale, dtype=x.dtype, device=x.device)


def _causal_mask(start: int, width: int, sq: int, q_offset: int, device) -> torch.Tensor:
    """(Sq, width) bool: key position start + j is visible to query row i."""
    q_pos = q_offset + torch.arange(sq, device=device)
    kv_pos = start + torch.arange(width, device=device)
    return kv_pos[None, :] <= q_pos[:, None]


def _product_f32(qg, kc):
    """Scores (B, Sq, Hkv, R, Sk) in fp32 of qg (B, Sq, Hkv, R, D) and kc
    (B, Sk, Hkv, D) taken in their own dtype: on the card, a bf16 pair as
    the tensor cores take it (bf16 products, fp32 sums), which is how the
    flash kernel's wgmma rounds; otherwise exact products summed in fp32."""
    if qg.dtype == torch.bfloat16 and qg.is_cuda:
        b, sq, g, r, d = qg.shape
        a = qg.permute(0, 2, 3, 1, 4).reshape(b * g, r * sq, d)
        bt = kc.permute(0, 2, 3, 1).reshape(b * g, d, kc.shape[1])
        out = torch.bmm(a, bt, out_dtype=torch.float32)
        return out.reshape(b, g, r, sq, -1).permute(0, 3, 1, 2, 4)
    return torch.einsum("bqgrd,bkgd->bqgrk", qg.float(), kc.float())


def _flash_fwd_scan(qg, k, v, causal, block, q_offset, scale=None):
    """Online-softmax forward over KV blocks with grouped GQA heads.

    qg: (B, Sq, Hkv, R, D) pre-scaled, or, given ``scale``, unscaled, the
    scale then multiplying each fp32 score (see ``_product_f32``); k/v:
    (B, Skv, Hkv, D[v]).  A Python
    loop over blocks takes the place of ``lax.scan``; the last block is
    sliced short instead of padded (padded keys add exactly 0).  With a
    causal mask, the query rows that see none of a block skip it (it would
    add exactly 0 to them), and the loop ends once no row sees a block.
    Returns (out f32 (B,Sq,Hkv,R,Dv), lse (B,Sq,Hkv,R)).
    """
    b, sq, hkv, rep, _ = qg.shape
    dv = v.shape[-1]
    q32 = qg.float()
    acc = torch.zeros((b, sq, hkv, rep, dv), dtype=torch.float32, device=qg.device)
    m = torch.full((b, sq, hkv, rep), NEG_INF, dtype=torch.float32, device=qg.device)
    l = torch.zeros((b, sq, hkv, rep), dtype=torch.float32, device=qg.device)
    for start in range(0, k.shape[1], block):
        # query row i sees key start only if start <= q_offset + i
        rows = min(max(start - q_offset, 0), sq) if causal else 0
        if rows == sq:
            break
        kc = k[:, start:start + block]
        vc = v[:, start:start + block]
        if scale is None:
            scores = torch.einsum("bqgrd,bkgd->bqgrk", q32[:, rows:], kc.float())
        else:
            scores = _product_f32(qg[:, rows:], kc) * scale
        if causal:
            mask = _causal_mask(start, kc.shape[1], sq - rows, q_offset + rows, qg.device)
            scores = scores.masked_fill(~mask[None, :, None, None, :], NEG_INF)
        m_new = torch.maximum(m[:, rows:], scores.amax(dim=-1))
        p = torch.exp(scores - m_new[..., None])
        alpha = torch.exp(m[:, rows:] - m_new)
        l_new = l[:, rows:] * alpha + p.sum(dim=-1)
        acc_new = acc[:, rows:] * alpha[..., None] + torch.einsum(
            "bqgrk,bkgd->bqgrd", p.to(vc.dtype).float(), vc.float()
        )
        # out of place, so autograd through the loop stays valid
        if rows:
            m_new = torch.cat([m[:, :rows], m_new], dim=1)
            l_new = torch.cat([l[:, :rows], l_new], dim=1)
            acc_new = torch.cat([acc[:, :rows], acc_new], dim=1)
        m, l, acc = m_new, l_new, acc_new
    l = torch.clamp_min(l, 1e-30)
    return acc / l[..., None], m + torch.log(l)


def _bw_attention_fwd_impl(q, k, v, causal, block, q_offset):
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    block = min(block, k.shape[1])
    qg = _group_q(_scaled(q, 1.0 / math.sqrt(d)), hkv)
    out, lse = _flash_fwd_scan(qg, k, v, causal, block, q_offset)
    return out.reshape(b, sq, h, v.shape[-1]).to(q.dtype), lse


class _BlockwiseAttention(torch.autograd.Function):
    """Blockwise attention with a backward that recomputes block scores from
    (q, k, v, out, lse), storing no per-block residuals."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block, q_offset):
        out, lse = _bw_attention_fwd_impl(q, k, v, causal, block, q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.block, ctx.q_offset = causal, block, q_offset
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, q_offset = ctx.causal, ctx.q_offset
        b, sq, h, d = q.shape
        hkv = k.shape[2]
        block = min(ctx.block, k.shape[1])
        scale = 1.0 / math.sqrt(d)
        qg = _group_q(q, hkv).float() * scale
        og = _group_q(out, hkv).float()
        dog = _group_q(dout, hkv).float()
        delta = (og * dog).sum(dim=-1)                  # D_i = rowsum(dout * out)
        dq = torch.zeros_like(qg)
        dks, dvs = [], []
        for start in range(0, k.shape[1], block):
            kc32 = k[:, start:start + block].float()
            vc32 = v[:, start:start + block].float()
            scores = torch.einsum("bqgrd,bkgd->bqgrk", qg, kc32)
            p = torch.exp(scores - lse[..., None])
            if causal:
                mask = _causal_mask(start, kc32.shape[1], sq, q_offset, q.device)
                p = p.masked_fill(~mask[None, :, None, None, :], 0.0)
            dvs.append(torch.einsum("bqgrk,bqgrd->bkgd", p, dog))
            dp = torch.einsum("bqgrd,bkgd->bqgrk", dog, vc32)
            ds = p * (dp - delta[..., None])            # (B,Sq,Hkv,R,block)
            # scores = (q*scale)@k  =>  dq = scale * ds@k;  dk = ds^T @ (q*scale)
            dq += torch.einsum("bqgrk,bkgd->bqgrd", ds, kc32) * scale
            dks.append(torch.einsum("bqgrk,bqgrd->bkgd", ds, qg))
        return (
            dq.reshape(b, sq, h, d).to(q.dtype),
            torch.cat(dks, dim=1).to(k.dtype),
            torch.cat(dvs, dim=1).to(v.dtype),
            None, None, None,
        )


def blockwise_attention(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, Skv, Hkv, D)
    v: torch.Tensor,  # (B, Skv, Hkv, Dv)
    causal: bool = True,
    block: int = 512,
    q_offset: int = 0,
) -> torch.Tensor:
    """Flash attention in plain PyTorch: online softmax over KV blocks,
    grouped GQA heads (no KV head repeat), and a backward that recomputes
    block scores instead of storing per-block residuals (O(S) memory)."""
    return _BlockwiseAttention.apply(q, k, v, causal, block, q_offset)


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
) -> torch.Tensor:
    b, s, _ = x.shape
    src = x if kv_in is None else kv_in
    q = dense_apply(p["wq"], x).reshape(b, s, n_heads, head_dim)
    k = dense_apply(p["wk"], src).reshape(b, src.shape[1], n_kv_heads, head_dim)
    v = dense_apply(p["wv"], src).reshape(b, src.shape[1], n_kv_heads, head_dim)
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    if kv_in is None and rope_theta > 0:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    out = blockwise_attention(q, k, v, causal and kv_in is None, block, 0)
    return dense_apply(p["wo"], out.reshape(b, s, n_heads * head_dim))


def _position(cur_len, device) -> tuple[int, torch.Tensor]:
    """``cur_len`` (int or 0-d tensor) as an int and as (1, 1) positions."""
    t = int(cur_len)
    return t, torch.full((1, 1), t, dtype=torch.int64, device=device)


def _cache_slot(t: int, smax: int) -> int:
    """The cache row a token at position ``t`` is written to: ``t`` clamped
    into ``[0, smax - 1]``, as ``jax.lax.dynamic_update_slice`` clamps its
    start, so a full cache overwrites its last row."""
    return min(max(t, 0), smax - 1)


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
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode; returns (out, cache_k, cache_v)."""
    b = x.shape[0]
    smax = cache_k.shape[1]
    t, pos = _position(cur_len, x.device)
    q = dense_apply(p["wq"], x).reshape(b, 1, n_heads, head_dim)
    k = dense_apply(p["wk"], x).reshape(b, 1, n_kv_heads, head_dim)
    v = dense_apply(p["wv"], x).reshape(b, 1, n_kv_heads, head_dim)
    if rope_theta > 0:
        q = apply_rope(q, pos, rope_theta)
        k = apply_rope(k, pos, rope_theta)
    slot = _cache_slot(t, smax)
    cache_k[:, slot:slot + 1] = k.to(cache_k.dtype)
    cache_v[:, slot:slot + 1] = v.to(cache_v.dtype)
    # grouped GQA: never materialize the head-repeated cache
    rep = n_heads // n_kv_heads
    qg = _scaled(q, 1.0 / math.sqrt(head_dim)).reshape(b, 1, n_kv_heads, rep, head_dim)
    scores = torch.einsum("bqgrd,bkgd->bgrqk", qg.float(), cache_k.float())
    valid = torch.arange(smax, device=x.device) <= t
    scores = scores.masked_fill(~valid, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(cache_v.dtype)
    out = torch.einsum("bgrqk,bkgd->bqgrd", w.float(), cache_v.float()).to(cache_v.dtype)
    out = dense_apply(p["wo"], out.reshape(b, 1, n_heads * head_dim))
    return out, cache_k, cache_v


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
) -> Params:
    return {
        "wq": dense_init(gen, d_model, n_heads * (qk_nope + qk_rope)),
        "w_dkv": dense_init(gen, d_model, kv_lora + qk_rope),
        "w_uk": dense_init(gen, kv_lora, n_heads * qk_nope),
        "w_uv": dense_init(gen, kv_lora, n_heads * v_head),
        "wo": dense_init(
            gen, n_heads * v_head, d_model, scale=1.0 / math.sqrt(n_heads * v_head)
        ),
    }


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
) -> torch.Tensor:
    """Training-time MLA: expand the latent to per-head K/V."""
    b, s, _ = x.shape
    q = dense_apply(p["wq"], x).reshape(b, s, n_heads, qk_nope + qk_rope)
    q_nope, q_rope = q[..., :qk_nope], q[..., qk_nope:]
    dkv = dense_apply(p["w_dkv"], x)                 # (B, S, kv_lora + qk_rope)
    c_kv, k_rope = dkv[..., :kv_lora], dkv[..., kv_lora:]
    pos = torch.arange(s, device=x.device)[None, :]
    q_rope = apply_rope(q_rope, pos, rope_theta)
    k_rope = apply_rope(k_rope[..., None, :], pos, rope_theta)[..., 0, :]
    k_nope = dense_apply(p["w_uk"], c_kv).reshape(b, s, n_heads, qk_nope)
    v = dense_apply(p["w_uv"], c_kv).reshape(b, s, n_heads, v_head)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, n_heads, qk_rope)], dim=-1)
    qq = torch.cat([q_nope, q_rope], dim=-1)
    out = blockwise_attention(qq, k, v, True, block, 0)
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
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Matrix-absorbed MLA decode: attention in the compressed space.

    The cache stores only (kv_lora + qk_rope) per token; the per-step
    up-projections are absorbed into q and the output.
    """
    b = x.shape[0]
    smax = cache_c.shape[1]
    t, pos = _position(cur_len, x.device)
    q = dense_apply(p["wq"], x).reshape(b, 1, n_heads, qk_nope + qk_rope)
    q_nope, q_rope = q[..., :qk_nope], q[..., qk_nope:]
    q_rope = apply_rope(q_rope, pos, rope_theta)
    dkv = dense_apply(p["w_dkv"], x)
    c_new, kr_new = dkv[..., :kv_lora], dkv[..., kv_lora:]
    kr_new = apply_rope(kr_new[..., None, :], pos, rope_theta)[..., 0, :]
    slot = _cache_slot(t, smax)
    cache_c[:, slot:slot + 1] = c_new.to(cache_c.dtype)
    cache_kr[:, slot:slot + 1] = kr_new.to(cache_kr.dtype)
    # absorb W_uk into the query: q_c[h] = q_nope[h] @ W_uk[h]^T  (B,1,H,kv_lora)
    w_uk = p["w_uk"]["w"].reshape(kv_lora, n_heads, qk_nope)
    q_c = _bf16_einsum("bqhn,lhn->bqhl", q_nope, w_uk)
    scale = 1.0 / math.sqrt(qk_nope + qk_rope)
    c16 = cache_c.to(torch.bfloat16).float()
    scores = (
        torch.einsum("bqhl,bkl->bhqk", q_c.float(), c16)
        + torch.einsum("bqhr,bkr->bhqk", q_rope.to(torch.bfloat16).float(),
                       cache_kr.to(torch.bfloat16).float())
    ) * scale
    valid = torch.arange(smax, device=x.device) <= t
    scores = scores.masked_fill(~valid, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out_c = _bf16_einsum("bhqk,bkl->bqhl", w, cache_c)              # (B,1,H,kv_lora)
    w_uv = p["w_uv"]["w"].reshape(kv_lora, n_heads, v_head)
    out = _bf16_einsum("bqhl,lhv->bqhv", out_c, w_uv)
    return (
        dense_apply(p["wo"], out.reshape(b, 1, n_heads * v_head)),
        cache_c,
        cache_kr,
    )
