"""Mamba2 (SSD) block: chunked state-space duality scan + one-step decode
(PyTorch port of ``repro.models.mamba2``).

Training uses the SSD chunked algorithm: within a chunk of length Q the
output is a masked quadratic form (attention-like, O(Q^2)); across chunks a
(B, H, P, N) state is carried by an exponential-decay recurrence.  Only
(B, H, Q, Q) blocks are materialized.  A Python loop over the ``S / chunk``
chunks takes the place of ``lax.scan``; every einsum runs in fp32, as in
the reference.

Decode is the O(1) recurrence: h' = da * h + dt * (B x); y = C h + D x.

On a mesh (the sharded step) each model rank holds a slice of the
sequence.  The reference's ``h_spec`` (SSM heads over model) becomes two
all-to-alls: the scan's operands go from sequence-sharded to head-sharded,
each rank scans its heads over the whole sequence, and the output comes
back sequence-sharded.  With no hint the layer runs on the whole sequence
and keeps its slice.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import Params, dense_apply, dense_init, rmsnorm_apply, rmsnorm_init
from repro_torch.parallel import spmd


def mamba2_init(
    gen: torch.Generator,
    d_model: int,
    d_inner: int,
    n_heads: int,
    d_state: int,
    n_groups: int = 1,
) -> Params:
    d_in_proj = 2 * d_inner + 2 * n_groups * d_state + n_heads
    dev = gen.device
    return {
        "in_proj": dense_init(gen, d_model, d_in_proj),
        "out_proj": dense_init(gen, d_inner, d_model, scale=1.0 / math.sqrt(d_inner)),
        "A_log": torch.zeros((n_heads,), dtype=torch.float32, device=dev),   # A = -exp(A_log)
        "D": torch.ones((n_heads,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((n_heads,), dtype=torch.float32, device=dev),
        "norm": rmsnorm_init(d_inner, device=dev),
    }


def _split_proj(z, d_inner, n_groups, d_state, n_heads):
    ofs = 0
    gate = z[..., ofs:ofs + d_inner]; ofs += d_inner
    x = z[..., ofs:ofs + d_inner]; ofs += d_inner
    b = z[..., ofs:ofs + n_groups * d_state]; ofs += n_groups * d_state
    c = z[..., ofs:ofs + n_groups * d_state]; ofs += n_groups * d_state
    dt = z[..., ofs:ofs + n_heads]
    return gate, x, b, c, dt


def mamba2_apply(
    p: Params,
    u: torch.Tensor,              # (B, S, d_model)
    d_inner: int,
    n_heads: int,
    d_state: int,
    n_groups: int = 1,
    chunk: int = 128,
    h_spec=None,                  # SSM heads over model: head-parallel scan
    resid=None,                   # the residual stream's sharding
) -> torch.Tensor:
    sp = spmd.context(resid, h_spec)
    if sp is not None and sp.seq_split and h_spec is None:
        return sp.whole_sequence(lambda uu: mamba2_apply(
            p, uu, d_inner, n_heads, d_state, n_groups, chunk), u)
    bsz, sl, _ = u.shape
    hd = d_inner // n_heads
    z = dense_apply(p["in_proj"], u)
    gate, x, bmat, cmat, dt = _split_proj(z, d_inner, n_groups, d_state, n_heads)
    x = x.reshape(bsz, sl, n_heads, hd)
    # broadcast groups to heads
    rep = n_heads // n_groups
    bmat = bmat.reshape(bsz, sl, n_groups, d_state).repeat_interleave(rep, dim=2)  # (B,S,H,N)
    cmat = cmat.reshape(bsz, sl, n_groups, d_state).repeat_interleave(rep, dim=2)
    dt_bias, a_log, d_skip = p["dt_bias"], p["A_log"], p["D"]
    if h_spec is not None:
        # head-parallel SSD: the scan's operands from sequence- to head-sharded
        sp = h_spec.ctx
        x, bmat, cmat, dt = (sp.heads_from_seq(t) for t in (x, bmat, cmat, dt))
        dt_bias, a_log, d_skip = (sp.slice_heads(t) for t in (dt_bias, a_log, d_skip))
    y = _ssd_scan(x, bmat, cmat, dt, dt_bias, a_log, d_skip, chunk)  # (B,S,H,P) fp32
    if h_spec is not None:
        y = h_spec.ctx.seq_from_heads(y)
    y = y.reshape(bsz, sl, d_inner).to(u.dtype)
    y = rmsnorm_apply(p["norm"], y) * F.silu(gate)
    return dense_apply(p["out_proj"], y)


def _ssd_scan(x, bmat, cmat, dt, dt_bias, a_log, d_skip, chunk: int) -> torch.Tensor:
    """The chunked SSD scan of x (B,S,H,P) with B/C (B,S,H,N) and the raw
    dt (B,S,H), plus the D skip term: y (B,S,H,P) in fp32."""
    bsz, s, n_heads, hd = x.shape
    d_state = bmat.shape[-1]
    dt = F.softplus(dt.float() + dt_bias)                           # (B,S,H)
    a = -torch.exp(a_log)                                           # (H,)
    da = dt * a                                                     # (B,S,H) <= 0

    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of chunk {chunk}")
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    h = torch.zeros((bsz, n_heads, hd, d_state), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, s, chunk):
        xc, bc, cc = x[:, c0:c0 + chunk], bmat[:, c0:c0 + chunk], cmat[:, c0:c0 + chunk]
        dtc, dac = dt[:, c0:c0 + chunk], da[:, c0:c0 + chunk]      # (B,Q,H)
        bc32, cc32 = bc.float(), cc.float()
        # cumulative decay within the chunk: seg[i] = sum_{j<=i} da[j]
        seg = torch.cumsum(dac, dim=1)                              # (B,Q,H)
        # y_intra[i] = sum_{j<=i} exp(seg[i]-seg[j]) * (C_i . B_j) dt_j x_j
        scores = torch.einsum("bqhn,bkhn->bhqk", cc32, bc32)
        seg_h = seg.permute(0, 2, 1)                                # (B,H,Q)
        decay = seg_h[..., :, None] - seg_h[..., None, :]           # (B,H,Qi,Qj)
        # the mask goes on the exponent: above the diagonal decay is positive,
        # and exp there may overflow to inf, whose gradient times the mask's
        # zero is NaN (the reference masks exp's output and meets that NaN)
        gmat = torch.exp(decay.masked_fill(~causal, -math.inf))
        w = scores * gmat                                           # (B,H,Q,Q)
        xdt = xc.float() * dtc[..., None]                           # (B,Q,H,P)
        y_intra = torch.einsum("bhqk,bkhp->bqhp", w, xdt)
        # contribution of the carried state: y_state[i] = exp(seg[i]) C_i . h
        y_state = torch.einsum("bqhn,bhpn->bqhp", cc32 * torch.exp(seg)[..., None], h)
        # h' = exp(seg[Q-1]) h + sum_j exp(seg[Q-1]-seg[j]) B_j dt_j x_j
        tail = torch.exp(seg[:, -1][:, :, None] - seg_h)             # (B,H,Q)
        hb = torch.einsum("bhq,bqhn,bqhp->bhpn", tail, bc32, xdt)
        h = torch.exp(seg[:, -1])[..., None, None] * h + hb
        ys.append(y_intra + y_state)
    y = torch.cat(ys, dim=1)                                        # (B,S,H,P)
    return y + x.float() * d_skip[None, None, :, None]


def mamba2_decode(
    p: Params,
    u: torch.Tensor,               # (B, 1, d_model)
    h: torch.Tensor,               # (B, H, P, N) carried SSM state
    d_inner: int,
    n_heads: int,
    d_state: int,
    n_groups: int = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    bsz = u.shape[0]
    hd = d_inner // n_heads
    z = dense_apply(p["in_proj"], u)
    gate, x, bmat, cmat, dt = _split_proj(z, d_inner, n_groups, d_state, n_heads)
    x = x.reshape(bsz, n_heads, hd)
    rep = n_heads // n_groups
    bmat = bmat.reshape(bsz, n_groups, d_state).repeat_interleave(rep, dim=1)
    cmat = cmat.reshape(bsz, n_groups, d_state).repeat_interleave(rep, dim=1)
    dt = F.softplus(dt.reshape(bsz, n_heads).float() + p["dt_bias"])
    a = -torch.exp(p["A_log"])
    da = torch.exp(dt * a)                                          # (B,H)
    xdt = x.float() * dt[..., None]                                 # (B,H,P)
    h_new = da[..., None, None] * h + torch.einsum("bhn,bhp->bhpn", bmat.float(), xdt)
    y = torch.einsum("bhn,bhpn->bhp", cmat.float(), h_new)
    y = y + x.float() * p["D"][None, :, None]
    y = y.reshape(bsz, 1, d_inner).to(u.dtype)
    y = rmsnorm_apply(p["norm"], y) * F.silu(gate.reshape(bsz, 1, d_inner))
    return dense_apply(p["out_proj"], y), h_new
