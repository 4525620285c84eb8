"""Mamba2 (SSD) block: chunked state-space duality scan + one-step decode
(PyTorch port of ``repro.models.mamba2``).

Training uses the SSD chunked algorithm: within a chunk of length Q the
output is a masked quadratic form (attention-like, O(Q^2)); across chunks a
(B, H, P, N) state is carried by an exponential-decay recurrence.  Only
(Q, Q) blocks are materialized, every chunk's at once (the chunks as rows
of the batch, each computed as the reference's ``lax.scan`` body computes
it); a Python loop over the ``S / chunk`` chunks carries the state, a
multiply and an add a chunk.  Every einsum runs in fp32, as in the
reference.

Decode is the O(1) recurrence: h' = da * h + dt * (B x); y = C h + D x.

The published Mamba-2 mixer (``modeling_nemotron_h.py``'s ``NemotronHMamba2Mixer``)
is the one whose params hold a convolution (``conv_w`` and ``conv_b``,
made by ``mamba2_init``'s ``conv_kernel``, off by default so that zamba2's
mixer, the reference's, is unchanged): a causal depthwise convolution with
bias, then SiLU, over x, B and C; and at the end y gated by silu(z) first,
then an RMSNorm over each of the ``n_groups`` groups of channels
(``MambaRMSNormGated``), where the reference normalises all of
``d_inner`` and gates after.  The scan is an autograd Function of its
own (:class:`_SSDScan`): its backward recomputes the scan and
differentiates it, so a range around the Function's two methods holds the
scan's whole work.

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
    conv_kernel: int = 0,
) -> Params:
    """A mixer's params; ``conv_kernel`` adds the causal depthwise
    convolution over x, B and C: ``conv_w`` (kernel, channels), tap j
    reading position t - kernel + 1 + j, and ``conv_b`` (channels)."""
    d_in_proj = 2 * d_inner + 2 * n_groups * d_state + n_heads
    dev = gen.device
    p = {
        "in_proj": dense_init(gen, d_model, d_in_proj),
        "out_proj": dense_init(gen, d_inner, d_model, scale=1.0 / math.sqrt(d_inner)),
        "A_log": torch.zeros((n_heads,), dtype=torch.float32, device=dev),   # A = -exp(A_log)
        "D": torch.ones((n_heads,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((n_heads,), dtype=torch.float32, device=dev),
        "norm": rmsnorm_init(d_inner, device=dev),
    }
    if conv_kernel:
        channels = d_inner + 2 * n_groups * d_state
        p["conv_w"] = dense_init(gen, conv_kernel, channels)["w"]
        p["conv_b"] = torch.zeros((channels,), dtype=torch.float32, device=dev)
    return p


def _split_proj(z, d_inner, n_groups, d_state, n_heads):
    ofs = 0
    gate = z[..., ofs:ofs + d_inner]; ofs += d_inner
    x = z[..., ofs:ofs + d_inner]; ofs += d_inner
    b = z[..., ofs:ofs + n_groups * d_state]; ofs += n_groups * d_state
    c = z[..., ofs:ofs + n_groups * d_state]; ofs += n_groups * d_state
    dt = z[..., ofs:ofs + n_heads]
    return gate, x, b, c, dt


def causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """SiLU of the causal depthwise convolution of ``xbc`` (B, S, C) with
    taps ``w`` (K, C) and bias ``b`` (C,), zeros before the first position:
    out[t] = b + sum_j w[j] * xbc[t - K + 1 + j].  Sums in fp32, the result
    in ``xbc``'s dtype."""
    k, sl = w.shape[0], xbc.shape[1]
    xp = F.pad(xbc.float(), (0, 0, k - 1, 0))
    out = b
    for j in range(k):
        out = out + xp[:, j:j + sl] * w[j]
    return F.silu(out).to(xbc.dtype)


def gated_group_norm(scale: torch.Tensor, y: torch.Tensor, gate: torch.Tensor, groups: int,
                     eps: float) -> torch.Tensor:
    """``MambaRMSNormGated``: y * silu(gate), then an RMSNorm over each of
    ``groups`` equal groups of the last dim, times ``scale``; in fp32, the
    result in ``gate``'s dtype."""
    h = y.float() * F.silu(gate.float())
    grouped = h.reshape(*h.shape[:-1], groups, h.shape[-1] // groups)
    grouped = grouped * torch.rsqrt((grouped * grouped).mean(dim=-1, keepdim=True) + eps)
    return (grouped.reshape(h.shape) * scale).to(gate.dtype)


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
    norm_eps: float = 1e-5,       # the published mixer's gated group norm
) -> torch.Tensor:
    sp = spmd.context(resid, h_spec)
    if sp is not None and sp.seq_split and h_spec is None:
        return sp.whole_sequence(lambda uu: mamba2_apply(
            p, uu, d_inner, n_heads, d_state, n_groups, chunk, norm_eps=norm_eps), u)
    bsz, sl, _ = u.shape
    hd = d_inner // n_heads
    z = dense_apply(p["in_proj"], u)
    gate, x, bmat, cmat, dt = _split_proj(z, d_inner, n_groups, d_state, n_heads)
    published = "conv_w" in p
    if published:
        xbc = causal_conv(z[..., d_inner:-n_heads], p["conv_w"], p["conv_b"])
        x, bmat, cmat = xbc.split([d_inner, n_groups * d_state, n_groups * d_state], dim=-1)
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
    y = _SSDScan.apply(x, bmat, cmat, dt, dt_bias, a_log, d_skip, chunk)  # (B,S,H,P) fp32
    if h_spec is not None:
        y = h_spec.ctx.seq_from_heads(y)
    if published:
        y = gated_group_norm(p["norm"]["scale"], y.reshape(bsz, sl, d_inner), gate,
                             n_groups, norm_eps)
    else:
        y = y.reshape(bsz, sl, d_inner).to(u.dtype)
        y = rmsnorm_apply(p["norm"], y) * F.silu(gate)
    return dense_apply(p["out_proj"], y)


class _SSDScan(torch.autograd.Function):
    """:func:`_ssd_scan` with a backward that runs the scan again under
    autograd and differentiates it: the forward keeps only its inputs, and
    the scan's work, both directions, lies inside the Function's two
    methods."""

    @staticmethod
    def forward(ctx, x, bmat, cmat, dt, dt_bias, a_log, d_skip, chunk):
        ctx.save_for_backward(x, bmat, cmat, dt, dt_bias, a_log, d_skip)
        ctx.chunk = chunk
        return _ssd_scan(x, bmat, cmat, dt, dt_bias, a_log, d_skip, chunk)

    @staticmethod
    def backward(ctx, dy):
        needs = ctx.needs_input_grad[:7]
        with torch.enable_grad():
            live = [t.detach().requires_grad_(need) for t, need in zip(ctx.saved_tensors, needs)]
            y = _ssd_scan(*live, ctx.chunk)
            wanted = [t for t in live if t.requires_grad]
            grads = iter(torch.autograd.grad(y, wanted, dy, allow_unused=True,
                                             materialize_grads=True))
        return (*(next(grads) if need else None for need in needs), None)


def _ssd_scan(x, bmat, cmat, dt, dt_bias, a_log, d_skip, chunk: int) -> torch.Tensor:
    """The chunked SSD scan of x (B,S,H,P) with B/C (B,S,H,N) and the raw
    dt (B,S,H), plus the D skip term: y (B,S,H,P) in fp32.

    Every chunk's own terms are computed at once, the chunks taken as rows
    of the batch (each chunk's arithmetic as a chunk at a time would do
    it); only the state carried from chunk to chunk, a multiply and an add
    a chunk, runs in a loop."""
    bsz, s, n_heads, hd = x.shape
    d_state = bmat.shape[-1]
    dt = F.softplus(dt.float() + dt_bias)                           # (B,S,H)
    a = -torch.exp(a_log)                                           # (H,)
    da = dt * a                                                     # (B,S,H) <= 0

    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of chunk {chunk}")
    n_chunks = s // chunk

    def chunks(t):                                                  # (B,S,...) -> (B*C,Q,...)
        return t.reshape(bsz * n_chunks, chunk, *t.shape[2:])

    xc, bc32, cc32 = chunks(x), chunks(bmat).float(), chunks(cmat).float()
    dtc, dac = chunks(dt), chunks(da)                               # (B*C,Q,H)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    # cumulative decay within a chunk: seg[i] = sum_{j<=i} da[j]
    seg = torch.cumsum(dac, dim=1)                                  # (B*C,Q,H)
    # y_intra[i] = sum_{j<=i} exp(seg[i]-seg[j]) * (C_i . B_j) dt_j x_j
    scores = torch.einsum("bqhn,bkhn->bhqk", cc32, bc32)
    seg_h = seg.permute(0, 2, 1)                                    # (B*C,H,Q)
    decay = seg_h[..., :, None] - seg_h[..., None, :]               # (B*C,H,Qi,Qj)
    # the mask goes on the exponent: above the diagonal decay is positive,
    # and exp there may overflow to inf, whose gradient times the mask's
    # zero is NaN (the reference masks exp's output and meets that NaN)
    gmat = torch.exp(decay.masked_fill(~causal, -math.inf))
    w = scores * gmat                                               # (B*C,H,Q,Q)
    xdt = xc.float() * dtc[..., None]                               # (B*C,Q,H,P)
    y_intra = torch.einsum("bhqk,bkhp->bqhp", w, xdt)
    c_seg = cc32 * torch.exp(seg)[..., None]
    # what a chunk adds to the state it passes on: sum_j exp(seg[Q-1]-seg[j]) B_j dt_j x_j
    tail = torch.exp(seg[:, -1][:, :, None] - seg_h)                # (B*C,H,Q)
    hb = torch.einsum("bhq,bqhn,bqhp->bhpn", tail, bc32, xdt)
    hb = hb.reshape(bsz, n_chunks, n_heads, hd, d_state)
    keep = torch.exp(seg[:, -1]).reshape(bsz, n_chunks, n_heads)[..., None, None]
    # the state each chunk starts from: h' = exp(seg[Q-1]) h + hb
    h = torch.zeros((bsz, n_heads, hd, d_state), dtype=torch.float32, device=x.device)
    starts = []
    for c in range(n_chunks):
        starts.append(h)
        h = keep[:, c] * h + hb[:, c]
    starts = torch.stack(starts, dim=1).reshape(bsz * n_chunks, n_heads, hd, d_state)
    # contribution of the carried state: y_state[i] = exp(seg[i]) C_i . h
    y_state = torch.einsum("bqhn,bhpn->bqhp", c_seg, starts)
    y = (y_intra + y_state).reshape(bsz, s, n_heads, hd)            # (B,S,H,P)
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
