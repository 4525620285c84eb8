"""xLSTM blocks: mLSTM (matrix memory, parallel-in-chunks) and sLSTM
(scalar memory, strictly sequential) — arXiv:2405.04517.  PyTorch port of
``repro.models.xlstm``.

mLSTM is a linear-attention-class cell: per head a (P, P') matrix memory C
and normalizer n are updated with exponential input gates and scalar forget
gates; training uses a chunked parallel form (a Python loop over chunks
in place of ``lax.scan``), decode is the O(1) recurrence.  Stabilization
follows the paper: a running max-log-gate m keeps exp() bounded.

sLSTM keeps per-head scalar state (c, n, h, m) with recurrent mixing
(block-diagonal R per head) and must step through time: its apply is a
per-token Python loop of small ops, host-bound on a GPU.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (
    Params,
    dense_apply,
    dense_init,
    layernorm_apply,
    layernorm_init,
    rmsnorm_apply,
    rmsnorm_init,
)

# the initial running max of the log gates, as in the reference
M_INIT = -1e30


def _div(x: torch.Tensor, divisor: float) -> torch.Tensor:
    """``x / divisor`` in x's dtype, the divisor rounded to that dtype first
    (as JAX treats a weakly typed Python scalar)."""
    return x / torch.tensor(divisor, dtype=x.dtype, device=x.device)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def mlstm_init(gen: torch.Generator, d_model: int, n_heads: int, pf: float = 2.0) -> Params:
    d_inner = int(d_model * pf)
    return {
        "up": dense_init(gen, d_model, 2 * d_inner),   # x and gate paths
        "wq": dense_init(gen, d_inner, d_inner),
        "wk": dense_init(gen, d_inner, d_inner),
        "wv": dense_init(gen, d_inner, d_inner),
        "wi": dense_init(gen, d_inner, n_heads, scale=0.02),
        "wf": dense_init(gen, d_inner, n_heads, scale=0.02),
        # forget bias > 0
        "fb": torch.full((n_heads,), 3.0, dtype=torch.float32, device=gen.device),
        "norm": rmsnorm_init(d_inner, device=gen.device),
        "down": dense_init(gen, d_inner, d_model, scale=1.0 / math.sqrt(d_inner)),
    }


def mlstm_apply(
    p: Params, x: torch.Tensor, n_heads: int, pf: float = 2.0, chunk: int = 128
) -> torch.Tensor:
    b, s, d_model = x.shape
    d_inner = int(d_model * pf)
    hd = d_inner // n_heads
    up = dense_apply(p["up"], x)
    xi, gate = up[..., :d_inner], up[..., d_inner:]
    q = dense_apply(p["wq"], xi).reshape(b, s, n_heads, hd)
    k = _div(dense_apply(p["wk"], xi).reshape(b, s, n_heads, hd), math.sqrt(hd))
    v = dense_apply(p["wv"], xi).reshape(b, s, n_heads, hd)
    ig = dense_apply(p["wi"], xi).float()                              # (B,S,H) log-space
    fg = F.logsigmoid(dense_apply(p["wf"], xi).float() + p["fb"])      # (B,S,H) <= 0

    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of chunk {chunk}")
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    C = torch.zeros((b, n_heads, hd, hd), dtype=torch.float32, device=x.device)
    n = torch.zeros((b, n_heads, hd), dtype=torch.float32, device=x.device)
    m = torch.full((b, n_heads), M_INIT, dtype=torch.float32, device=x.device)
    hs = []
    for c0 in range(0, s, chunk):
        qc = q[:, c0:c0 + chunk].float()
        kc = k[:, c0:c0 + chunk].float()
        vc = v[:, c0:c0 + chunk].float()
        ic, fc = ig[:, c0:c0 + chunk], fg[:, c0:c0 + chunk]
        fcum = torch.cumsum(fc, dim=1)                                 # (B,Q,H)
        # log gate weight of key j for query i (i >= j): fcum[i] - fcum[j] + i[j]
        lw = fcum[:, :, None, :] - fcum[:, None, :, :] + ic[:, None, :, :]   # (B,Qi,Qj,H)
        lw = lw.masked_fill(~causal[None, :, :, None], -math.inf)
        # state contribution enters with log weight fcum[i] + m (carried max)
        lstate = fcum + m[:, None, :]                                  # (B,Qi,H)
        m_new = torch.maximum(lw.amax(dim=2), lstate)                  # (B,Qi,H)
        w = torch.exp(lw - m_new[:, :, None, :])                       # (B,Qi,Qj,H)
        sw = torch.exp(lstate - m_new)                                 # (B,Qi,H)
        scores = torch.einsum("bqhp,bkhp->bqkh", qc, kc) * w
        num_intra = torch.einsum("bqkh,bkhp->bqhp", scores, vc)
        num_state = torch.einsum("bqhp,bhpo->bqho", qc, C) * sw[..., None]
        den_intra = scores.sum(dim=2)                                  # (B,Q,H)
        den_state = torch.einsum("bqhp,bhp->bqh", qc, n) * sw
        den = torch.maximum(torch.abs(den_intra + den_state), torch.exp(-m_new))  # stabilizer
        hs.append((num_intra + num_state) / den[..., None])
        # chunk-final state update
        ftot = fcum[:, -1]                                             # (B,H)
        m_run = torch.maximum(ftot + m, (ftot[:, None, :] - fcum + ic).amax(dim=1))
        wk = torch.exp(ftot[:, None, :] - fcum + ic - m_run[:, None, :])   # (B,Q,H)
        carry = torch.exp(ftot + m - m_run)
        C = carry[..., None, None] * C + torch.einsum("bqh,bqhp,bqho->bhpo", wk, kc, vc)
        n = carry[..., None] * n + torch.einsum("bqh,bqhp->bhp", wk, kc)
        m = m_run
    h = torch.cat(hs, dim=1).reshape(b, s, d_inner).to(x.dtype)
    h = rmsnorm_apply(p["norm"], h) * F.silu(gate)
    return dense_apply(p["down"], h)


def mlstm_decode(
    p: Params,
    x: torch.Tensor,               # (B, 1, d_model)
    state: tuple[torch.Tensor, torch.Tensor, torch.Tensor],   # (C, n, m)
    n_heads: int,
    pf: float = 2.0,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    b, _, d_model = x.shape
    d_inner = int(d_model * pf)
    hd = d_inner // n_heads
    C, n, m = state
    up = dense_apply(p["up"], x)
    xi, gate = up[..., :d_inner], up[..., d_inner:]
    q = dense_apply(p["wq"], xi).reshape(b, n_heads, hd).float()
    k = _div(dense_apply(p["wk"], xi).reshape(b, n_heads, hd), math.sqrt(hd)).float()
    v = dense_apply(p["wv"], xi).reshape(b, n_heads, hd).float()
    ig = dense_apply(p["wi"], xi).reshape(b, n_heads).float()
    fg = F.logsigmoid(dense_apply(p["wf"], xi).reshape(b, n_heads).float() + p["fb"])
    m_new = torch.maximum(fg + m, ig)
    fw = torch.exp(fg + m - m_new)
    iw = torch.exp(ig - m_new)
    C_new = fw[..., None, None] * C + iw[..., None, None] * torch.einsum("bhp,bho->bhpo", k, v)
    n_new = fw[..., None] * n + iw[..., None] * k
    num = torch.einsum("bhp,bhpo->bho", q, C_new)
    den = torch.maximum(torch.abs(torch.einsum("bhp,bhp->bh", q, n_new)), torch.exp(-m_new))
    h = (num / den[..., None]).reshape(b, 1, d_inner).to(x.dtype)
    h = rmsnorm_apply(p["norm"], h) * F.silu(gate)
    return dense_apply(p["down"], h), (C_new, n_new, m_new)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def slstm_init(gen: torch.Generator, d_model: int, n_heads: int) -> Params:
    hd = d_model // n_heads
    ff = int(d_model * 4 / 3)
    return {
        # input projections for z, i, f, o gates
        "wx": dense_init(gen, d_model, 4 * d_model),
        # per-head recurrent mixing (H, P, 4P)
        "r": torch.randn((n_heads, hd, 4 * hd), generator=gen, dtype=torch.float32,
                         device=gen.device) * (1.0 / math.sqrt(hd)),
        "fb": torch.full((d_model,), 3.0, dtype=torch.float32, device=gen.device),
        "norm": layernorm_init(d_model, device=gen.device),
        "ffn": {
            "up": dense_init(gen, d_model, ff * 2),
            "down": dense_init(gen, ff, d_model, scale=1.0 / math.sqrt(d_model)),
        },
    }


def _slstm_cell(p, n_heads, hd, xt, state):
    """One sLSTM time step. xt: (B, 4*d). state: (c, n, h, m) each (B, d)."""
    c, n, h, m = state
    b = h.shape[0]
    d = n_heads * hd
    rh = torch.einsum("bhp,hpq->bhq", h.reshape(b, n_heads, hd).float(),
                      p["r"]).reshape(b, 4 * d)
    zi = (xt.float() + rh).reshape(b, 4, d)
    zt = torch.tanh(zi[:, 0])
    it = zi[:, 1]                                        # log-space input gate
    ft = F.logsigmoid(zi[:, 2] + p["fb"])                # log-space forget
    ot = torch.sigmoid(zi[:, 3])
    m_new = torch.maximum(ft + m, it)
    fw = torch.exp(ft + m - m_new)
    iw = torch.exp(it - m_new)
    c_new = fw * c + iw * zt
    n_new = fw * n + iw
    h_new = ot * c_new / torch.clamp_min(n_new, 1e-6)
    return (c_new, n_new, h_new, m_new)


def _slstm_ffn(p, h):
    # jax.nn.gelu defaults to the tanh approximation
    h = layernorm_apply(p["norm"], h)
    u = dense_apply(p["ffn"]["up"], h)
    half = u.shape[-1] // 2
    return dense_apply(p["ffn"]["down"],
                       F.gelu(u[..., :half], approximate="tanh") * u[..., half:])


def slstm_init_state(b: int, d: int, device) -> tuple[torch.Tensor, ...]:
    """(c, n, h, m) before the first token: zeros and m = -1e30."""
    zeros = [torch.zeros((b, d), dtype=torch.float32, device=device) for _ in range(3)]
    return (*zeros, torch.full((b, d), M_INIT, dtype=torch.float32, device=device))


def slstm_apply(p: Params, x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, s, d = x.shape
    hd = d // n_heads
    xs = dense_apply(p["wx"], x)                         # (B, S, 4d)
    state = slstm_init_state(b, d, x.device)
    hs = []
    for t in range(s):
        state = _slstm_cell(p, n_heads, hd, xs[:, t], state)
        hs.append(state[2])
    h = torch.stack(hs, dim=1).to(x.dtype)               # (B, S, d)
    return _slstm_ffn(p, h)


def slstm_decode(p: Params, x: torch.Tensor, state, n_heads: int) -> tuple[torch.Tensor, tuple]:
    b, _, d = x.shape
    hd = d // n_heads
    xt = dense_apply(p["wx"], x)[:, 0]
    new = _slstm_cell(p, n_heads, hd, xt, state)
    h = new[2][:, None, :].to(x.dtype)
    return _slstm_ffn(p, h), new
