"""Mixture-of-Experts layer: top-k routing with capacity-bounded dispatch
(PyTorch port of ``repro.models.moe``), or dropless.

Dispatch is scatter-based (sort-free ranks via cumulative counts): tokens
are placed into a fixed (B, E, C, d) buffer per batch row, expert FFNs run
as one batched einsum over the expert axis, and results are gathered back
with router weights.  Tokens over capacity are dropped (Switch/GShard
semantics, capacity_factor 1.25 default).  Supports shared experts
(DeepSeek-V2: 2 shared + 64 routed top-6) and pure routed (DBRX: 16 routed
top-4).

DeepSeek-V2 as published (``modeling_deepseek.py``'s ``MoEGate`` and
``DeepseekV2MoE`` in training) takes three keywords of :func:`moe_apply`,
each off by default (:func:`routing_options` reads them from a config):
``norm_topk`` False leaves the top-k softmax weights as they are;
``dropless`` computes every choice, sorted by expert, as grouped products
over the experts (:class:`_GroupedExperts`, ``torch._grouped_mm`` with the
group ends on the device: no host sync); ``aux_alpha`` adds the
sequence-wise balance loss, alpha * sum_e f_e * P_e per row, averaged over
the rows (f_e: the row's choices of e times E / (S * K); P_e: e's mean
routing probability over the row), to the gradient as DeepSeek's
``AddAuxiliaryLoss`` does: the output is returned unchanged and the term
gets a gradient of 1 (:class:`_AddAux`).  Routing is :func:`route`.
``ROUTED`` counts the dropless path's choices per expert on the device;
``AUX`` collects the balance terms whose gradient a backward took.

On a mesh, :func:`moe_ep_apply` is the reference's expert-parallel
dataflow with its collectives written out (the reference's ``shard_map``
body): per-rank routing, one all-to-all to the expert owners over the
model axis, the local SwiGLU, one all-to-all back.  The reference's
``ep_spec`` (a layout constraint on ``moe_apply``'s dispatch buffer) has
no counterpart: the sharded step runs ``moe_apply`` on whole rows with
its experts gathered.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import Params, dense_init, swiglu_apply, swiglu_init


def moe_init(
    gen: torch.Generator,
    d_model: int,
    d_ff_expert: int,
    n_experts: int,
    n_shared: int = 0,
    d_ff_shared: int | None = None,
) -> Params:
    scale = 1.0 / math.sqrt(d_model)

    def normal(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)

    p: Params = {
        "router": dense_init(gen, d_model, n_experts, scale=0.02),
        # stacked expert weights (E, d, ff) / (E, ff, d)
        "w_gate": normal(n_experts, d_model, d_ff_expert) * scale,
        "w_up": normal(n_experts, d_model, d_ff_expert) * scale,
        "w_down": normal(n_experts, d_ff_expert, d_model) * (1.0 / math.sqrt(d_ff_expert)),
    }
    if n_shared:
        p["shared"] = swiglu_init(gen, d_model, (d_ff_shared or d_ff_expert) * n_shared)
    return p


def routing_options(cfg) -> dict:
    """:func:`moe_apply`'s routing keywords for ``cfg``'s published routing
    fields, only those set away from their defaults (none for a config that
    keeps the capacity path)."""
    out = {}
    if not cfg.moe_norm_topk:
        out["norm_topk"] = False
    if cfg.moe_aux_alpha:
        out["aux_alpha"] = cfg.moe_aux_alpha
    if cfg.moe_dropless:
        out["dropless"] = True
    return out


def route(router: Params, xf: torch.Tensor, top_k: int, rows: int, norm_topk: bool = True,
          aux_alpha: float = 0.0):
    """The router on tokens ``xf`` (T, d), ``rows`` sequences of T / rows:
    (weights (T, K) fp32, expert ids (T, K), the balance term or None).
    Softmax over fp32 logits, the top k in descending order (ties to the
    lower index, as ``jax.lax.top_k``), renormalised to sum 1 where
    ``norm_topk``.  The sequence-wise balance term (``aux_alpha``) only
    while autograd records."""
    logits = xf.float() @ router["w"].float()
    probs = torch.softmax(logits, dim=-1)                           # (T, E)
    topk_p, topk_i = torch.topk(probs, top_k, dim=-1, sorted=True)  # (T, K)
    if norm_topk:
        topk_p = topk_p / torch.clamp_min(topk_p.sum(-1, keepdim=True), 1e-9)
    aux = None
    if aux_alpha and torch.is_grad_enabled():
        n_experts = probs.shape[-1]
        per_row = topk_i.reshape(rows, -1)                          # (B, S * K)
        chosen = torch.zeros((rows, n_experts), dtype=torch.float32, device=xf.device)
        chosen.scatter_add_(1, per_row, torch.ones(per_row.shape, device=xf.device))
        f = chosen * (n_experts / per_row.shape[1])
        mean_p = probs.reshape(rows, -1, n_experts).mean(dim=1)     # (B, E)
        aux = (f * mean_p).sum(dim=1).mean() * aux_alpha
    return topk_p, topk_i, aux


class RoutedCounts:
    """Per-expert choices of every dropless routing call, summed on the
    device (a recompute's calls count too): ``counts`` (E,) and ``peak``, the
    sum over calls of a call's busiest expert's choices.  ``None`` until a
    call after :meth:`reset`."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.counts = self.peak = None
        self.calls = 0

    def add(self, counts: torch.Tensor) -> None:
        counts = counts.detach()
        if self.counts is None or self.counts.shape != counts.shape:
            self.counts = torch.zeros_like(counts)
            self.peak = torch.zeros((), dtype=counts.dtype, device=counts.device)
            self.calls = 0
        self.counts += counts
        self.peak += counts.max()
        self.calls += 1


#: the dropless path's routed choices, per expert (read by profiling tools)
ROUTED = RoutedCounts()


class AuxLosses:
    """The balance terms whose gradient a backward took, one a layer a step
    (a remat recompute adds none), while :meth:`collect` is open."""

    def __init__(self):
        self.values: list[torch.Tensor] | None = None

    @contextlib.contextmanager
    def collect(self):
        self.values = []
        try:
            yield self.values
        finally:
            self.values = None


AUX = AuxLosses()


class _AddAux(torch.autograd.Function):
    """``out`` unchanged; the balance term ``aux`` gets a gradient of 1
    (DeepSeek's ``AddAuxiliaryLoss``), and its value goes to ``AUX``."""

    @staticmethod
    def forward(ctx, out, aux):
        ctx.aux = aux.detach()
        return out.view_as(out)

    @staticmethod
    def backward(ctx, grad):
        if AUX.values is not None:
            AUX.values.append(ctx.aux)
        return grad, torch.ones_like(ctx.aux)


def _grouped(a: torch.Tensor, b: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """``torch._grouped_mm`` over the groups that end at ``ends``."""
    return torch._grouped_mm(a, b, offs=ends)


class _GroupedExperts(torch.autograd.Function):
    """The routed experts' SwiGLU on the choices sorted by expert: ``xs``
    (N, d) bf16, expert e's rows ending at ``ends[e]`` (int32, on the
    device), weights (E, d, ff), (E, d, ff), (E, ff, d) cast to bf16 at
    use; three grouped products forward, six backward, each over every
    expert at once.  Returns (N, d) bf16 in ``xs``'s order; the weights'
    gradients come back in their own dtype."""

    @staticmethod
    def forward(ctx, xs, ends, w_gate, w_up, w_down):
        bf16 = torch.bfloat16
        wg, wu, wd = w_gate.to(bf16), w_up.to(bf16), w_down.to(bf16)
        g = _grouped(xs, wg, ends)
        u = _grouped(xs, wu, ends)
        y = _grouped(F.silu(g) * u, wd, ends)
        ctx.save_for_backward(xs, ends, wg, wu, wd, g, u)
        ctx.dtypes = (w_gate.dtype, w_up.dtype, w_down.dtype)
        return y

    @staticmethod
    def backward(ctx, dy):
        xs, ends, wg, wu, wd, g, u = ctx.saved_tensors
        dy = dy.contiguous()
        g32 = g.float()
        sig = torch.sigmoid(g32)
        silu = g32 * sig
        h = (silu * u.float()).to(xs.dtype)
        dh = _grouped(dy, wd.transpose(1, 2), ends).float()       # (N, ff)
        dg = (dh * u.float() * sig * (1 + g32 * (1 - sig))).to(xs.dtype)
        du = (dh * silu).to(xs.dtype)
        dxs = _grouped(dg, wg.transpose(1, 2), ends) + _grouped(du, wu.transpose(1, 2), ends)
        dwg = _grouped(xs.t(), dg, ends)                          # (E, d, ff)
        dwu = _grouped(xs.t(), du, ends)
        dwd = _grouped(h.t(), dy, ends)                           # (E, ff, d)
        tg, tu, td = ctx.dtypes
        return dxs, None, dwg.to(tg), dwu.to(tu), dwd.to(td)


def _dropless(p: Params, xf: torch.Tensor, topk_p: torch.Tensor,
              topk_i: torch.Tensor) -> torch.Tensor:
    """Every (token, choice) through its expert: the T * K choices sorted
    by expert (stable), one :class:`_GroupedExperts` call, the results put
    back in choice order and summed per token with the weights in fp32, as
    DeepSeek's training forward combines them.  Returns (T, d) bf16."""
    t, top_k = topk_i.shape
    n_experts = p["w_gate"].shape[0]
    sorted_e, order = torch.sort(topk_i.reshape(-1), stable=True)
    ends = torch.searchsorted(sorted_e, torch.arange(n_experts, device=xf.device), right=True)
    ROUTED.add(torch.diff(ends, prepend=ends.new_zeros(1)))
    xs = xf.to(torch.bfloat16)[order // top_k]
    y = _GroupedExperts.apply(xs, ends.to(torch.int32), p["w_gate"], p["w_up"], p["w_down"])
    back = torch.empty_like(order)
    back[order] = torch.arange(order.numel(), device=xf.device)
    per_choice = y[back].reshape(t, top_k, -1).float()
    return (per_choice * topk_p[..., None]).sum(dim=1).to(torch.bfloat16)


def moe_apply(
    p: Params,
    x: torch.Tensor,                # (B, S, d)
    n_experts: int,
    top_k: int,
    capacity_factor: float = 1.25,
    dense_fallback: bool = False,
    *,
    norm_topk: bool = True,
    aux_alpha: float = 0.0,
    dropless: bool = False,
) -> torch.Tensor:
    b, s, d = x.shape
    t = b * s
    bf16 = torch.bfloat16
    xf = x.reshape(t, d)
    topk_p, topk_i, aux = route(p["router"], xf, top_k, b, norm_topk, aux_alpha)

    if dense_fallback:
        # weight every expert densely (exact modulo capacity dropping);
        # O(E/topk) more FLOPs — decode's path (one token a row)
        weights = torch.zeros((t, n_experts), dtype=torch.float32, device=x.device)
        weights.scatter_add_(1, topk_i, topk_p)
        h = torch.einsum("td,edf->tef", xf.to(bf16), p["w_gate"].to(bf16))
        u = torch.einsum("td,edf->tef", xf.to(bf16), p["w_up"].to(bf16))
        y = torch.einsum("tef,efd->ted", F.silu(h) * u, p["w_down"].to(bf16))
        out = torch.einsum("ted,te->td", y, weights.to(bf16))
    elif dropless:
        out = _dropless(p, xf, topk_p, topk_i)
    else:
        # per-row (per-example) dispatch: routing, ranking and the capacity
        # buffer are computed independently per batch row (GShard-style
        # per-group capacity; group = one sequence)
        L = s * top_k
        capacity = max(1, int(s * top_k / n_experts * capacity_factor))
        p_row = topk_p.reshape(b, L)                                # (B, L)
        e_row = topk_i.reshape(b, L)                                # (B, L)
        order = torch.argsort(e_row, dim=1, stable=True)            # per-row sort
        sorted_e = torch.gather(e_row, 1, order)
        counts = F.one_hot(e_row, n_experts).sum(dim=1)             # (B, E)
        starts = torch.cumsum(counts, dim=1) - counts               # (B, E)
        ranks_sorted = (torch.arange(L, device=x.device)[None, :]
                        - torch.gather(starts, 1, sorted_e))
        pos = torch.zeros((b, L), dtype=torch.int64, device=x.device)
        pos.scatter_(1, order, ranks_sorted)
        keep = pos < capacity
        slot = e_row * capacity + torch.where(keep, pos, 0)        # (B, L)
        x_rows = x.reshape(b, s, 1, d).expand(b, s, top_k, d).reshape(b, L, d).to(bf16)
        contrib = torch.where(keep[..., None], x_rows, 0)
        # every kept slot receives exactly one contribution and a dropped
        # choice adds an exact 0 at e * capacity, so the accumulating scatter
        # gives the reference's bytes in any order
        b_ix = torch.arange(b, device=x.device)[:, None].expand(b, L)
        buffer = torch.zeros((b, n_experts * capacity, d), dtype=bf16, device=x.device)
        buffer.index_put_((b_ix, slot), contrib, accumulate=True)
        buffer = buffer.reshape(b, n_experts, capacity, d)
        g = torch.einsum("becd,edf->becf", buffer, p["w_gate"].to(bf16))
        u = torch.einsum("becd,edf->becf", buffer, p["w_up"].to(bf16))
        y = torch.einsum("becf,efd->becd", F.silu(g) * u, p["w_down"].to(bf16))
        y_flat = y.reshape(b, n_experts * capacity, d)
        gathered = torch.gather(y_flat, 1, slot[..., None].expand(b, L, d))
        per_choice = gathered * (keep[..., None] * p_row[..., None]).to(bf16)
        out = per_choice.reshape(b, s, top_k, d).sum(dim=2).reshape(t, d)

    if aux is not None:
        out = _AddAux.apply(out, aux)
    if "shared" in p:
        out = out + swiglu_apply(p["shared"], xf)
    return out.reshape(b, s, d).to(x.dtype)


def moe_ep_apply(
    p: Params,
    x: torch.Tensor,                # (B_local, S_local, d): B over data, S over model
    n_experts: int,
    top_k: int,
    capacity_factor: float,
    mesh,
    data_axes: tuple[str, ...],
    model_axis: str,
    **routing,
) -> torch.Tensor:
    """Expert parallelism as explicit collectives (the reference's
    ``shard_map`` body, on this rank's shards).

    ``x`` is this rank's block of the tokens; ``p``'s routed leaves are this
    rank's shards as the reference's in_specs place them: the router
    ``P(data, None)``, ``w_gate``/``w_up`` ``P(model, data, None)``, ``w_down``
    ``P(model, None, data)`` (E over model: ``E / tp`` experts a rank); the
    shared expert, if any, whole.  Each rank all-gathers its experts' shards
    over the data axes, routes its own tokens with capacity
    ``ceil(t * k / E * capacity_factor)`` (t = its tokens), sends each
    expert's buffer to its owner over the model axis, runs its experts and
    sends the results back.  Differentiable: a gather's backward
    reduce-scatters, an all-to-all's is the reverse all-to-all, and the
    router's gradient, used whole on every model rank, is summed over them.
    The capacity path only: any of :func:`moe_apply`'s published-routing
    keywords (``routing``) raises.
    """
    from repro_torch.parallel import spmd

    if routing:
        raise NotImplementedError(
            "moe_ep_apply routes with capacity and normalised top-k only; set on this config: "
            + ", ".join(f"ModelConfig.moe_{name}" for name in sorted(routing)))

    if tuple(data_axes) not in (("data",), spmd.POD_DATA):
        raise NotImplementedError(f"data axes {data_axes}")
    data = spmd.data_axis(mesh, token=True)
    model = spmd.mesh_axis(mesh, model_axis, token=True)
    tp = model.size
    e_loc = n_experts // tp
    assert e_loc * tp == n_experts
    rw = spmd.gather(spmd.sum_grad(p["router"]["w"], model), 0, data)
    wg = spmd.gather(p["w_gate"], 1, data)
    wu = spmd.gather(p["w_up"], 1, data)
    wd = spmd.gather(p["w_down"], 2, data)
    bf16 = torch.bfloat16
    bl, sl, d = x.shape
    t = bl * sl
    xf = x.reshape(t, d)
    logits = xf.float() @ rw.float()
    probs = torch.softmax(logits, dim=-1)
    topk_p, topk_i = torch.topk(probs, top_k, dim=-1, sorted=True)
    topk_p = topk_p / torch.clamp_min(topk_p.sum(-1, keepdim=True), 1e-9)
    L = t * top_k
    cap = max(1, int(math.ceil(t * top_k / n_experts * capacity_factor)))
    flat_e = topk_i.reshape(L)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = F.one_hot(flat_e, n_experts).sum(dim=0)             # shape-static bincount
    starts = torch.cumsum(counts, dim=0) - counts
    ranks_sorted = torch.arange(L, device=x.device) - starts[sorted_e]
    pos = torch.empty_like(flat_e).scatter_(0, order, ranks_sorted)
    keep = pos < cap
    slot = flat_e * cap + torch.where(keep, pos, 0)
    tok_of = torch.arange(L, device=x.device) // top_k
    contrib = torch.where(keep[:, None], xf[tok_of].to(bf16), 0)
    # every kept slot takes one contribution and a dropped one adds an exact 0
    buffer = torch.zeros((n_experts * cap, d), dtype=bf16, device=x.device).index_add(
        0, slot, contrib)
    # -> expert owners: (tp, e_loc * cap, d) blocks, one per peer
    recv = spmd.all_to_all(buffer, model.group)
    h = recv.reshape(tp, e_loc, cap, d).transpose(0, 1).reshape(e_loc, tp * cap, d)
    g = torch.einsum("ecd,edf->ecf", h, wg.to(bf16))
    u = torch.einsum("ecd,edf->ecf", h, wu.to(bf16))
    y = torch.einsum("ecf,efd->ecd", F.silu(g) * u, wd.to(bf16))
    back = y.reshape(e_loc, tp, cap, d).transpose(0, 1).reshape(tp * e_loc * cap, d)
    y_home = spmd.all_to_all(back, model.group)
    per_choice = y_home[slot] * (keep[:, None] * topk_p.reshape(L)[:, None]).to(bf16)
    out = torch.zeros((t, d), dtype=bf16, device=x.device).index_add(0, tok_of, per_choice)
    out = out.reshape(bl, sl, d).to(x.dtype)
    if "shared" in p:
        out = out + swiglu_apply(p["shared"], xf).reshape(bl, sl, d).to(x.dtype)
    return out


def moe_flops_per_token(
    d_model: int, d_ff_expert: int, top_k: int, n_shared: int = 0,
    d_ff_shared: int | None = None,
) -> int:
    """Active-parameter matmul FLOPs per token (fwd), for 6*N_active*D."""
    routed = top_k * 3 * 2 * d_model * d_ff_expert
    shared = n_shared * 3 * 2 * d_model * (d_ff_shared or d_ff_expert)
    return routed + shared
