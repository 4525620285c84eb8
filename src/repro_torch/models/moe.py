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

NemotronH as published (``modeling_nemotron_h.py``'s ``NemotronHTopkRouter``
and ``NemotronHMoE``) takes four more keywords, each with a default that
leaves the calls above as they were, and each only on the dropless path:
``score`` "sigmoid" scores the experts by the sigmoid of the fp32 logits,
chooses the top k by score plus the router's correction bias (the
params' ``score_bias``, held fixed: ``models.layers.BUFFERS``) and weights
each choice by its score; ``scaling`` multiplies the weights (after the
renormalisation); ``act`` "relu2" makes every expert, routed and shared,
down(relu(up(x))^2), two products where SwiGLU has three; and
``expert_first`` places the share of the experts that expert parallelism
gives one device, where the router scores more experts than the params
hold: the params hold experts [``expert_first``, ``expert_first`` +
held), and the layer returns the part of the result that those experts
give, with the shared experts (which every device computes alike) added.
``ROUTED`` then counts the choices of all the router's experts.

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

from repro_torch.models.layers import (
    Params,
    dense_init,
    relu2_mlp_apply,
    relu2_mlp_init,
    swiglu_apply,
    swiglu_init,
)


def moe_init(
    gen: torch.Generator,
    d_model: int,
    d_ff_expert: int,
    n_experts: int,
    n_shared: int = 0,
    d_ff_shared: int | None = None,
    *,
    act: str = "swiglu",
    router_experts: int = 0,
    score: str = "softmax",
) -> Params:
    """A MoE layer's params: ``n_experts`` held experts (of
    ``router_experts`` routed, where set), SwiGLU or relu^2 (``act``: no
    ``w_gate``), the shared experts as one MLP of ``n_shared`` times
    ``d_ff_shared``, and for ``score`` "sigmoid" the router's correction
    bias."""
    scale = 1.0 / math.sqrt(d_model)

    def normal(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)

    p: Params = {"router": dense_init(gen, d_model, router_experts or n_experts, scale=0.02)}
    # stacked expert weights (E, d, ff) / (E, ff, d)
    if act == "swiglu":
        p["w_gate"] = normal(n_experts, d_model, d_ff_expert) * scale
    p["w_up"] = normal(n_experts, d_model, d_ff_expert) * scale
    p["w_down"] = normal(n_experts, d_ff_expert, d_model) * (1.0 / math.sqrt(d_ff_expert))
    if n_shared:
        width = (d_ff_shared or d_ff_expert) * n_shared
        p["shared"] = (swiglu_init if act == "swiglu" else relu2_mlp_init)(gen, d_model, width)
    if score == "sigmoid":
        p["score_bias"] = torch.zeros((router_experts or n_experts,), dtype=torch.float32,
                                      device=gen.device)
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
    if cfg.moe_score != "softmax":
        out["score"] = cfg.moe_score
    if cfg.moe_scaling != 1.0:
        out["scaling"] = cfg.moe_scaling
    if cfg.moe_act != "swiglu":
        out["act"] = cfg.moe_act
    if cfg.moe_expert_first:
        out["expert_first"] = cfg.moe_expert_first
    return out


def route(router: Params, xf: torch.Tensor, top_k: int, rows: int, norm_topk: bool = True,
          aux_alpha: float = 0.0, score: str = "softmax", bias: torch.Tensor | None = None,
          scaling: float = 1.0):
    """The router on tokens ``xf`` (T, d), ``rows`` sequences of T / rows:
    (weights (T, K) fp32, expert ids (T, K), the balance term or None).
    Softmax over fp32 logits, the top k in descending order (ties to the
    lower index, as ``jax.lax.top_k``), renormalised to sum 1 where
    ``norm_topk``.  The sequence-wise balance term (``aux_alpha``) only
    while autograd records.

    ``score`` "sigmoid": the sigmoid of the fp32 logits, the top k by score
    plus ``bias`` (the choice alone), each choice weighted by its score,
    renormalised as ``NemotronHTopkRouter`` does (sum plus 1e-20).  Either
    way the weights are multiplied by ``scaling`` last."""
    logits = xf.float() @ router["w"].float()
    if score == "sigmoid":
        if aux_alpha:
            raise NotImplementedError("a balance term on sigmoid scores (ModelConfig.moe_aux_alpha)")
        probs = torch.sigmoid(logits)                               # (T, E)
        choice = probs if bias is None else probs + bias.float()
        topk_i = torch.topk(choice, top_k, dim=-1, sorted=True).indices
        topk_p = probs.gather(-1, topk_i)
        if norm_topk:
            topk_p = topk_p / (topk_p.sum(-1, keepdim=True) + 1e-20)
    else:
        probs = torch.softmax(logits, dim=-1)                           # (T, E)
        topk_p, topk_i = torch.topk(probs, top_k, dim=-1, sorted=True)  # (T, K)
        if norm_topk:
            topk_p = topk_p / torch.clamp_min(topk_p.sum(-1, keepdim=True), 1e-9)
    if scaling != 1.0:
        topk_p = topk_p * scaling
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
    gradients come back in their own dtype.

    ``w_gate`` None: relu^2 experts, down(relu(up(x))^2), two products
    forward and four backward.  ``partial``: rows may follow the last
    group (the choices of experts not held); the products leave those rows
    unwritten, and the Function returns them, and their gradient, as
    zeros."""

    @staticmethod
    def forward(ctx, xs, ends, w_gate, w_up, w_down, partial=False):
        bf16 = torch.bfloat16
        wu, wd = w_up.to(bf16), w_down.to(bf16)
        u = _grouped(xs, wu, ends)
        if w_gate is None:
            g = wg = None
            y = _grouped(F.relu(u.float()).square().to(bf16), wd, ends)
        else:
            wg = w_gate.to(bf16)
            g = _grouped(xs, wg, ends)
            y = _grouped(F.silu(g) * u, wd, ends)
        ctx.partial = partial
        ctx.save_for_backward(xs, ends, wg, wu, wd, g, u)
        ctx.dtypes = (None if w_gate is None else w_gate.dtype, w_up.dtype, w_down.dtype)
        return _rows_held(y, ends) if partial else y

    @staticmethod
    def backward(ctx, dy):
        xs, ends, wg, wu, wd, g, u = ctx.saved_tensors
        dy = dy.contiguous()
        if wg is None:
            return _relu2_backward(ctx, dy, xs, ends, wu, wd, u)
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
        if ctx.partial:
            dxs = _rows_held(dxs, ends)
        return dxs, None, dwg.to(tg), dwu.to(tu), dwd.to(td), None


def _rows_held(y: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """``y`` (N, ...) with its rows from ``ends[-1]`` on set to zero."""
    held = torch.arange(y.shape[0], device=y.device) < ends[-1]
    return torch.where(held[:, None], y, torch.zeros((), dtype=y.dtype, device=y.device))


def _relu2_backward(ctx, dy, xs, ends, wu, wd, u):
    """:class:`_GroupedExperts`' backward for relu^2 experts."""
    r = F.relu(u.float())
    h = r.square().to(xs.dtype)
    dh = _grouped(dy, wd.transpose(1, 2), ends).float()              # (N, ff)
    du = (dh * 2 * r).to(xs.dtype)
    dxs = _grouped(du, wu.transpose(1, 2), ends)
    if ctx.partial:
        dxs = _rows_held(dxs, ends)
    dwu = _grouped(xs.t(), du, ends)                                   # (E, d, ff)
    dwd = _grouped(h.t(), dy, ends)                                    # (E, ff, d)
    _, tu, td = ctx.dtypes
    return dxs, None, None, dwu.to(tu), dwd.to(td), None


def _dropless(p: Params, xf: torch.Tensor, topk_p: torch.Tensor,
              topk_i: torch.Tensor, expert_first: int = 0) -> torch.Tensor:
    """Every (token, choice) through its expert: the T * K choices sorted
    by expert (stable), one :class:`_GroupedExperts` call, the results put
    back in choice order and summed per token with the weights in fp32, as
    DeepSeek's training forward combines them.  Returns (T, d) bf16.

    Where the params hold a share of the router's experts, from
    ``expert_first`` on, a choice of an expert not held sorts after the
    held ones and adds zero."""
    t, top_k = topk_i.shape
    n_experts = p["w_up"].shape[0]
    flat = topk_i.reshape(-1)
    routed = p["router"]["w"].shape[1]
    # a scatter, not bincount, which reads the largest id back to the host
    ROUTED.add(torch.zeros(routed, dtype=torch.int64, device=xf.device).scatter_add_(
        0, flat, torch.ones_like(flat)))
    share = n_experts != routed
    if share:
        local = flat - expert_first
        flat = torch.where((local >= 0) & (local < n_experts), local, n_experts)
    sorted_e, order = torch.sort(flat, stable=True)
    ends = torch.searchsorted(sorted_e, torch.arange(n_experts, device=xf.device), right=True)
    xs = xf.to(torch.bfloat16)[order // top_k]
    y = _GroupedExperts.apply(xs, ends.to(torch.int32), p.get("w_gate"), p["w_up"],
                              p["w_down"], share)
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
    score: str = "softmax",
    scaling: float = 1.0,
    act: str = "swiglu",
    expert_first: int = 0,
) -> torch.Tensor:
    b, s, d = x.shape
    t = b * s
    bf16 = torch.bfloat16
    xf = x.reshape(t, d)
    published = {"score": score != "softmax", "act": act != "swiglu",
                 "router_experts": p["router"]["w"].shape[1] != n_experts}
    if not dropless and any(published.values()):
        raise NotImplementedError(
            "only the dropless path takes " + ", ".join(
                f"ModelConfig.moe_{name}" for name, on in published.items() if on))
    topk_p, topk_i, aux = route(p["router"], xf, top_k, b, norm_topk, aux_alpha, score,
                                p.get("score_bias"), scaling)

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
        out = _dropless(p, xf, topk_p, topk_i, expert_first)
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
        out = out + (swiglu_apply if act == "swiglu" else relu2_mlp_apply)(p["shared"], xf)
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
