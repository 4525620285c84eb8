"""Mixture-of-Experts layer: top-k routing with capacity-bounded dispatch
(PyTorch port of ``repro.models.moe``).

Dispatch is scatter-based (sort-free ranks via cumulative counts): tokens
are placed into a fixed (B, E, C, d) buffer per batch row, expert FFNs run
as one batched einsum over the expert axis, and results are gathered back
with router weights.  Tokens over capacity are dropped (Switch/GShard
semantics, capacity_factor 1.25 default).  Supports shared experts
(DeepSeek-V2: 2 shared + 64 routed top-6) and pure routed (DBRX: 16 routed
top-4).

On a mesh, :func:`moe_ep_apply` is the reference's expert-parallel
dataflow with its collectives written out (the reference's ``shard_map``
body): per-rank routing, one all-to-all to the expert owners over the
model axis, the local SwiGLU, one all-to-all back.  The reference's
``ep_spec`` (a layout constraint on ``moe_apply``'s dispatch buffer) has
no counterpart: the sharded step runs ``moe_apply`` on whole rows with
its experts gathered.
"""

from __future__ import annotations

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


def moe_apply(
    p: Params,
    x: torch.Tensor,                # (B, S, d)
    n_experts: int,
    top_k: int,
    capacity_factor: float = 1.25,
    dense_fallback: bool = False,
) -> torch.Tensor:
    b, s, d = x.shape
    t = b * s
    bf16 = torch.bfloat16
    xf = x.reshape(t, d)
    logits = xf.float() @ p["router"]["w"].float()
    probs = torch.softmax(logits, dim=-1)                           # (T, E)
    # jax.lax.top_k's order: descending, ties to the lower index
    topk_p, topk_i = torch.topk(probs, top_k, dim=-1, sorted=True)  # (T, K)
    topk_p = topk_p / torch.clamp_min(topk_p.sum(-1, keepdim=True), 1e-9)

    if dense_fallback:
        # weight every expert densely (exact modulo capacity dropping);
        # O(E/topk) more FLOPs — decode's path (one token a row)
        weights = torch.zeros((t, n_experts), dtype=torch.float32, device=x.device)
        weights.scatter_add_(1, topk_i, topk_p)
        h = torch.einsum("td,edf->tef", xf.to(bf16), p["w_gate"].to(bf16))
        u = torch.einsum("td,edf->tef", xf.to(bf16), p["w_up"].to(bf16))
        y = torch.einsum("tef,efd->ted", F.silu(h) * u, p["w_down"].to(bf16))
        out = torch.einsum("ted,te->td", y, weights.to(bf16))
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
    """
    from repro_torch.parallel import spmd

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
