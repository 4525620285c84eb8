"""Decoder layers and layer stacks for the dense / MoE / MLA families, and
whisper's encoder and cross-attending decoder layers (PyTorch port of
``repro.models.transformer``).

Layer params are built per layer and stored stacked, with a leading layer
axis, as the reference stores them.  A forward takes each stacked leaf's
layers with one ``unbind(0)`` (:func:`unstack`), whose backward stacks the
layers' gradients into one tensor of the stack's size; indexing ``a[i]``
per layer would allocate a zero tensor of the whole stack in each layer's
backward.  Decode takes single layers as views (:func:`layer`).

``remat`` (the reference's ``jax.checkpoint`` around each layer) runs
each layer under ``torch.utils.checkpoint`` (non-reentrant), which keeps
only the layer's input and recomputes the rest in the backward; it applies
only while autograd records (``torch.is_grad_enabled()``), so serving under
``no_grad`` runs the plain loop.

On a mesh the reference's ``constraint`` (the residual stream's sharding)
carries the sharded step's context: each layer's parameters arrive as
local shards (:meth:`repro_torch.parallel.spmd.StepContext.unstack`) and
are all-gathered inside the layer, under its remat, so the backward
gathers them again instead of keeping every layer's whole weights.  The
layers pass the reference's ``attn_specs`` hints (``q``, ``kv``,
``moe_ep``) to attention and the MoE.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.parallel import spmd
from repro_torch.models.layers import (
    Params,
    gelu_mlp_apply,
    gelu_mlp_init,
    rmsnorm_apply,
    rmsnorm_init,
    swiglu_apply,
    swiglu_init,
    tree_leaves,
    tree_map,
    tree_unflatten,
)


def layer(stacked: Any, i) -> Any:
    """Layer ``i`` of a stacked params or cache tree: views, no copies."""
    return tree_map(lambda a: a[i], stacked)


def unstack(stacked: Any, axes: int = 1) -> list:
    """The layers of a tree stacked on its ``axes`` leading axes, in order:
    one ``unbind`` per leaf (see the module's docstring)."""
    per_leaf = [a.flatten(0, axes - 1).unbind(0) for a in tree_leaves(stacked)]
    return [tree_unflatten(stacked, parts) for parts in zip(*per_leaf)]


def remat_if(remat: bool, fn: Callable) -> Callable:
    """``fn`` under activation checkpointing when ``remat`` is set, autograd
    records and an argument needs a gradient; else ``fn``."""
    if not (remat and torch.is_grad_enabled()):
        return fn

    def checkpointed(*args):
        if not any(isinstance(t, torch.Tensor) and t.requires_grad for t in tree_leaves(args)):
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False)

    return checkpointed


# -- single decoder layer -----------------------------------------------------


def decoder_layer_init(gen: torch.Generator, cfg) -> Params:
    """One pre-norm decoder layer for dense / moe / mla configs."""
    dev = gen.device
    p: Params = {"ln1": rmsnorm_init(cfg.d_model, device=dev),
                 "ln2": rmsnorm_init(cfg.d_model, device=dev)}
    if cfg.mla_kv_lora:
        p["attn"] = attn.mla_init(gen, cfg.d_model, cfg.n_heads, cfg.mla_kv_lora,
                                  cfg.mla_qk_nope, cfg.mla_qk_rope, cfg.mla_v_head,
                                  kv_norm=cfg.mla_kv_norm)
    else:
        p["attn"] = attn.gqa_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                  cfg.head_dim, qkv_bias=cfg.qkv_bias)
    if cfg.moe_experts:
        p["mlp"] = moe_mod.moe_init(gen, cfg.d_model, cfg.moe_d_ff, cfg.moe_experts,
                                    n_shared=cfg.moe_shared, d_ff_shared=cfg.moe_d_ff)
    elif cfg.mlp_kind == "gelu":
        p["mlp"] = gelu_mlp_init(gen, cfg.d_model, cfg.d_ff)
    else:
        p["mlp"] = swiglu_init(gen, cfg.d_model, cfg.d_ff)
    return p


def _mlp_apply(p: Params, h: torch.Tensor, cfg, dense_fallback: bool) -> torch.Tensor:
    if cfg.moe_experts:
        return moe_mod.moe_apply(p["mlp"], h, cfg.moe_experts, cfg.moe_top_k,
                                 capacity_factor=cfg.capacity_factor,
                                 dense_fallback=dense_fallback,
                                 **moe_mod.routing_options(cfg))
    if cfg.mlp_kind == "gelu":
        return gelu_mlp_apply(p["mlp"], h)
    return swiglu_apply(p["mlp"], h)


#: a routed MoE's leaves that ``moe_ep_apply`` takes as shards
EP_LOCAL = ("router", "w_gate", "w_up", "w_down")


def whole_layer(p: Any, resid, keep_local: tuple[str, ...] = ()) -> Any:
    """Parameters all-gathered from their shards on a mesh (as they are on
    one device); ``p["mlp"]``'s ``keep_local`` leaves stay shards."""
    sp = spmd.context(resid)
    if sp is None:
        return p
    if not keep_local:
        return sp.gather(p)
    out = {k: sp.gather(v) for k, v in p.items() if k != "mlp"}
    out["mlp"] = {k: v if k in keep_local else sp.gather(v) for k, v in p["mlp"].items()}
    return out


def decoder_layer_apply(p: Params, x: torch.Tensor, cfg, ep_spec=None, attn_specs=None,
                        resid=None) -> torch.Tensor:
    # ep_spec, the reference's constraint on the dispatch buffer, has no
    # counterpart: on a mesh moe_apply routes whole rows with its experts whole
    attn_specs = attn_specs or {}
    ep_ctx = attn_specs.get("moe_ep") if cfg.moe_experts else None
    p = whole_layer(p, resid, EP_LOCAL if ep_ctx is not None else ())
    specs = {"q_spec": attn_specs.get("q"), "kv_spec": attn_specs.get("kv"), "resid": resid}
    h = rmsnorm_apply(p["ln1"], x, cfg.norm_eps)
    if cfg.mla_kv_lora:
        a = attn.mla_apply(p["attn"], h, cfg.n_heads, cfg.mla_kv_lora, cfg.mla_qk_nope,
                           cfg.mla_qk_rope, cfg.mla_v_head, rope_theta=cfg.rope_theta,
                           block=cfg.attn_block, yarn=cfg.rope_yarn, norm_eps=cfg.norm_eps,
                           **specs)
    else:
        a = attn.gqa_apply(p["attn"], h, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                           rope_theta=cfg.rope_theta, block=cfg.attn_block, **specs)
    x = x + a
    h = rmsnorm_apply(p["ln2"], x, cfg.norm_eps)
    if ep_ctx is not None:
        mesh, data_axes, model_axis = ep_ctx
        return x + moe_mod.moe_ep_apply(p["mlp"], h, cfg.moe_experts, cfg.moe_top_k,
                                        cfg.capacity_factor, mesh, data_axes, model_axis,
                                        **moe_mod.routing_options(cfg))
    sp = spmd.context(resid)
    if cfg.moe_experts and sp is not None:
        # per-row routing ranks a row's tokens together: route whole rows
        return x + sp.whole_sequence(
            lambda hh: _mlp_apply(p, hh, cfg, cfg.moe_dense_fallback), h)
    return x + _mlp_apply(p, h, cfg, cfg.moe_dense_fallback)


def decoder_layer_decode(
    p: Params, x: torch.Tensor, cache_layer, cur_len, cfg, resid=None
) -> tuple[torch.Tensor, Any]:
    """One token through one layer; the layer's cache is written in place.
    On a mesh (``resid``: the sharded decode's batch sharding) the layer's
    weights arrive as shards and are gathered whole here, and the cache is
    this rank's shard; a MoE layer's experts are gathered whole too (the
    dense combine, as the reference passes decode no expert hint)."""
    p = whole_layer(p, resid)
    h = rmsnorm_apply(p["ln1"], x, cfg.norm_eps)
    if cfg.mla_kv_lora:
        a, c_c, c_kr = attn.mla_decode(
            p["attn"], h, cache_layer["c"], cache_layer["kr"], cur_len, cfg.n_heads,
            cfg.mla_kv_lora, cfg.mla_qk_nope, cfg.mla_qk_rope, cfg.mla_v_head,
            rope_theta=cfg.rope_theta, resid=resid, yarn=cfg.rope_yarn, norm_eps=cfg.norm_eps)
        new_cache = {"c": c_c, "kr": c_kr}
    else:
        a, ck, cv = attn.gqa_decode(
            p["attn"], h, cache_layer["k"], cache_layer["v"], cur_len, cfg.n_heads,
            cfg.n_kv_heads, cfg.head_dim, rope_theta=cfg.rope_theta, resid=resid)
        new_cache = {"k": ck, "v": cv}
    x = x + a
    h = rmsnorm_apply(p["ln2"], x, cfg.norm_eps)
    # decode: 1 token/row — the dense combine is exact and cheap
    return x + _mlp_apply(p, h, cfg, dense_fallback=True), new_cache


# -- stacks -------------------------------------------------------------------


def stacked_init(gen: torch.Generator, n_layers: int,
                 init_one: Callable[[torch.Generator], Params]) -> Params:
    """``n_layers`` layers from ``init_one``, stacked on a leading axis.

    The stacked tensors are allocated once and filled layer by layer, so
    the peak is the stack plus one layer (a stack of 48 yi-9b layers is
    35 GB in fp32)."""
    first = init_one(gen)
    out = tree_map(lambda a: torch.empty((n_layers, *a.shape), dtype=a.dtype,
                                         device=a.device), first)

    def fill(i, one):
        for dst, src in zip(tree_leaves(out), tree_leaves(one)):
            dst[i].copy_(src)

    fill(0, first)
    del first
    for i in range(1, n_layers):
        fill(i, init_one(gen))
    return out


def scan_stack(
    layer_params: Params,
    x: torch.Tensor,
    apply_one: Callable[[Params, torch.Tensor], torch.Tensor],
    remat: bool = False,
    constraint=None,
) -> torch.Tensor:
    """``apply_one`` over the leading layer axis of ``layer_params``, each
    layer under :func:`remat_if`.  On a mesh (``constraint``, the residual
    stream's sharding) the layers are shards, which ``apply_one`` gathers."""
    f = remat_if(remat, apply_one)
    for lp in unstack_on(layer_params, constraint):
        x = f(lp, x)
    return x


def unstack_on(stacked: Any, resid, axes: int = 1) -> list:
    """:func:`unstack`, or on a mesh the sharded step's (each layer's shards
    bound for its gather)."""
    sp = spmd.context(resid)
    return unstack(stacked, axes) if sp is None else sp.unstack(stacked, axes)


def scan_stack_decode(
    layer_params: Params,
    x: torch.Tensor,
    cache: Any,                    # tree with leading layer axis, written in place
    cur_len,
    apply_one: Callable,           # (lp, x, cache_layer, cur_len) -> (x, cache')
    constraint=None,
) -> tuple[torch.Tensor, Any]:
    """``apply_one`` over the layers; on a mesh (``constraint``) the layers
    are shards, which ``apply_one`` gathers, and the cache's layers views
    of this rank's cache shards."""
    for i, lp in enumerate(unstack_on(layer_params, constraint)):
        x, _ = apply_one(lp, x, layer(cache, i), cur_len)
    return x, cache


# -- encoder layer (whisper) --------------------------------------------------


def encoder_layer_init(gen: torch.Generator, cfg) -> Params:
    dev = gen.device
    return {
        "ln1": rmsnorm_init(cfg.d_model, device=dev),
        "ln2": rmsnorm_init(cfg.d_model, device=dev),
        "attn": attn.gqa_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim),
        "mlp": gelu_mlp_init(gen, cfg.d_model, cfg.d_ff),
    }


def encoder_layer_apply(p: Params, x: torch.Tensor, cfg, attn_specs=None,
                        resid=None) -> torch.Tensor:
    attn_specs = attn_specs or {}
    p = whole_layer(p, resid)
    h = rmsnorm_apply(p["ln1"], x, cfg.norm_eps)
    a = attn.gqa_apply(p["attn"], h, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                       rope_theta=0.0, causal=False, block=cfg.attn_block,
                       q_spec=attn_specs.get("q"), kv_spec=attn_specs.get("kv"), resid=resid)
    x = x + a
    h = rmsnorm_apply(p["ln2"], x, cfg.norm_eps)
    return x + gelu_mlp_apply(p["mlp"], h)


def cross_decoder_layer_init(gen: torch.Generator, cfg) -> Params:
    dev = gen.device
    return {
        "ln1": rmsnorm_init(cfg.d_model, device=dev),
        "ln2": rmsnorm_init(cfg.d_model, device=dev),
        "ln3": rmsnorm_init(cfg.d_model, device=dev),
        "self": attn.gqa_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim),
        "cross": attn.gqa_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim),
        "mlp": gelu_mlp_init(gen, cfg.d_model, cfg.d_ff),
    }


def cross_decoder_layer_apply(
    p: Params, x: torch.Tensor, enc_out: torch.Tensor, cfg, attn_specs=None, resid=None
) -> torch.Tensor:
    attn_specs = attn_specs or {}
    p = whole_layer(p, resid)
    specs = {"q_spec": attn_specs.get("q"), "kv_spec": attn_specs.get("kv"), "resid": resid}
    h = rmsnorm_apply(p["ln1"], x, cfg.norm_eps)
    x = x + attn.gqa_apply(p["self"], h, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                           rope_theta=cfg.rope_theta, block=cfg.attn_block, **specs)
    h = rmsnorm_apply(p["ln2"], x, cfg.norm_eps)
    x = x + attn.gqa_apply(p["cross"], h, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                           rope_theta=0.0, causal=False, block=cfg.attn_block, kv_in=enc_out,
                           **specs)
    h = rmsnorm_apply(p["ln3"], x, cfg.norm_eps)
    return x + gelu_mlp_apply(p["mlp"], h)
