"""Train / prefill / serve steps, the input batch's shapes and the cells'
shardings (PyTorch port of ``repro.launch.steps``):

  train_step(params, opt_state, batch)  -> (params', opt_state', metrics)
  prefill_step(params, batch)           -> last-position logits
  serve_step(params, cache, batch)      -> (next-token logits, cache')

The train step differentiates ``loss_fn`` with ``torch.autograd.grad``
(``cfg.remat`` as the model applies it; a MoE's balance term, where
``cfg.moe_aux_alpha`` sets one, joins the gradient inside the layer and is
reported as ``aux_loss``, the sum over layers, beside the CE ``loss``),
scales the learning rate by
``warmup_cosine`` of the optimizer's step with its defaults (0 at step 0,
as in the reference) and updates params and moments in place
(:func:`repro_torch.optim.adamw.adamw_update`).  Prefill and serve run under
``no_grad``: on the card a prefill's self-attention takes the flash kernel.

``mesh`` is None (one device) or a (data, model) or (pod, data, model)
``DeviceMesh``.  On a mesh the steps take params and moments as DTensors
placed by the rules (:func:`repro_torch.parallel.sharding.distribute_tree`)
and the batch as DTensors placed by :func:`batch_shardings` (or whole on
every rank), compute on the local shards with the model's explicit
collectives (:mod:`repro_torch.parallel.spmd`, under
:func:`model_constraints`), and update every shard in place, so each leaf
keeps its placement.  The serve step takes the cache as DTensors placed by
:func:`step_shardings`' decode branch (``cache_specs``: batch over data,
the model axis on the head vector or a state's last dim), writes each
rank's shard in place and attends it where it lies; it returns the whole
batch's logits and the cache.

``params_struct``, ``opt_state_struct``, ``cache_struct`` and
``batch_struct`` are trees of ``meta`` tensors (shapes and dtypes, no
allocation); ``input_specs``, ``model_constraints`` and ``step_shardings``
give the reference's specs on any mesh, an
:class:`~repro_torch.parallel.sharding.AbstractMesh` included.
"""

from __future__ import annotations

import os
from typing import Any

import torch

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig
from repro_torch.models import model as M
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import tree_leaves, tree_map, tree_unflatten
from repro_torch.optim.adamw import AdamWConfig, adamw_update, init_opt_state
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.sharding import P


def _sharded(mesh) -> bool:
    """Whether a step runs on a mesh: None is one device; a ``DeviceMesh``
    (one of one rank included) runs sharded; a mesh with no process group
    serves the rules only."""
    if mesh is None:
        return False
    if not hasattr(mesh, "get_group"):
        raise TypeError(f"{mesh!r} has no process group: pass a DeviceMesh "
                        "(launch.mesh.make_debug_mesh) or None")
    if tuple(mesh.mesh_dim_names or ()) not in (("data", "model"), ("pod", "data", "model")):
        raise NotImplementedError(
            f"the sharded steps take a ('data', 'model') or ('pod', 'data', 'model') "
            f"DeviceMesh, got axes {mesh.mesh_dim_names}")
    return True


def batch_struct(arch: ArchConfig, shape: ShapeConfig) -> dict[str, torch.Tensor]:
    """The input batch of one cell as tensors on the ``meta`` device: shapes
    and dtypes, no allocation."""
    cfg = arch.model
    gb, s = shape.global_batch, shape.seq_len

    def struct(*dims, dtype=torch.int32):
        return torch.empty(dims, dtype=dtype, device="meta")

    if shape.kind in ("train", "prefill"):
        out: dict[str, torch.Tensor] = {}
        if cfg.family == "encdec":
            out["frames"] = struct(gb, s, cfg.d_model, dtype=torch.bfloat16)
            text = s
        elif cfg.frontend == "vision_stub":
            out["patch_embeds"] = struct(gb, cfg.frontend_tokens, cfg.d_model,
                                         dtype=torch.bfloat16)
            text = s - cfg.frontend_tokens
        else:
            text = s
        out["tokens"] = struct(gb, text)
        if shape.kind == "train":
            out["labels"] = struct(gb, text)
        return out
    # decode: one new token against a seq_len cache
    return {"tokens": struct(gb, 1), "cur_len": struct()}


def loss_and_grads(params: Any, cfg: M.ModelConfig, batch: dict) -> tuple[torch.Tensor, Any]:
    """``loss_fn``'s value (detached) and its gradient tree, shaped like
    ``params``, whose tensors are left as they are (the gradients are taken
    with respect to detached views of them)."""
    live = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        loss = M.loss_fn(tree_unflatten(params, live), cfg, batch)
        grads = torch.autograd.grad(loss, live, materialize_grads=True)
    return loss.detach(), tree_unflatten(params, grads)


class _MetaGenerator(torch.Generator):
    """A generator whose ``device`` reads ``meta``: the inits then build
    shapes with no numbers (a generator cannot live on ``meta``; the draws
    take a CPU one's state and make ``meta`` tensors)."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def params_struct(arch: ArchConfig) -> Any:
    """``init_params``' tree as ``meta`` tensors."""
    return M.init_params(arch.model, 0, device="meta", generator=_MetaGenerator())


def opt_state_struct(params_s: Any) -> Any:
    return init_opt_state(params_s)


def cache_struct(arch: ArchConfig, shape: ShapeConfig) -> Any:
    return M.init_cache(arch.model, shape.global_batch, shape.seq_len, device="meta")


def _shape_of(shape: str | ShapeConfig) -> ShapeConfig:
    """A cell's shape by its name in ``SHAPES``, or as given."""
    return SHAPES[shape] if isinstance(shape, str) else shape


def input_specs(arch: ArchConfig, shape_name: str | ShapeConfig) -> dict[str, Any]:
    """All inputs of a cell's step as ``meta`` tensors: params (+opt/cache)
    and batch."""
    shape = _shape_of(shape_name)
    ps = params_struct(arch)
    out = {"params": ps, "batch": batch_struct(arch, shape)}
    if shape.kind == "train":
        out["opt_state"] = opt_state_struct(ps)
    if shape.kind == "decode":
        out["cache"] = cache_struct(arch, shape)
    return out


# ---------------------------------------------------------------------------
# sharding plumbing
# ---------------------------------------------------------------------------


def _ns(mesh, spec, ctx=None) -> sh.NamedSharding:
    return sh.NamedSharding(mesh, spec if spec is not None else P(), ctx)


def batch_shardings(arch: ArchConfig, shape: ShapeConfig, mesh) -> dict:
    structs = batch_struct(arch, shape)
    specs = sh.data_batch_specs({k: tuple(v.shape) for k, v in structs.items()}, mesh)
    return {k: _ns(mesh, specs[k]) for k in structs}


def model_constraints(arch: ArchConfig, shape: ShapeConfig, mesh):
    """(resid, ep_spec, attn_specs): the reference's forward-pass constraints
    as :class:`~repro_torch.parallel.sharding.NamedSharding` s, with the
    reference's rules and switches (``REPRO_NO_ATTN_SPECS``,
    ``REPRO_NO_MOE_EP``).  On a ``DeviceMesh`` they carry the step context
    whose collectives the model runs; ``attn_specs["moe_ep"]`` is
    ``(mesh, data axes, model axis)`` as in the reference."""
    cfg = arch.model
    ax = sh.MeshAxes.for_mesh(mesh)
    tp = sh.mesh_shape(mesh)[ax.model]
    resid_spec = sh.residual_spec(shape.global_batch, shape.seq_len, mesh)
    ctx = None
    if hasattr(mesh, "get_group"):
        from repro_torch.parallel.spmd import StepContext

        ctx = StepContext(mesh, batch_split=resid_spec[0] is not None,
                          seq_split=resid_spec[1] is not None)
    resid = _ns(mesh, resid_spec, ctx)
    ep = None
    if cfg.moe_experts:
        spec = sh.moe_buffer_spec(cfg.moe_experts, mesh, shape.global_batch)
        ep = _ns(mesh, spec, ctx) if spec is not None else None
    # Context-parallel attention: q stays sequence-sharded and the
    # un-repeated KV heads are gathered whole over model.
    attn = None
    bspec = sh.batch_dim_spec(shape.global_batch, mesh, ax)
    if os.environ.get("REPRO_NO_ATTN_SPECS") == "1":
        return resid, ep, None
    if shape.seq_len % tp == 0:
        attn = {"q": _ns(mesh, P(bspec, ax.model, None, None), ctx),
                "kv": _ns(mesh, P(bspec, None, None, None), ctx)}
    if cfg.family == "hybrid" and cfg.n_ssm_heads % tp == 0:
        attn = attn or {}
        # mamba2: the SSM head axis over model, so the chunk scan is local
        attn["ssm_h"] = _ns(mesh, P(bspec, None, ax.model, None), ctx)
    if (
        cfg.moe_experts
        and shape.kind in ("train", "prefill")
        and os.environ.get("REPRO_NO_MOE_EP") != "1"
        and cfg.moe_experts % tp == 0
        and shape.seq_len % tp == 0
        and bspec is not None
        and cfg.d_model % sh.axis_size(mesh, ax.data) == 0
    ):
        attn = attn or {}
        # explicit expert-parallel dataflow (all-to-all dispatch)
        attn["moe_ep"] = (mesh, ax.data, ax.model)
    return resid, ep, attn


def step_shardings(arch: ArchConfig, shape_name: str | ShapeConfig, mesh):
    """(in_shardings, out_shardings) trees for the cell's step function."""
    shape = _shape_of(shape_name)
    ps = params_struct(arch)
    p_shard = sh.param_shardings(ps, mesh)
    b_shard = batch_shardings(arch, shape, mesh)
    repl = _ns(mesh, P())
    if shape.kind == "train":
        opt_shard = {"m": p_shard, "v": p_shard, "step": repl}
        metrics_shard = {"loss": repl, "grad_norm": repl, "lr": repl}
        return (p_shard, opt_shard, b_shard), (p_shard, opt_shard, metrics_shard)
    if shape.kind == "prefill":
        return (p_shard, b_shard), repl
    c_specs = sh.cache_specs(cache_struct(arch, shape), mesh, shape.seq_len, shape.global_batch)
    c_shard = sh.spec_map(lambda spec: _ns(mesh, spec), c_specs)
    logits_shard = _ns(mesh, P(sh.batch_dim_spec(shape.global_batch, mesh,
                                                 sh.MeshAxes.for_mesh(mesh)), None, None))
    return (p_shard, c_shard, b_shard), (logits_shard, c_shard)


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------


def _local(t):
    """A DTensor's local shard (its storage: in-place updates reach the
    DTensor), or the tensor itself."""
    return t.to_local() if hasattr(t, "to_local") else t


def _local_batch(batch: dict, shardings: dict, ctx) -> dict:
    """This rank's rows of each batch entry: a DTensor's local shard, or a
    whole tensor cut as its sharding places it (over the step context's
    data axis)."""
    out = {}
    data = ctx.axes["data"]
    for key, value in batch.items():
        if hasattr(value, "to_local"):
            out[key] = value.to_local()
            continue
        spec = shardings[key].spec
        if len(spec) and spec[0] is not None:
            value = value.chunk(data.size, 0)[data.rank]
        out[key] = value
    return out


def sharded_loss_and_grads(params: Any, cfg: M.ModelConfig, batch: dict, specs: Any,
                           constraints) -> tuple[torch.Tensor, Any]:
    """:func:`loss_and_grads` on a mesh: ``params`` are local shards (with
    their ``specs``), ``batch`` this rank's rows, ``constraints``
    :func:`model_constraints`' triple.  Returns the loss summed over the
    ranks (the whole batch's mean) and the gradient shards, each on its
    parameter's placement and contiguous, as AdamW's kernel takes them (a
    reduce-scatter along a dim other than 0 gives a permuted layout)."""
    resid, ep, attn = constraints
    ctx = resid.ctx
    live = [p.detach().requires_grad_() for p in tree_leaves(params)]
    tree = tree_unflatten(params, live)
    with ctx.bind(tree, specs), torch.enable_grad():
        share = M.loss_fn(tree, cfg, batch, ep_spec=ep, resid=resid, attn_specs=attn)
        grads = torch.autograd.grad(share, live, materialize_grads=True)
    return ctx.sum_over_tokens(share), tree_unflatten(params, [g.contiguous() for g in grads])


def make_train_step(
    arch: ArchConfig,
    shape: ShapeConfig,
    mesh=None,
    adam: AdamWConfig | None = None,
):
    cfg = arch.model
    adam = adam or AdamWConfig()
    if _sharded(mesh):
        return _sharded_train_step(arch, shape, mesh, adam)

    def train_step(params, opt_state, batch):
        with moe_mod.AUX.collect() as aux:
            loss, grads = loss_and_grads(params, cfg, batch)
        lr_scale = warmup_cosine(opt_state["step"])
        new_params, new_opt, metrics = adamw_update(params, grads, opt_state, adam, lr_scale)
        metrics["loss"] = loss
        if cfg.moe_aux_alpha:
            metrics["aux_loss"] = torch.stack(aux).sum()
        return new_params, new_opt, metrics

    return train_step


def _sharded_train_step(arch: ArchConfig, shape: ShapeConfig, mesh, adam: AdamWConfig):
    cfg = arch.model
    if cfg.moe_aux_alpha:
        raise NotImplementedError("the sharded train step takes no MoE balance term "
                                  "(ModelConfig.moe_aux_alpha)")
    constraints = model_constraints(arch, shape, mesh)
    ctx = constraints[0].ctx
    b_shard = batch_shardings(arch, shape, mesh)

    def train_step(params, opt_state, batch):
        specs = sh.param_specs(params, mesh)
        local = tree_map(_local, params)
        loss, grads = sharded_loss_and_grads(local, cfg, _local_batch(batch, b_shard, ctx),
                                             specs, constraints)
        gnorm = ctx.global_norm(grads, specs)
        lr_scale = warmup_cosine(opt_state["step"])
        local_opt = {"m": tree_map(_local, opt_state["m"]), "v": tree_map(_local, opt_state["v"]),
                     "step": opt_state["step"]}
        _, new_opt, metrics = adamw_update(local, grads, local_opt, adam, lr_scale,
                                           grad_norm=gnorm)
        metrics["loss"] = loss
        return params, {"m": opt_state["m"], "v": opt_state["v"], "step": new_opt["step"]}, \
            metrics

    return train_step


def make_prefill_step(arch: ArchConfig, shape: ShapeConfig, mesh=None):
    cfg = arch.model
    if _sharded(mesh):
        return _sharded_prefill_step(arch, shape, mesh)

    @torch.no_grad()
    def prefill_step(params, batch):
        hidden = M.forward(params, cfg, batch)
        last = hidden[:, -1:, :]
        logits = last.to(torch.bfloat16) @ params["unembed"]["w"].to(torch.bfloat16)
        return logits.float()

    return prefill_step


def _sharded_prefill_step(arch: ArchConfig, shape: ShapeConfig, mesh):
    cfg = arch.model
    resid, ep, attn = model_constraints(arch, shape, mesh)
    ctx = resid.ctx
    b_shard = batch_shardings(arch, shape, mesh)

    @torch.no_grad()
    def prefill_step(params, batch):
        local = tree_map(_local, params)
        with ctx.bind(local, sh.param_specs(params, mesh)):
            hidden = M.forward(local, cfg, _local_batch(batch, b_shard, ctx), ep_spec=ep,
                               resid=resid, attn_specs=attn)
            unembed = ctx.gather(local["unembed"])["w"]
        # the last position lies on the last model rank
        last = ctx.gather_seq(hidden[:, -1:, :])[:, -1:, :]
        logits = (last.to(torch.bfloat16) @ unembed.to(torch.bfloat16)).float()
        return ctx.gather_rows(logits)

    return prefill_step


def make_serve_step(arch: ArchConfig, shape: ShapeConfig, mesh=None):
    cfg = arch.model
    if _sharded(mesh):
        return _sharded_serve_step(arch, shape, mesh)

    @torch.no_grad()
    def serve_step(params, cache, batch):
        return M.decode_step(params, cfg, cache, batch)

    return serve_step


def _check_cache_specs(cfg, shape: ShapeConfig, specs: Any, batch_split: bool) -> None:
    """The decode reads each cache shard's rows as the tokens' rows: a leaf
    whose data axis lies on another dim than its batch (the rules find the
    batch by its size, which a stacked axis may share), or whose batch is
    placed otherwise than the tokens', is refused.  A leaf's batch dim is
    the one that grows with the batch."""
    grown = M.init_cache(cfg, shape.global_batch + 1, shape.seq_len, device="meta")
    struct = M.init_cache(cfg, shape.global_batch, shape.seq_len, device="meta")

    def one(leaf, more, spec):
        batch_dims = [d for d in range(leaf.dim()) if leaf.shape[d] != more.shape[d]]
        data = [d for d, e in enumerate(spec) if e is not None and e != "model"]
        if data != (batch_dims if batch_split else []):
            raise NotImplementedError(
                f"cache leaf {tuple(leaf.shape)} placed {spec}: its data axis is not on "
                f"its batch dim {batch_dims}, as the tokens' rows are split")

    sh.spec_map(one, struct, grown, specs)


def _sharded_serve_step(arch: ArchConfig, shape: ShapeConfig, mesh):
    """The decode on a mesh (the reference passes decode no constraint, so
    the context splits the batch alone): each rank runs ``decode_step`` on
    its rows and cache shards, each layer's weights gathered where it is
    used."""
    from repro_torch.parallel.spmd import StepContext

    cfg = arch.model
    b_shard = batch_shardings(arch, shape, mesh)
    bspec = b_shard["tokens"].spec[0]
    ctx = StepContext(mesh, batch_split=bspec is not None, seq_split=False)
    resid = _ns(mesh, P(bspec, None, None), ctx)
    _check_cache_specs(cfg, shape, sh.cache_specs(cache_struct(arch, shape), mesh,
                                                   shape.seq_len, shape.global_batch),
                       bspec is not None)

    @torch.no_grad()
    def serve_step(params, cache, batch):
        local = tree_map(_local, params)
        if any(leaf.dim() and not hasattr(leaf, "to_local") for leaf in tree_leaves(cache)):
            raise TypeError("the sharded decode writes the cache in place: pass it as "
                            "DTensors placed by step_shardings")
        with ctx.bind(local, sh.param_specs(params, mesh)):
            logits, _ = M.decode_step(local, cfg, tree_map(_local, cache),
                                      _local_batch(batch, b_shard, ctx), resid=resid)
        return ctx.gather_rows(logits), cache

    return serve_step


def make_step(arch: ArchConfig, shape_name: str | ShapeConfig, mesh=None) -> Any:
    """The cell's step function by shape kind."""
    shape = _shape_of(shape_name)
    if shape.kind == "train":
        return make_train_step(arch, shape, mesh)
    if shape.kind == "prefill":
        return make_prefill_step(arch, shape, mesh)
    return make_serve_step(arch, shape, mesh)
