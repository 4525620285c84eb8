"""Train / prefill / serve steps and the input batch's shapes (PyTorch port
of ``repro.launch.steps``):

  train_step(params, opt_state, batch)  -> (params', opt_state', metrics)
  prefill_step(params, batch)           -> last-position logits
  serve_step(params, cache, batch)      -> (next-token logits, cache')

The train step differentiates ``loss_fn`` with ``torch.autograd.grad``
(``cfg.remat`` as the model applies it), scales the learning rate by
``warmup_cosine`` of the optimizer's step with its defaults (0 at step 0,
as in the reference) and updates params and moments in place
(:func:`repro_torch.optim.adamw.adamw_update`).  Prefill and serve run under
``no_grad``: on the card a prefill's self-attention takes the flash kernel.

``mesh`` stays in every signature; this port runs on one device, so it
must be ``None`` or a one-device mesh.  The reference's ``input_specs``,
``params_struct``, ``opt_state_struct``, ``cache_struct``,
``model_constraints``, ``batch_shardings`` and ``step_shardings`` wait for
the sharding and dry-run slices.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig
from repro_torch.models import model as M
from repro_torch.models.layers import tree_leaves, tree_unflatten
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from repro_torch.optim.schedule import warmup_cosine


def _one_device(mesh) -> None:
    if mesh is None or (hasattr(mesh, "size") and mesh.size() == 1):
        return
    raise NotImplementedError(
        "a mesh of more than one device needs the sharding slice of the port "
        "(parallel/sharding on DTensor); pass mesh=None")


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


def make_train_step(
    arch: ArchConfig,
    shape: ShapeConfig,
    mesh=None,
    adam: AdamWConfig | None = None,
):
    _one_device(mesh)
    cfg = arch.model
    adam = adam or AdamWConfig()

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(params, cfg, batch)
        lr_scale = warmup_cosine(opt_state["step"])
        new_params, new_opt, metrics = adamw_update(params, grads, opt_state, adam, lr_scale)
        metrics["loss"] = loss
        return new_params, new_opt, metrics

    return train_step


def make_prefill_step(arch: ArchConfig, shape: ShapeConfig, mesh=None):
    _one_device(mesh)
    cfg = arch.model

    @torch.no_grad()
    def prefill_step(params, batch):
        hidden = M.forward(params, cfg, batch)
        last = hidden[:, -1:, :]
        logits = last.to(torch.bfloat16) @ params["unembed"]["w"].to(torch.bfloat16)
        return logits.float()

    return prefill_step


def make_serve_step(arch: ArchConfig, shape: ShapeConfig, mesh=None):
    _one_device(mesh)
    cfg = arch.model

    @torch.no_grad()
    def serve_step(params, cache, batch):
        return M.decode_step(params, cfg, cache, batch)

    return serve_step


def make_step(arch: ArchConfig, shape_name: str, mesh=None) -> Any:
    """The cell's step function by shape kind."""
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        return make_train_step(arch, shape, mesh)
    if shape.kind == "prefill":
        return make_prefill_step(arch, shape, mesh)
    return make_serve_step(arch, shape, mesh)
