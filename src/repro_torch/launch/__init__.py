"""Launchers of the port: ``python -m repro_torch.launch.train``,
``python -m repro_torch.launch.serve`` and the dry-run,
``python -m repro_torch.launch.dryrun``; the step functions they and the
smoke run build, the cells' input shapes and shardings, in
:mod:`repro_torch.launch.steps`; the meshes in :mod:`repro_torch.launch.mesh`;
a step's roofline terms, counted by running it, in
:mod:`repro_torch.launch.roofline`."""

from repro_torch.launch.dryrun import run_cell
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
from repro_torch.launch.roofline import Roofline, analyze_step, model_flops_for_cell
from repro_torch.launch.steps import (
    batch_shardings,
    batch_struct,
    cache_struct,
    input_specs,
    loss_and_grads,
    make_prefill_step,
    make_serve_step,
    make_step,
    make_train_step,
    model_constraints,
    opt_state_struct,
    params_struct,
    sharded_loss_and_grads,
    step_shardings,
)

__all__ = [
    "Roofline",
    "analyze_step",
    "batch_shardings",
    "batch_struct",
    "cache_struct",
    "input_specs",
    "loss_and_grads",
    "make_debug_mesh",
    "make_prefill_step",
    "make_production_mesh",
    "make_serve_step",
    "make_step",
    "make_train_step",
    "model_constraints",
    "model_flops_for_cell",
    "opt_state_struct",
    "params_struct",
    "run_cell",
    "sharded_loss_and_grads",
    "step_shardings",
]
