"""Launchers of the port: ``python -m repro_torch.launch.train`` and
``python -m repro_torch.launch.serve``; the step functions they and the
smoke run build are in :mod:`repro_torch.launch.steps`."""

from repro_torch.launch.steps import (
    batch_struct,
    loss_and_grads,
    make_prefill_step,
    make_serve_step,
    make_step,
    make_train_step,
)

__all__ = [
    "batch_struct",
    "loss_and_grads",
    "make_prefill_step",
    "make_serve_step",
    "make_step",
    "make_train_step",
]
