"""Carry params across between ``repro`` (JAX) and ``repro_torch``.

A ``repro`` params pytree after ``jax.device_get`` is a nested dict of
numpy arrays.  :func:`params_from_numpy` turns it into the port's nested
dict of tensors on one device, keeping every name, shape and layout (a
dense ``w`` stays (d_in, d_out)); :func:`params_to_numpy` goes the other
way.  Neither side imports the other package: numpy is the only format
that crosses.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE
from repro_torch.kernels.ops import resolve_device


def _leaf_to_tensor(leaf, device: torch.device) -> torch.Tensor:
    # a copy: jax.device_get hands out read-only arrays, and on the CPU the
    # tensor would share their memory
    arr = np.array(leaf, order="C")
    if arr.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16, as jax.device_get returns it: reinterpret the bits
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def params_from_numpy(tree: dict, device: str | torch.device = DEFAULT_DEVICE) -> dict:
    """Nested dict of numpy arrays -> the same dict of tensors on ``device``."""
    dev = resolve_device(device)

    def convert(node):
        if isinstance(node, dict):
            return {key: convert(value) for key, value in node.items()}
        return _leaf_to_tensor(node, dev)

    return convert(tree)


def params_to_numpy(tree: dict) -> dict:
    """Nested dict of tensors -> the same dict of numpy arrays on the host.

    numpy has no bfloat16, so bf16 tensors come back as float32 (exact).
    """

    def convert(node):
        if isinstance(node, dict):
            return {key: convert(value) for key, value in node.items()}
        t = node.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    return convert(tree)
