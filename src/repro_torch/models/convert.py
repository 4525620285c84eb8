"""Carry params and decode caches across between ``repro`` (JAX) and ``repro_torch``.

A ``repro`` params or cache pytree after ``jax.device_get`` is a nest of
dicts, lists and tuples with numpy arrays at the leaves (deepseek's
``first_layers`` and the xLSTM ``blocks`` are lists, an xLSTM decode cache
is a list of tuples, an enc-dec cache holds a 0-d ``enc_len``).
:func:`params_from_numpy` turns it, params or cache, into the same nest of
tensors on one device, keeping every name, container type, shape and
layout (a dense ``w`` stays (d_in, d_out); a 0-d array becomes a 0-d
tensor); :func:`params_to_numpy` goes the other way.  Neither side imports
the other package: numpy is the only format that crosses.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE
from repro_torch.kernels.ops import resolve_device
from repro_torch.models.layers import tree_map


def _leaf_to_tensor(leaf, device: torch.device) -> torch.Tensor:
    # a copy: jax.device_get hands out read-only arrays, and on the CPU the
    # tensor would share their memory
    arr = np.array(leaf, order="C")
    if arr.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16, as jax.device_get returns it: reinterpret the bits
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _leaf_to_numpy(leaf: torch.Tensor) -> np.ndarray:
    # a copy: on the CPU ``Tensor.numpy`` shares the tensor's memory, which
    # a training step then updates in place
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return np.array(t.numpy())


def params_from_numpy(tree: Any, device: str | torch.device = DEFAULT_DEVICE) -> Any:
    """Nest of dicts, lists and tuples of numpy arrays -> the same nest of
    tensors on ``device``."""
    dev = resolve_device(device)
    return tree_map(lambda leaf: _leaf_to_tensor(leaf, dev), tree)


def params_to_numpy(tree: Any) -> Any:
    """Nest of dicts, lists and tuples of tensors -> the same nest of numpy
    arrays on the host, each a copy.

    numpy has no bfloat16, so bf16 tensors come back as float32 (exact).
    """
    return tree_map(_leaf_to_numpy, tree)
