"""AdamW's gradient norm and update over a tree's leaves, fused.

Wrappers of the hand-written CUDA kernels in ``csrc/adamw.cu``, each with
its plain PyTorch version beside it:

  ==============  ==============================================================
  wrapper         replaces (Pallas TPU kernel)
  ==============  ==============================================================
  sum_of_squares  none: the JAX package takes the norm in jnp
                  (src/repro/optim/adamw.py:global_norm); :func:`grad_norm`
                  takes its root and casts it to fp32
  adamw_step      none: the JAX package updates in jnp, and XLA fuses it
                  (src/repro/optim/adamw.py:adamw_update)
  ==============  ==============================================================

Bound: device memory, 32 bytes a value: g read by the norm, then g, p, m
and v read and p, m and v written by the update.  The plain loop moves
about 180 bytes a value (a leaf-sized fp32 temporary an operation).  Design:
one launch takes up to 64 leaves from a table passed by value; blocks walk
tiles of 4,096 values of every leaf in turn with 16-byte loads; the norm
writes one double a block and one block adds them in a fixed order into a
0-d fp64 sum, so a rerun gives the same bits (see the source's header).
The plain version sums each leaf's fp32 squares in fp64 too, so both routes
give the same dtype at the same precision.

The update equals the plain loop bit for bit given the same norm and the
same 0-d step scalars (clip factor, bias corrections, learning rate), which
the caller computes once for both routes.  The kernels take fp32 leaves
(every configuration's params are fp32 masters, and their gradients and
moments fp32), contiguous, on one CUDA device.

A wrapper given leaves on the CPU (or ``meta``, as the dry-run traces)
computes the plain version; given CUDA leaves it launches the kernel on
the current stream or raises.  ``<wrapper>.launches`` counts its kernel
calls.
"""

from __future__ import annotations

import ctypes
from collections.abc import Sequence

import torch

from repro_torch.kernels import _build

_PTR, _I64, _F32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
_SIGNATURES = {
    "adamw_norm_partials": [_I64],
    "adamw_sum_of_squares": [_PTR, _PTR, _I64, _PTR, _PTR, _PTR],
    "adamw_update": [*[_PTR] * 6, _I64, *[_PTR] * 4, *[_F32] * 6, _PTR],
}

def _lib() -> ctypes.CDLL:
    return _build.load("adamw", _SIGNATURES)


def sum_of_squares_plain(grads: Sequence[torch.Tensor], device=None) -> torch.Tensor:
    """The sum of every leaf's squares, a 0-d fp64 tensor: each leaf's fp32
    squares summed in fp64, the leaves added in their order."""
    total = torch.zeros((), dtype=torch.float64, device=grads[0].device if grads else device)
    for g in grads:
        total = total + torch.sum(g.float().square(), dtype=torch.float64)
    return total


def adamw_step_plain(params, grads, ms, vs, clip, bc1, bc2, lr, b1: float, b2: float,
                     eps: float, weight_decay: float) -> None:
    """The AdamW update of each leaf in place, one PyTorch operation at a
    time; weight decay on leaves with ``ndim >= 2``."""
    for p, g, m, v in zip(params, grads, ms, vs, strict=True):
        g = g.float() * clip
        m.mul_(b1).add_(g * (1 - b1))
        v.mul_(b2).add_(g * (1 - b2) * g)
        step_dir = (m / bc1).div_((v / bc2).sqrt_().add_(eps))
        if p.ndim >= 2:
            step_dir.add_(weight_decay * p.float())
        p.copy_(p.float() - lr * step_dir)


def _on_card(groups: dict[str, Sequence[torch.Tensor]], device=None) -> bool:
    """Whether these leaves take the kernel: True for CUDA leaves the kernel
    takes (or no leaves and a CUDA ``device``), False for leaves on no CUDA
    device; raises on a mix of devices and on CUDA leaves the kernel does
    not take."""
    devices = {t.device for ts in groups.values() for t in ts}
    if not devices:
        return device is not None and torch.device(device).type == "cuda"
    if not any(d.type == "cuda" for d in devices):
        return False
    if len(devices) > 1:
        raise ValueError(f"AdamW's leaves and scalars lie on several devices: "
                         f"{sorted(map(str, devices))}")
    for name, ts in groups.items():
        for i, t in enumerate(ts):
            if t.dtype != torch.float32:
                raise TypeError(f"{name}[{i}] is {t.dtype}: the kernel takes float32")
            if not t.is_contiguous():
                raise ValueError(f"{name}[{i}] {tuple(t.shape)} with strides {t.stride()} is "
                                 "not contiguous")
    return True


def _pointers(ts: Sequence[torch.Tensor]):
    return (ctypes.c_void_p * len(ts))(*(t.data_ptr() for t in ts))


def sum_of_squares(grads: Sequence[torch.Tensor], device=None) -> torch.Tensor:
    """The sum of the squares of every leaf of ``grads`` (none: 0 on
    ``device``), a 0-d fp64 tensor on their device: on the card from one
    read of every value in a fixed order of sums (the same gradients give
    the same bits); elsewhere the plain version."""
    grads = list(grads)
    if not _on_card({"grads": grads}, device):
        return sum_of_squares_plain(grads, device)
    dev = grads[0].device if grads else torch.device(device)
    lib = _lib()
    out = torch.empty((), dtype=torch.float64, device=dev)
    partials = torch.empty(lib.adamw_norm_partials(len(grads)), dtype=torch.float64,
                           device=dev)
    sizes = (ctypes.c_int64 * len(grads))(*(g.numel() for g in grads))
    with _build.on_device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.adamw_sum_of_squares(_pointers(grads), sizes, len(grads), partials.data_ptr(),
                                      out.data_ptr(), stream)
    _build.check(lib, rc, "adamw_sum_of_squares")
    sum_of_squares.launches += 1
    return out


def grad_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """The L2 norm over every leaf of ``grads``, a 0-d fp32 tensor: the root
    of :func:`sum_of_squares`, within 1e-6 relative of the exact norm."""
    return torch.sqrt(sum_of_squares(grads)).to(torch.float32)


def adamw_step(params, grads, ms, vs, clip: torch.Tensor, bc1: torch.Tensor, bc2: torch.Tensor,
               lr: torch.Tensor, b1: float, b2: float, eps: float, weight_decay: float) -> None:
    """The AdamW update of every leaf of ``params``, ``ms`` and ``vs`` in
    place from ``grads``, as :func:`adamw_step_plain` computes it; ``clip``,
    ``bc1``, ``bc2`` and ``lr`` are 0-d tensors on the leaves' device."""
    params, grads, ms, vs = list(params), list(grads), list(ms), list(vs)
    scalars = [clip, bc1, bc2, lr]
    if not _on_card({"params": params, "grads": grads, "m": ms, "v": vs, "scalars": scalars}):
        adamw_step_plain(params, grads, ms, vs, clip, bc1, bc2, lr, b1, b2, eps, weight_decay)
        return
    if not (len(params) == len(grads) == len(ms) == len(vs)):
        raise ValueError(f"{len(params)} params, {len(grads)} grads, {len(ms)} m and {len(vs)} v")
    for i, (p, g, m, v) in enumerate(zip(params, grads, ms, vs)):
        if not p.shape == g.shape == m.shape == v.shape:
            raise ValueError(f"leaf {i}: p {tuple(p.shape)}, g {tuple(g.shape)}, m "
                             f"{tuple(m.shape)}, v {tuple(v.shape)}")
    for name, s in zip(("clip", "bc1", "bc2", "lr"), scalars):
        if s.ndim:
            raise ValueError(f"{name} has shape {tuple(s.shape)}: expected a 0-d tensor")
    count = len(params)
    sizes = (ctypes.c_int64 * count)(*(p.numel() for p in params))
    decay = (ctypes.c_uint8 * count)(*(p.ndim >= 2 for p in params))
    # ctypes rounds each to fp32 (c_float), as PyTorch rounds a Python scalar operand
    consts = (b1, 1 - b1, b2, 1 - b2, eps, weight_decay)
    dev = params[0].device if params else clip.device
    lib = _lib()
    with _build.on_device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.adamw_update(_pointers(params), _pointers(grads), _pointers(ms), _pointers(vs),
                              sizes, decay, count, *(s.data_ptr() for s in scalars), *consts,
                              stream)
    _build.check(lib, rc, "adamw_update")
    adamw_step.launches += 1


sum_of_squares.launches = 0
adamw_step.launches = 0

#: every kernel wrapper of this module, for launch accounting
KERNELS = (sum_of_squares, adamw_step)
