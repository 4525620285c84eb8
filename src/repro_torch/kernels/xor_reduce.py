"""XOR fold of byte rows: the parity-node accumulator aggregation.

Wrappers of the hand-written CUDA kernel in ``csrc/xor_reduce.cu``, each
with its plain PyTorch version beside it:

  ==========================  ================================================
  wrapper                     replaces (Pallas TPU kernel)
  ==========================  ================================================
  xor_reduce_bytes_batched    src/repro/kernels/xor_reduce.py:xor_reduce_batched
  xor_reduce_bytes            src/repro/kernels/xor_reduce.py:xor_reduce
                              (the S = 1 launch of the same kernel)
  ==========================  ================================================

Bound: device memory, S*(n+1)*L bytes.  Design: one thread per 16
output bytes issues the loads of up to 8 input rows before it folds
them, so that many reads are in flight; ragged tails are masked in the
kernel instead of padded (see the source's header).

A wrapper given CPU tensors computes the plain version; given CUDA
tensors it launches the kernel on the current stream or raises.
``<wrapper>.launches`` counts its launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_PTR, _I64 = ctypes.c_void_p, ctypes.c_int64
_SIGNATURES = {"xor_reduce_bytes_batched": [_PTR, _PTR, _I64, _I64, _I64, _PTR]}


def _lib() -> ctypes.CDLL:
    return _build.load("xor_reduce", _SIGNATURES)


def _check(x: torch.Tensor, ndim: int) -> None:
    """Raise on operands the kernel does not take."""
    if x.dtype != torch.uint8:
        raise TypeError(f"expected uint8, got {x.dtype}")
    if x.ndim != ndim or x.shape[-2] < 1:
        raise ValueError(f"expected {ndim} dims with >= 1 row to fold, got {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def xor_reduce_bytes_batched_plain(x: torch.Tensor) -> torch.Tensor:
    """(S, n, L) -> (S, L): a straight XOR fold over axis 1."""
    out = x[:, 0].clone()
    for i in range(1, x.shape[1]):
        out ^= x[:, i]
    return out


def _launch(x: torch.Tensor, out: torch.Tensor) -> None:
    """One launch over a contiguous (S, n, L) batch into (S, L) ``out``."""
    lib = _lib()
    x = x.contiguous()
    s, n, length = x.shape
    with _build.on_device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.xor_reduce_bytes_batched(x.data_ptr(), out.data_ptr(), s, n, length, stream)
    _build.check(lib, rc, "xor_reduce_bytes_batched")


def xor_reduce_bytes_batched(x: torch.Tensor) -> torch.Tensor:
    """(S, n, L) uint8 -> (S, L) uint8, XOR over axis 1."""
    _check(x, 3)
    if x.device.type == "cpu":
        return xor_reduce_bytes_batched_plain(x)
    out = torch.empty((x.shape[0], x.shape[2]), dtype=torch.uint8, device=x.device)
    if out.numel():
        _launch(x, out)
        xor_reduce_bytes_batched.launches += 1
    return out


def xor_reduce_bytes(x: torch.Tensor) -> torch.Tensor:
    """(n, L) uint8 -> (L,) uint8, XOR over axis 0."""
    _check(x, 2)
    if x.device.type == "cpu":
        return xor_reduce_bytes_batched_plain(x[None])[0]
    out = torch.empty((x.shape[1],), dtype=torch.uint8, device=x.device)
    if out.numel():
        _launch(x[None], out)
        xor_reduce_bytes.launches += 1
    return out


xor_reduce_bytes_batched.launches = 0
xor_reduce_bytes.launches = 0

#: every kernel wrapper of this module, for launch accounting
KERNELS = (xor_reduce_bytes_batched, xor_reduce_bytes)
