"""GF(2^8) matmul by constants on byte rows: the RS encode/decode hot spot.

Wrappers of the hand-written CUDA kernels in ``csrc/gf256_encode.cu``,
each with its plain PyTorch version beside it:

  ==========================  =========================================================
  wrapper                     replaces (Pallas TPU kernel)
  ==========================  =========================================================
  gf_matmul_bytes_batched     src/repro/kernels/gf256_encode.py:gf_matmul_bitsliced_batched
  gf_matmul_bytes             src/repro/kernels/gf256_encode.py:gf_matmul_bitsliced
                              (the S = 1 launch of the same kernel)
  gf_scale_bytes              src/repro/kernels/gf256_encode.py:gf_scale_bitsliced
  ==========================  =========================================================

Bound: device memory.  The matmul moves S*(k+n)*L bytes, the scaling
stage k*L + m*k*L.  Design: per-coefficient 256-entry product tables in
shared memory, one lookup per byte product, bytes in and bytes out in one
pass (no bit-plane packing around the kernel); see the source's header.

A wrapper given CPU tensors computes the plain version, which is also the
oracle ``chip_smoke.py`` holds the kernel against on the card.  Given
CUDA tensors it launches the kernel on the current stream or raises;
``<wrapper>.launches`` counts its launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import gf256
from repro_torch.kernels import _build

_PTR, _I64 = ctypes.c_void_p, ctypes.c_int64
_SIGNATURES = {
    "gf_matmul_bytes_batched": [_PTR, _PTR, _PTR, _I64, _I64, _I64, _I64, _PTR],
    "gf_scale_bytes": [_PTR, _PTR, _PTR, _I64, _I64, _I64, _PTR],
}


def _lib() -> ctypes.CDLL:
    return _build.load("gf256_encode", _SIGNATURES)


def _check(coeffs: torch.Tensor, data: torch.Tensor, ndim: int) -> None:
    """Raise on operands the kernels do not take."""
    if coeffs.dtype != torch.uint8 or data.dtype != torch.uint8:
        raise TypeError(f"expected uint8 operands, got {coeffs.dtype} and {data.dtype}")
    if coeffs.ndim != 2 or data.ndim != ndim:
        raise ValueError(f"bad operand ranks: coeffs {tuple(coeffs.shape)}, "
                         f"data {tuple(data.shape)}")
    k = coeffs.shape[1]
    if data.shape[-2] != k:
        raise ValueError(f"coeffs {tuple(coeffs.shape)} do not match data "
                         f"{tuple(data.shape)}")
    if not 1 <= k <= gf256.FIELD_SIZE:
        raise ValueError(f"k = {k} outside [1, {gf256.FIELD_SIZE}]")
    if coeffs.device != data.device:
        raise ValueError(f"coeffs on {coeffs.device}, data on {data.device}")
    if data.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {data.device}")


def product_tables(coeffs: torch.Tensor) -> torch.Tensor:
    """(n, k) coefficients -> (n, k, 256) tables, ``t[i, j, x] = c[i, j] * x``."""
    full = torch.from_numpy(gf256.full_mul_table()).to(coeffs.device)
    return full[coeffs.long()]


# -- plain versions -----------------------------------------------------------


def gf_matmul_bytes_batched_plain(coeffs: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """(n, k) x (S, k, L) -> (S, n, L): table gathers, XOR-folded over j."""
    tables = product_tables(coeffs)
    s, k, length = data.shape
    out = torch.zeros((s, coeffs.shape[0], length), dtype=torch.uint8, device=data.device)
    for j in range(k):
        out ^= tables[:, j][:, data[:, j].long()].transpose(0, 1)
    return out


def gf_scale_bytes_plain(coeffs: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """(m, k) x (k, L) -> (m, k, L): every product stream, no fold."""
    m, k = coeffs.shape
    index = data.long().unsqueeze(0).expand(m, k, data.shape[1])
    return torch.gather(product_tables(coeffs), 2, index)


# -- kernel wrappers ------------------------------------------------------------


def _launch_matmul(coeffs: torch.Tensor, data: torch.Tensor, out: torch.Tensor) -> None:
    """One launch over a contiguous (S, k, L) batch into (S, n, L) ``out``."""
    lib = _lib()
    coeffs = coeffs.contiguous()
    data = data.contiguous()
    s, k, length = data.shape
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        rc = lib.gf_matmul_bytes_batched(coeffs.data_ptr(), data.data_ptr(), out.data_ptr(),
                                         s, coeffs.shape[0], k, length, stream)
    _build.check(lib, rc, "gf_matmul_bytes_batched")


def gf_matmul_bytes_batched(coeffs: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """(n, k) uint8 coefficients x (S, k, L) uint8 stripes -> (S, n, L) uint8."""
    _check(coeffs, data, 3)
    if data.device.type == "cpu":
        return gf_matmul_bytes_batched_plain(coeffs, data)
    s, _, length = data.shape
    out = torch.empty((s, coeffs.shape[0], length), dtype=torch.uint8, device=data.device)
    if out.numel():
        _launch_matmul(coeffs, data, out)
        gf_matmul_bytes_batched.launches += 1
    return out


def gf_matmul_bytes(coeffs: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """(n, k) uint8 coefficients x (k, L) uint8 rows -> (n, L) uint8."""
    _check(coeffs, data, 2)
    if data.device.type == "cpu":
        return gf_matmul_bytes_batched_plain(coeffs, data[None])[0]
    out = torch.empty((coeffs.shape[0], data.shape[1]), dtype=torch.uint8, device=data.device)
    if out.numel():
        _launch_matmul(coeffs, data[None], out)
        gf_matmul_bytes.launches += 1
    return out


def gf_scale_bytes(coeffs: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """(m, k) uint8 coefficients x (k, L) uint8 chunks -> (m, k, L) uint8 streams."""
    _check(coeffs, data, 2)
    if data.device.type == "cpu":
        return gf_scale_bytes_plain(coeffs, data)
    m, k = coeffs.shape
    length = data.shape[1]
    out = torch.empty((m, k, length), dtype=torch.uint8, device=data.device)
    if out.numel():
        lib = _lib()
        coeffs = coeffs.contiguous()
        data = data.contiguous()
        with torch.cuda.device(data.device):
            stream = torch.cuda.current_stream(data.device).cuda_stream
            rc = lib.gf_scale_bytes(coeffs.data_ptr(), data.data_ptr(), out.data_ptr(),
                                    m, k, length, stream)
        _build.check(lib, rc, "gf_scale_bytes")
        gf_scale_bytes.launches += 1
    return out


gf_matmul_bytes_batched.launches = 0
gf_matmul_bytes.launches = 0
gf_scale_bytes.launches = 0

#: every kernel wrapper of this module, for launch accounting
KERNELS = (gf_matmul_bytes_batched, gf_matmul_bytes, gf_scale_bytes)
