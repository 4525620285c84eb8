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
  gf_matmul_mxu               src/repro/kernels/gf256_encode.py:gf_matmul_mxu
                              (kernel in csrc/gf_mxu.cu)
  ==========================  =========================================================

Bound: device memory.  The matmul moves S*(k+n)*L bytes, the scaling
stage k*L + m*k*L.  Design: per-coefficient 256-entry product tables in
shared memory, one lookup per byte product, bytes in and bytes out in one
pass (no bit-plane packing around the kernel); see the source's header.
``gf_matmul_mxu`` is the GF(2) form on unpacked bits, (bigmat @ bits) & 1
with int32 accumulation, moving 8k*n + 8m*n bytes: the bit-matrix in
shared memory, __dp4a over 4x4 byte transposes; see ``csrc/gf_mxu.cu``.

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


_MXU_SIGNATURES = {"gf_matmul_mxu": [_PTR, _PTR, _PTR, _I64, _I64, _I64, _PTR]}
#: most input bits (8k) of one GF(2) product; int32 sums cannot overflow
MXU_MAX_K_BITS = 2048


def _lib() -> ctypes.CDLL:
    return _build.load("gf256_encode", _SIGNATURES)


def _mxu_lib() -> ctypes.CDLL:
    return _build.load("gf_mxu", _MXU_SIGNATURES)


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


def _check_mxu(bigmat: torch.Tensor, bits: torch.Tensor) -> None:
    """Raise on operands the GF(2) kernel does not take."""
    if bigmat.dtype != torch.int8 or bits.dtype != torch.int8:
        raise TypeError(f"expected int8 operands, got {bigmat.dtype} and {bits.dtype}")
    if bigmat.ndim != 2 or bits.ndim != 2 or bigmat.shape[1] != bits.shape[0]:
        raise ValueError(f"bad operand shapes: bigmat {tuple(bigmat.shape)}, "
                         f"bits {tuple(bits.shape)}")
    ek = bigmat.shape[1]
    if ek % 8 or not 8 <= ek <= MXU_MAX_K_BITS:
        raise ValueError(f"{ek} input bits: not a multiple of 8 in [8, {MXU_MAX_K_BITS}]")
    if bigmat.device != bits.device:
        raise ValueError(f"bigmat on {bigmat.device}, bits on {bits.device}")
    if bits.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {bits.device}")


def gf_matmul_mxu_plain(bigmat: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """(bigmat @ bits) & 1 through the low bits of both operands: the parity
    of an integer dot is the dot of the parities mod 2, and float32 sums
    the 0/1 products exactly (at most 2048 terms < 2**24)."""
    prod = (bigmat & 1).float() @ (bits & 1).float()
    return (prod.to(torch.int32) & 1).to(torch.int8)


def gf_matmul_mxu(bigmat: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """(8m, 8k) int8 bit-matrix x (8k, n) int8 bits -> (8m, n) int8, mod 2."""
    _check_mxu(bigmat, bits)
    if bits.device.type == "cpu":
        return gf_matmul_mxu_plain(bigmat, bits)
    em, n = bigmat.shape[0], bits.shape[1]
    out = torch.empty((em, n), dtype=torch.int8, device=bits.device)
    if out.numel():
        lib = _mxu_lib()
        bigmat = bigmat.contiguous()
        bits = bits.contiguous()
        with torch.cuda.device(bits.device):
            stream = torch.cuda.current_stream(bits.device).cuda_stream
            rc = lib.gf_matmul_mxu(bigmat.data_ptr(), bits.data_ptr(), out.data_ptr(),
                                   em, bigmat.shape[1], n, stream)
        _build.check(lib, rc, "gf_matmul_mxu")
        gf_matmul_mxu.launches += 1
    return out


gf_matmul_bytes_batched.launches = 0
gf_matmul_bytes.launches = 0
gf_scale_bytes.launches = 0
gf_matmul_mxu.launches = 0

#: every kernel wrapper of this module, for launch accounting
KERNELS = (gf_matmul_bytes_batched, gf_matmul_bytes, gf_scale_bytes, gf_matmul_mxu)
