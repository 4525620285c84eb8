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
stage k*L + m*k*L.  Both read bytes and write bytes in one pass (no
bit-plane packing around the kernel).  Both look their products up in
bit-field tables (``field_tables``: c*x = T_a[x & 7] ^ T_b[(x >> 3) & 7]
^ T_c[x >> 6]) with byte permutes, and take zero and unit coefficients
without a lookup; the scaling stage is the matmul's body without the
fold over j.  ``gf_matmul_mxu`` is the GF(2) form on unpacked bits,
(bigmat @ bits) & 1, moving 8k*n + 8m*n bytes: each output row's mask
bits packed a byte per 8 input rows (``row_masks``), the input's low bits
packed the same way, an AND-XOR per row and a bytewise parity at the end;
see ``csrc/gf_mxu.cu``.  The tables and masks are built on the host side
of the launch; ``repro_torch.kernels.ops`` caches them per coefficient
matrix and device and passes them in.

A wrapper given CPU tensors computes the plain version, which is also the
oracle ``chip_smoke.py`` holds the kernel against on the card.  Given
CUDA tensors it launches the kernel on the current stream or raises;
``<wrapper>.launches`` counts its launches.
"""

from __future__ import annotations

import ctypes
import functools

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


#: the operands of the 32 products in one coefficient's bit-field tables:
#: T_a (bits 0-2 of a byte), T_b (bits 3-5), T_c (bits 6-7), zeros
FIELD_OPERANDS = (tuple(range(8)) + tuple(x << 3 for x in range(8))
                  + tuple(x << 6 for x in range(4)) + (0,) * 12)


@functools.lru_cache(maxsize=8)
def _field_products(device: torch.device) -> torch.Tensor:
    """(256, 32) uint8 on ``device``: row c holds c * FIELD_OPERANDS."""
    host = gf256.full_mul_table()[:, list(FIELD_OPERANDS)]
    return torch.from_numpy(host.copy()).to(device)


def field_tables(coeffs: torch.Tensor) -> torch.Tensor:
    """(n, k) coefficients -> (n, k, 32) uint8 bit-field tables, on the
    coefficients' device: ``t[x] = c * x``, ``t[8 + x] = c * (x << 3)`` for
    x < 8 and ``t[16 + x] = c * (x << 6)`` for x < 4, zeros after, so that
    ``c * b = t[b & 7] ^ t[8 + ((b >> 3) & 7)] ^ t[16 + (b >> 6)]`` and
    ``t[1] = c``."""
    return _field_products(coeffs.device)[coeffs.long()]


def row_masks(bigmat: torch.Tensor) -> torch.Tensor:
    """(em, ek) int8 bit-matrix -> (em, ek // 8) uint8: bit r of byte
    ``[t, j]`` is the low bit of ``bigmat[t, 8 j + r]``."""
    em, ek = bigmat.shape
    low = (bigmat & 1).to(torch.int32).reshape(em, ek // 8, 8)
    shifts = torch.arange(8, dtype=torch.int32, device=bigmat.device)
    return (low << shifts).sum(dim=-1).to(torch.uint8)


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


def _aligned_tables(coeffs: torch.Tensor, tables: torch.Tensor | None) -> torch.Tensor:
    """``tables`` (or ``field_tables(coeffs)``) checked against ``coeffs``,
    contiguous and 16-byte aligned as the kernel reads them."""
    if tables is None:
        tables = field_tables(coeffs)
    if (tables.dtype != torch.uint8 or tables.device != coeffs.device
            or tables.shape != (*coeffs.shape, 32)):
        raise ValueError(f"tables {tables.dtype} {tuple(tables.shape)} on {tables.device} "
                         f"are not the bit-field tables of coeffs {tuple(coeffs.shape)}")
    tables = tables.contiguous()
    return tables if tables.data_ptr() % 16 == 0 else tables.clone()


def _launch_matmul(tables: torch.Tensor, data: torch.Tensor, out: torch.Tensor) -> None:
    """One launch over a contiguous (S, k, L) batch into (S, n, L) ``out``."""
    lib = _lib()
    data = data.contiguous()
    s, k, length = data.shape
    with _build.on_device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        rc = lib.gf_matmul_bytes_batched(tables.data_ptr(), data.data_ptr(), out.data_ptr(),
                                         s, tables.shape[0], k, length, stream)
    _build.check(lib, rc, "gf_matmul_bytes_batched")


def gf_matmul_bytes_batched(coeffs: torch.Tensor, data: torch.Tensor,
                            tables: torch.Tensor | None = None) -> torch.Tensor:
    """(n, k) uint8 coefficients x (S, k, L) uint8 stripes -> (S, n, L) uint8.

    ``tables``: ``field_tables(coeffs)`` made beforehand (built here when
    not given); only the kernel reads them."""
    _check(coeffs, data, 3)
    if data.device.type == "cpu":
        return gf_matmul_bytes_batched_plain(coeffs, data)
    s, _, length = data.shape
    out = torch.empty((s, coeffs.shape[0], length), dtype=torch.uint8, device=data.device)
    if out.numel():
        _launch_matmul(_aligned_tables(coeffs, tables), data, out)
        gf_matmul_bytes_batched.launches += 1
    return out


def gf_matmul_bytes(coeffs: torch.Tensor, data: torch.Tensor,
                    tables: torch.Tensor | None = None) -> torch.Tensor:
    """(n, k) uint8 coefficients x (k, L) uint8 rows -> (n, L) uint8
    (``tables`` as for ``gf_matmul_bytes_batched``)."""
    _check(coeffs, data, 2)
    if data.device.type == "cpu":
        return gf_matmul_bytes_batched_plain(coeffs, data[None])[0]
    out = torch.empty((coeffs.shape[0], data.shape[1]), dtype=torch.uint8, device=data.device)
    if out.numel():
        _launch_matmul(_aligned_tables(coeffs, tables), data[None], out)
        gf_matmul_bytes.launches += 1
    return out


def gf_scale_bytes(coeffs: torch.Tensor, data: torch.Tensor,
                   tables: torch.Tensor | None = None) -> torch.Tensor:
    """(m, k) uint8 coefficients x (k, L) uint8 chunks -> (m, k, L) uint8 streams
    (``tables`` as for ``gf_matmul_bytes_batched``)."""
    _check(coeffs, data, 2)
    if data.device.type == "cpu":
        return gf_scale_bytes_plain(coeffs, data)
    m, k = coeffs.shape
    length = data.shape[1]
    out = torch.empty((m, k, length), dtype=torch.uint8, device=data.device)
    if out.numel():
        tables = _aligned_tables(coeffs, tables)
        lib = _lib()
        data = data.contiguous()
        with _build.on_device(data.device):
            stream = torch.cuda.current_stream(data.device).cuda_stream
            rc = lib.gf_scale_bytes(tables.data_ptr(), data.data_ptr(), out.data_ptr(),
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


def gf_matmul_mxu(bigmat: torch.Tensor, bits: torch.Tensor,
                  masks: torch.Tensor | None = None) -> torch.Tensor:
    """(8m, 8k) int8 bit-matrix x (8k, n) int8 bits -> (8m, n) int8, mod 2.

    ``masks``: ``row_masks(bigmat)`` made beforehand (built here when not
    given); only the kernel reads them."""
    _check_mxu(bigmat, bits)
    if bits.device.type == "cpu":
        return gf_matmul_mxu_plain(bigmat, bits)
    em, ek = bigmat.shape
    n = bits.shape[1]
    if masks is None:
        masks = row_masks(bigmat)
    if masks.dtype != torch.uint8 or masks.device != bits.device or masks.shape != (em, ek // 8):
        raise ValueError(f"masks {masks.dtype} {tuple(masks.shape)} on {masks.device} are "
                         f"not the row masks of bigmat {tuple(bigmat.shape)}")
    out = torch.empty((em, n), dtype=torch.int8, device=bits.device)
    if out.numel():
        lib = _mxu_lib()
        masks = masks.contiguous()
        bits = bits.contiguous()
        with _build.on_device(bits.device):
            stream = torch.cuda.current_stream(bits.device).cuda_stream
            rc = lib.gf_matmul_mxu(masks.data_ptr(), bits.data_ptr(), out.data_ptr(),
                                   em, ek, n, stream)
        _build.check(lib, rc, "gf_matmul_mxu")
        gf_matmul_mxu.launches += 1
    return out


gf_matmul_bytes_batched.launches = 0
gf_matmul_bytes.launches = 0
gf_scale_bytes.launches = 0
gf_matmul_mxu.launches = 0

#: every kernel wrapper of this module, for launch accounting
KERNELS = (gf_matmul_bytes_batched, gf_matmul_bytes, gf_scale_bytes, gf_matmul_mxu)
