"""Plain PyTorch oracles for the data-plane kernels (see ``repro.kernels.ref``).

The NIC/CPU-idiomatic algorithms (table-walk GF(2^8) multiplication,
straight XOR folds) on tensors of any device — slow but obviously
correct, and the ``backend="ref"`` path of :mod:`repro_torch.kernels.ops`.

torch has no ``>>``, ``<<``, ``+`` or ``-`` on ``uint32`` CPU tensors, so
table indices are int64 and the bit-plane helpers shift and pack in int64
before they hand back ``uint32`` planes in the reference's layout.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core import gf256


@functools.lru_cache(maxsize=8)
def _tables(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The log/antilog tables (the paper's LUT approach) on ``device``."""
    exp = torch.from_numpy(gf256.EXP_TABLE.copy()).to(device)           # (512,) uint8
    log = torch.from_numpy(gf256.LOG_TABLE.astype("int64")).to(device)  # (256,) int64
    return exp, log


def gf_mul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise GF(2^8) multiply via table gathers (broadcasting)."""
    a = a.to(torch.uint8)
    b = b.to(torch.uint8)
    exp, log = _tables(a.device)
    out = exp[log[a.long()] + log[b.long()]]
    return torch.where((a == 0) | (b == 0), torch.zeros_like(out), out)


def gf_matmul_ref(coeffs: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """GF(2^8) matmul: (m, k) coefficient bytes x (k, L) data -> (m, L)."""
    prods = gf_mul_ref(coeffs[:, :, None], data[None, :, :])  # (m, k, L)
    out = prods[:, 0, :]
    for j in range(1, data.shape[0]):
        out = out ^ prods[:, j, :]
    return out


def gf_matmul_batched_ref(coeffs: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """Stripe-batched LUT-path matmul: (n, k) x (S, k, L) -> (S, n, L)."""
    prods = gf_mul_ref(coeffs[None, :, :, None], data[:, None, :, :])  # (S, n, k, L)
    out = prods[:, :, 0, :]
    for j in range(1, data.shape[1]):
        out = out ^ prods[:, :, j, :]
    return out


def rs_encode_ref(data: torch.Tensor, k: int, m: int, kind: str = "cauchy") -> torch.Tensor:
    """(k, L) uint8 -> (m, L) parity via the LUT path."""
    parity = torch.from_numpy(gf256.generator_matrix(k, m, kind)[k:]).to(data.device)
    return gf_matmul_ref(parity, data)


def xor_reduce_ref(x: torch.Tensor) -> torch.Tensor:
    """XOR-fold over axis 0 (accumulator-pool aggregation oracle)."""
    out = x[0]
    for i in range(1, x.shape[0]):
        out = out ^ x[i]
    return out


# -- bit-plane helpers (torch mirrors of core.gf256) --------------------------


def pack_bitplanes(data: torch.Tensor) -> torch.Tensor:
    """(..., n) uint8 -> (..., 8, n//32) uint32; n % 32 == 0.

    Plane ``b`` packs bit ``b`` of 32 consecutive bytes into one word (byte
    ``w*32 + l`` -> bit ``l`` of word ``w``), as ``gf256.bytes_to_bitplanes``.
    """
    n = data.shape[-1]
    assert n % 32 == 0, n
    words = data.reshape(*data.shape[:-1], n // 32, 32).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=data.device)
    planes = [(((words >> b) & 1) << shifts).sum(dim=-1) for b in range(8)]
    return torch.stack(planes, dim=-2).to(torch.uint32)


def unpack_bitplanes(planes: torch.Tensor) -> torch.Tensor:
    """(..., 8, w) uint32 -> (..., 32*w) uint8."""
    w = planes.shape[-1]
    wide = planes.to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=planes.device)
    out = torch.zeros(planes.shape[:-2] + (w, 32), dtype=torch.int64, device=planes.device)
    for b in range(8):
        out |= ((wide[..., b, :, None] >> shifts) & 1) << b
    return out.to(torch.uint8).reshape(*planes.shape[:-2], w * 32)


def gf_matmul_bitsliced_ref(bitmat: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """Bit-sliced GF matmul oracle (unfused).

    bitmat: (m, k, 8, 8) 0/1 bit-matrices (out-bit, in-bit) per coefficient;
    planes: (k, 8, w) uint32 input bit-planes -> (m, 8, w) output planes.
    A set bit selects the input plane into the XOR; the reference's
    ``uint32(0) - bit`` all-ones mask needs uint32 subtraction, which torch
    does not have on the CPU.
    """
    m, k = bitmat.shape[0], bitmat.shape[1]
    w = planes.shape[-1]
    wide = planes.to(torch.int64)
    bits = bitmat.to(torch.bool).tolist()
    out = torch.zeros((m, 8, w), dtype=torch.int64, device=planes.device)
    for i in range(m):
        for ob in range(8):
            acc = torch.zeros((w,), dtype=torch.int64, device=planes.device)
            for j in range(k):
                for ib in range(8):
                    if bits[i][j][ob][ib]:
                        acc = acc ^ wide[j, ib]
            out[i, ob] = acc
    return out.to(torch.uint32)
