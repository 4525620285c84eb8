"""Plain NumPy Reed-Solomon over GF(2^8), as HDFS's RS raw coder defines it:
the field of the primitive polynomial x^8 + x^4 + x^3 + x^2 + 1 (0x11d), a
systematic code whose parity rows are the Cauchy matrix
P[i, j] = 1 / ((k + i) xor j) (Hadoop's ``RSUtil.genCauchyMatrix``).

It imports nothing of the program.  ``stripe_cells`` cuts an object into its
k data cells as the configuration stores them: ceil(size / k) bytes a cell,
rounded up to 32, the tail zero-padded.
"""

from __future__ import annotations

import numpy as np

POLY = 0x11D


def _tables() -> tuple[np.ndarray, np.ndarray]:
    exp = np.zeros(512, np.int64)
    log = np.zeros(256, np.int64)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= POLY
    exp[255:510] = exp[:255]
    return exp, log


EXP, LOG = _tables()


def mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(EXP[LOG[a] + LOG[b]])


def inv(a: int) -> int:
    return int(EXP[255 - LOG[a]])


def mul_table(c: int) -> np.ndarray:
    """The 256 products c * x, as a lookup table."""
    return np.array([mul(c, x) for x in range(256)], np.uint8)


def cauchy(k: int, m: int) -> np.ndarray:
    return np.array([[inv((k + i) ^ j) for j in range(k)] for i in range(m)], np.uint8)


def stripe_cells(blob: np.ndarray, k: int, align: int = 32) -> np.ndarray:
    size = blob.size
    cell = -(-size // k)
    cell = -(-cell // align) * align
    out = np.zeros(k * cell, np.uint8)
    out[:size] = blob
    return out.reshape(k, cell)


def encode(cells: np.ndarray, m: int) -> np.ndarray:
    """(..., k, L) data cells -> (..., m, L) parity cells."""
    k = cells.shape[-2]
    coeffs = cauchy(k, m)
    out = np.zeros(cells.shape[:-2] + (m, cells.shape[-1]), np.uint8)
    for i in range(m):
        for j in range(k):
            out[..., i, :] ^= mul_table(int(coeffs[i, j]))[cells[..., j, :]]
    return out
