"""GF(2^8) arithmetic for Reed-Solomon erasure coding.

The paper implements GF(2^8) multiplication on PsPIN with a 256x256-byte
lookup table scanned byte-per-byte by the payload handlers (5-7 RISC-V
instructions per byte).  TPUs have no efficient byte-granularity gather, so
the framework's data plane uses the *bit-sliced* formulation instead:
multiplication by a constant ``g`` in GF(2^8) is a linear map over GF(2) and
therefore an 8x8 bit-matrix ``M_g``; Reed-Solomon encoding becomes an
XOR-accumulated AND-matmul over bit-planes (see kernels/gf256_encode.py).

This module provides:
  * exp/log tables for the field generated by the primitive polynomial
    0x11d (x^8 + x^4 + x^3 + x^2 + 1), the standard RS polynomial;
  * scalar and vectorized (numpy) multiply / divide / inverse / power;
  * full 256x256 multiplication table (the paper's NIC-resident LUT);
  * bit-matrix derivation ``mul_bitmatrix`` used by the bit-sliced kernels;
  * MDS generator matrices (Cauchy and Vandermonde) for RS(k, m);
  * GF(2^8) Gaussian elimination (matrix inverse) for decoding.

Everything here is plain numpy (host / control-plane code).  The jnp data
plane lives in kernels/ (ops.py, ref.py) and core/erasure.py.
"""

from __future__ import annotations

import functools

import numpy as np

# Primitive polynomial x^8 + x^4 + x^3 + x^2 + 1 (0x11d), generator alpha=2.
PRIMITIVE_POLY = 0x11D
FIELD_SIZE = 256


def _build_tables() -> tuple[np.ndarray, np.ndarray]:
    """exp table of length 512 (doubled to avoid mod-255) and log table."""
    exp = np.zeros(512, dtype=np.uint8)
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= PRIMITIVE_POLY
    exp[255:510] = exp[:255]
    return exp, log


EXP_TABLE, LOG_TABLE = _build_tables()


def gf_mul(a: int, b: int) -> int:
    """Scalar GF(2^8) multiply via log/antilog tables."""
    if a == 0 or b == 0:
        return 0
    return int(EXP_TABLE[LOG_TABLE[a] + LOG_TABLE[b]])


def gf_mul_vec(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Vectorized GF(2^8) multiply. Broadcasts like ``np.multiply``."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    out = EXP_TABLE[LOG_TABLE[a].astype(np.int64) + LOG_TABLE[b].astype(np.int64)]
    zero = (a == 0) | (b == 0)
    return np.where(zero, np.uint8(0), out).astype(np.uint8)


def gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("0 has no inverse in GF(2^8)")
    return int(EXP_TABLE[255 - LOG_TABLE[a]])


def gf_div(a: int, b: int) -> int:
    if b == 0:
        raise ZeroDivisionError
    if a == 0:
        return 0
    return int(EXP_TABLE[(LOG_TABLE[a] - LOG_TABLE[b]) % 255])


def gf_pow(a: int, n: int) -> int:
    if n == 0:
        return 1
    if a == 0:
        return 0
    return int(EXP_TABLE[(LOG_TABLE[a] * n) % 255])


@functools.lru_cache(maxsize=1)
def full_mul_table() -> np.ndarray:
    """The paper's 256x256-byte NIC-resident multiplication LUT (64 KiB)."""
    a = np.arange(256, dtype=np.uint8)[:, None]
    b = np.arange(256, dtype=np.uint8)[None, :]
    return gf_mul_vec(np.broadcast_to(a, (256, 256)), np.broadcast_to(b, (256, 256)))


# ---------------------------------------------------------------------------
# Bit-sliced representation (TPU adaptation).
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=512)
def mul_bitmatrix(g: int) -> np.ndarray:
    """8x8 GF(2) matrix M such that (M @ bits(x)) % 2 == bits(g * x).

    ``bits(x)`` is the little-endian bit vector of byte ``x`` (bit 0 = LSB).
    Column ``i`` of M is ``bits(g * 2^i)``: multiply-by-g is linear over
    GF(2), so its action is determined by the images of the basis 2^i.
    """
    m = np.zeros((8, 8), dtype=np.uint8)
    for i in range(8):
        prod = gf_mul(g, 1 << i)
        for j in range(8):
            m[j, i] = (prod >> j) & 1
    return m


def bytes_to_bitplanes(data: np.ndarray) -> np.ndarray:
    """(..., n) uint8 -> (..., 8, n//32) uint32 bit-planes.

    Plane ``b`` packs bit ``b`` of 32 consecutive bytes into one uint32 word
    (byte ``w*32 + l`` -> bit ``l`` of word ``w``).  ``n`` must be a multiple
    of 32; callers pad with zeros (zero bytes encode/decode to zero).
    """
    data = np.asarray(data, dtype=np.uint8)
    n = data.shape[-1]
    if n % 32:
        raise ValueError(f"trailing dim {n} not a multiple of 32")
    words = data.reshape(*data.shape[:-1], n // 32, 32).astype(np.uint32)
    shifts = np.arange(32, dtype=np.uint32)
    planes = []
    for b in range(8):
        bit = (words >> np.uint32(b)) & np.uint32(1)
        planes.append((bit << shifts).sum(axis=-1, dtype=np.uint32))
    return np.stack(planes, axis=-2)  # (..., 8, n//32)


def bitplanes_to_bytes(planes: np.ndarray) -> np.ndarray:
    """Inverse of :func:`bytes_to_bitplanes`: (..., 8, w) uint32 -> (..., 32*w) uint8."""
    planes = np.asarray(planes, dtype=np.uint32)
    w = planes.shape[-1]
    shifts = np.arange(32, dtype=np.uint32)
    out = np.zeros(planes.shape[:-2] + (w, 32), dtype=np.uint8)
    for b in range(8):
        bits = (planes[..., b, :, None] >> shifts) & np.uint32(1)
        out |= (bits.astype(np.uint8) << b)
    return out.reshape(*planes.shape[:-2], w * 32)


# ---------------------------------------------------------------------------
# Reed-Solomon generator matrices.
# ---------------------------------------------------------------------------


def cauchy_parity_matrix(k: int, m: int) -> np.ndarray:
    """(m, k) Cauchy parity matrix: every square submatrix of [I; P] is
    invertible, so RS(k, m) built from it is MDS (survives any m losses).

    P[i, j] = 1 / (x_i ^ y_j) with x = {k..k+m-1}, y = {0..k-1} distinct.
    """
    if k + m > FIELD_SIZE:
        raise ValueError(f"k+m = {k + m} exceeds GF(2^8) field size")
    p = np.zeros((m, k), dtype=np.uint8)
    for i in range(m):
        for j in range(k):
            p[i, j] = gf_inv((k + i) ^ j)
    return p


def vandermonde_parity_matrix(k: int, m: int) -> np.ndarray:
    """(m, k) parity rows derived from a systematic Vandermonde generator.

    Build the (k+m, k) Vandermonde matrix V[i, j] = alpha_i^j, row-reduce the
    top k x k block to identity with GF column operations; the bottom m rows
    are the parity matrix.  Provided for cross-validation against Cauchy.
    """
    if k + m > FIELD_SIZE:
        raise ValueError(f"k+m = {k + m} exceeds GF(2^8) field size")
    v = np.zeros((k + m, k), dtype=np.uint8)
    for i in range(k + m):
        for j in range(k):
            v[i, j] = gf_pow(i + 1, j)  # alpha_i = i+1 (nonzero, distinct)
    # Gauss-Jordan on the top k rows (column ops applied to the whole matrix).
    a = v.copy()
    for col in range(k):
        # Find pivot in row `col` among columns >= col.
        piv = next(c for c in range(col, k) if a[col, c] != 0)
        if piv != col:
            a[:, [col, piv]] = a[:, [piv, col]]
        inv = gf_inv(int(a[col, col]))
        a[:, col] = gf_mul_vec(a[:, col], np.uint8(inv))
        for c in range(k):
            if c != col and a[col, c] != 0:
                a[:, c] ^= gf_mul_vec(a[:, col], a[col, c])
    if not np.array_equal(a[:k], np.eye(k, dtype=np.uint8)):
        raise AssertionError("Vandermonde systematization failed")
    return a[k:]


def generator_matrix(k: int, m: int, kind: str = "cauchy") -> np.ndarray:
    """Full (k+m, k) systematic generator [I; P]."""
    if kind == "cauchy":
        p = cauchy_parity_matrix(k, m)
    elif kind == "vandermonde":
        p = vandermonde_parity_matrix(k, m)
    else:
        raise ValueError(f"unknown generator kind: {kind}")
    return np.concatenate([np.eye(k, dtype=np.uint8), p], axis=0)


@functools.lru_cache(maxsize=512)
def _parity_bitmatrix_cached(coeff_bytes: bytes, m: int, k: int) -> np.ndarray:
    parity = np.frombuffer(coeff_bytes, dtype=np.uint8).reshape(m, k)
    out = np.zeros((m, k, 8, 8), dtype=np.uint8)
    for i in range(m):
        for j in range(k):
            out[i, j] = mul_bitmatrix(int(parity[i, j]))
    out.flags.writeable = False
    return out


def parity_bitmatrix(parity: np.ndarray) -> np.ndarray:
    """(m, k) byte coefficients -> (m, k, 8, 8) uint8 bit-matrices.

    This is the constant operand handed to the bit-sliced Pallas kernel.
    Memoized by coefficient bytes (bounded LRU — decode feeds a distinct
    inverted submatrix per erasure pattern): the data plane calls this once
    per stripe-batch and the nested-loop build must not ride the hot path.
    The returned array is read-only (it is shared across callers).
    """
    parity = np.ascontiguousarray(parity, dtype=np.uint8)
    m, k = parity.shape
    return _parity_bitmatrix_cached(parity.tobytes(), m, k)


# ---------------------------------------------------------------------------
# GF(2^8) linear algebra (decode path).
# ---------------------------------------------------------------------------


def gf_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """GF(2^8) matrix product: XOR-accumulated gf_mul. a:(n,k), b:(k,...)."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    out = np.zeros(a.shape[:-1] + b.shape[1:], dtype=np.uint8)
    for j in range(a.shape[-1]):
        out ^= gf_mul_vec(a[..., j : j + 1] if a.ndim > 1 else a[j], b[j])
    return out


def gf_mat_inv(a: np.ndarray) -> np.ndarray:
    """Invert a square GF(2^8) matrix by Gauss-Jordan elimination."""
    a = np.asarray(a, dtype=np.uint8).copy()
    n = a.shape[0]
    if a.shape != (n, n):
        raise ValueError("matrix must be square")
    aug = np.concatenate([a, np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        piv_rows = np.nonzero(aug[col:, col])[0]
        if piv_rows.size == 0:
            raise np.linalg.LinAlgError("singular GF(2^8) matrix")
        piv = col + int(piv_rows[0])
        if piv != col:
            aug[[col, piv]] = aug[[piv, col]]
        aug[col] = gf_mul_vec(aug[col], np.uint8(gf_inv(int(aug[col, col]))))
        for r in range(n):
            if r != col and aug[r, col] != 0:
                aug[r] ^= gf_mul_vec(aug[col], aug[r, col])
    return aug[:, n:]
