"""Public ops over the CUDA kernels (see ``repro.kernels.ops``).

Same surface as the reference: GF(2^8) matmul / RS encode on byte
streams, single and stripe-batched, the bit-matrix ("MXU") RS encode, the
TriEC stream scaling, the batched XOR aggregation, the bulk capability
verifier, and the flash attention dispatch.  Each op takes an explicit
``device``: inputs (numpy arrays or tensors) move there and results stay
there.  The default is ``"cuda"``, and asking for it without a GPU raises;
``device="cpu"`` runs each kernel's plain PyTorch version.
``backend="ref"`` routes to the LUT oracles of
:mod:`repro_torch.kernels.ref` instead of the kernels.  The verifier has
no kernel of its own, as the reference's is plain ``jnp``: it is a batched
torch ARX on the device.

The kernels read and write bytes and mask ragged rows themselves, so
unlike the reference there is no padding to a tile, no bit-plane packing
and no tile-size argument here.  What the GF kernels take besides their
operands (the bit-field tables of the matmul and the stream scaling, the
GF(2) product's packed row masks) is cached per coefficient matrix and
device, as the matrices are.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE
from repro_torch.core import gf256
from repro_torch.core.auth import MAC_ROUNDS
from repro_torch.kernels import flash_attention as flash_attention_kernel
from repro_torch.kernels import gf256_encode, ref, xor_reduce


def resolve_device(device: str | torch.device) -> torch.device:
    """``torch.device(device)``, raising when it names CUDA and there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch versions"
        )
    return dev


def _bytes_on(x, device: str | torch.device) -> torch.Tensor:
    """``x`` (numpy array or tensor) as a uint8 tensor on ``device``."""
    dev = resolve_device(device)
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=torch.uint8)
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.uint8)).to(dev)


@functools.lru_cache(maxsize=256)
def _coeffs_device(coeff_bytes: bytes, n: int, k: int, device: torch.device) -> torch.Tensor:
    """Device-resident (n, k) coefficient bytes, memoized per device: decode
    feeds a distinct inverted submatrix for every erasure pattern, and the
    steady state must not upload the same matrix again."""
    host = np.frombuffer(coeff_bytes, dtype=np.uint8).reshape(n, k)
    return torch.from_numpy(host.copy()).to(device)


@functools.lru_cache(maxsize=256)
def _tables_device(coeff_bytes: bytes, n: int, k: int, device: torch.device) -> torch.Tensor:
    """The GF(2^8) kernels' (n, k, 32) bit-field tables of those
    coefficients, memoized per device beside them."""
    return gf256_encode.field_tables(_coeffs_device(coeff_bytes, n, k, device))


def _coeffs_np(coeffs) -> np.ndarray:
    if isinstance(coeffs, torch.Tensor):
        coeffs = coeffs.cpu().numpy()
    return np.ascontiguousarray(coeffs, dtype=np.uint8)


# ---------------------------------------------------------------------------
# RS encode / GF matmul on byte streams.
# ---------------------------------------------------------------------------


def gf_matmul_bytes_batched(
    coeffs,
    data,
    backend: str = "kernel",
    device: str | torch.device = DEFAULT_DEVICE,
) -> torch.Tensor:
    """(n, k) GF coefficient bytes x (S, k, L) stripe batch -> (S, n, L).

    The batched workhorse: S concurrent stripes share one coefficient
    upload and one kernel launch.
    """
    data = _bytes_on(data, device)
    if data.ndim != 3:
        raise ValueError(f"expected (S, k, L) stripes, got {tuple(data.shape)}")
    coeffs_np = _coeffs_np(coeffs)
    n, k = coeffs_np.shape
    if data.shape[1] != k:
        raise ValueError(f"coeffs {coeffs_np.shape} do not match data {tuple(data.shape)}")
    if n == 0:
        return torch.zeros((data.shape[0], 0, data.shape[2]), dtype=torch.uint8,
                           device=data.device)
    key = (coeffs_np.tobytes(), n, k, data.device)
    coeffs_t = _coeffs_device(*key)
    if backend == "ref":
        return ref.gf_matmul_batched_ref(coeffs_t, data)
    if backend != "kernel":
        raise ValueError(f"unknown backend {backend!r}")
    return gf256_encode.gf_matmul_bytes_batched(coeffs_t, data, _tables_device(*key))


def rs_encode_stripes(
    data,
    k: int,
    m: int,
    kind: str = "cauchy",
    backend: str = "kernel",
    device: str | torch.device = DEFAULT_DEVICE,
) -> torch.Tensor:
    """Batched systematic RS(k, m): (S, k, L) uint8 -> (S, m, L) parity,
    one kernel launch for the whole stripe batch."""
    parity = gf256.generator_matrix(k, m, kind)[k:]
    return gf_matmul_bytes_batched(parity, data, backend=backend, device=device)


def gf_scale_streams(
    coeffs,
    data,
    device: str | torch.device = DEFAULT_DEVICE,
) -> torch.Tensor:
    """(m, k) GF coefficients x (k, L) chunks -> (m, k, L) scaled streams.

    The data-node stage of streaming TriEC: stream (i, j) is
    g[i, j] * chunk_j, every (parity, chunk) pair in one launch — no
    folding, so the parity-node XOR aggregation stays a separate stage.
    """
    data = _bytes_on(data, device)
    coeffs_np = _coeffs_np(coeffs)
    m, k = coeffs_np.shape
    if data.ndim != 2 or data.shape[0] != k:
        raise ValueError(f"coeffs {coeffs_np.shape} do not match data {tuple(data.shape)}")
    if m == 0:
        return torch.zeros((0, k, data.shape[1]), dtype=torch.uint8, device=data.device)
    key = (coeffs_np.tobytes(), m, k, data.device)
    return gf256_encode.gf_scale_bytes(_coeffs_device(*key), data, _tables_device(*key))


def gf_matmul_bytes(
    coeffs,
    data,
    backend: str = "kernel",
    device: str | torch.device = DEFAULT_DEVICE,
) -> torch.Tensor:
    """(n, k) GF coefficient bytes x (k, L) byte rows -> (n, L).

    The single-stripe launch of the batched kernel; used for both encode
    (coeffs = parity matrix) and decode (coeffs = inverted generator
    submatrix).
    """
    data = _bytes_on(data, device)
    if data.ndim != 2:
        raise ValueError(f"expected (k, L) rows, got {tuple(data.shape)}")
    coeffs_np = _coeffs_np(coeffs)
    n, k = coeffs_np.shape
    if data.shape[0] != k:
        raise ValueError(f"coeffs {coeffs_np.shape} do not match data {tuple(data.shape)}")
    if n == 0:
        return torch.zeros((0, data.shape[1]), dtype=torch.uint8, device=data.device)
    key = (coeffs_np.tobytes(), n, k, data.device)
    coeffs_t = _coeffs_device(*key)
    if backend == "ref":
        return ref.gf_matmul_ref(coeffs_t, data)
    if backend != "kernel":
        raise ValueError(f"unknown backend {backend!r}")
    return gf256_encode.gf_matmul_bytes(coeffs_t, data, _tables_device(*key))


def rs_encode(
    data,
    k: int,
    m: int,
    kind: str = "cauchy",
    backend: str = "kernel",
    device: str | torch.device = DEFAULT_DEVICE,
) -> torch.Tensor:
    """Systematic RS(k, m) parity: (k, L) uint8 -> (m, L) uint8."""
    parity = gf256.generator_matrix(k, m, kind)[k:]
    return gf_matmul_bytes(parity, data, backend=backend, device=device)


@functools.lru_cache(maxsize=64)
def rs_block_bitmatrix(k: int, m: int, kind: str, device: torch.device) -> torch.Tensor:
    """The (8m, 8k) int8 block bit-matrix of RS(k, m)'s parity rows, on
    ``device``: out-row i*8+ob, in-col j*8+ib."""
    bm = gf256.parity_bitmatrix(gf256.generator_matrix(k, m, kind)[k:])   # (m, k, 8, 8)
    big = np.transpose(bm, (0, 2, 1, 3)).reshape(8 * m, 8 * k).astype(np.int8)
    return torch.from_numpy(big).to(device)


@functools.lru_cache(maxsize=64)
def _rs_block_masks(k: int, m: int, kind: str, device: torch.device) -> torch.Tensor:
    """The GF(2) kernel's packed row masks of ``rs_block_bitmatrix``."""
    return gf256_encode.row_masks(rs_block_bitmatrix(k, m, kind, device))


def rs_encode_mxu(
    data,
    k: int,
    m: int,
    kind: str = "cauchy",
    device: str | torch.device = DEFAULT_DEVICE,
) -> torch.Tensor:
    """Bit-matrix RS encode (the reference's beyond-paper MXU variant).

    Unpacks bytes to one-bit int8 rows, multiplies by the (8m, 8k) block
    bit-matrix mod 2 in one kernel launch, packs back.  Bit layout: column
    t holds byte t of the stripe; row j*8+b is bit b of chunk j.  The
    kernel masks a ragged L itself, so there is no padding.
    """
    data = _bytes_on(data, device)
    if data.ndim != 2 or data.shape[0] != k:
        raise ValueError(f"expected ({k}, L) data chunks, got {tuple(data.shape)}")
    length = data.shape[1]
    shifts = torch.arange(8, dtype=torch.uint8, device=data.device)
    bits = ((data[:, None, :] >> shifts[None, :, None]) & 1).to(torch.int8)
    out_bits = gf256_encode.gf_matmul_mxu(rs_block_bitmatrix(k, m, kind, data.device),
                                          bits.reshape(8 * k, length),
                                          _rs_block_masks(k, m, kind, data.device))
    out_bits = out_bits.reshape(m, 8, length).to(torch.uint8)
    return (out_bits << shifts[None, :, None]).sum(dim=1).to(torch.uint8)


# ---------------------------------------------------------------------------
# XOR aggregation.
# ---------------------------------------------------------------------------


def xor_reduce_bytes(
    x,
    backend: str = "kernel",
    device: str | torch.device = DEFAULT_DEVICE,
) -> torch.Tensor:
    """XOR-fold (n, L) uint8 over axis 0 -> (L,) uint8, any L."""
    x = _bytes_on(x, device)
    if backend == "ref":
        return ref.xor_reduce_ref(x)
    if backend != "kernel":
        raise ValueError(f"unknown backend {backend!r}")
    return xor_reduce.xor_reduce_bytes(x)


def xor_reduce_bytes_batched(
    x,
    backend: str = "kernel",
    device: str | torch.device = DEFAULT_DEVICE,
) -> torch.Tensor:
    """Batched XOR-fold: (S, n, L) uint8 over axis 1 -> (S, L) uint8.

    The parity-node accumulator aggregation for S concurrent sequences in
    one kernel launch (paper section VI-B3, batched).
    """
    x = _bytes_on(x, device)
    if x.ndim != 3:
        raise ValueError(f"expected (S, n, L), got {tuple(x.shape)}")
    if backend == "ref":
        return ref.xor_reduce_ref(x.transpose(0, 1))
    if backend != "kernel":
        raise ValueError(f"unknown backend {backend!r}")
    return xor_reduce.xor_reduce_bytes_batched(x)


# ---------------------------------------------------------------------------
# Bulk capability verification (the batched header-handler check).
# ---------------------------------------------------------------------------

_MASK32 = 0xFFFFFFFF
# the sponge's initial state, XORed with the key (core/auth.py sponge_mac)
_SPONGE_IV = (0x736F6D65, 0x646F7261, 0x6C796765, 0x74656462)


def _words_on(x, device: torch.device) -> torch.Tensor:
    """uint32 words (numpy array or tensor) as int64 values on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64)
    return torch.from_numpy(np.asarray(x, dtype=np.uint32).astype(np.int64)).to(device)


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK32


def _sponge_round(v0, v1, v2, v3):
    v0 = (v0 + v1) & _MASK32
    v1 = _rotl32(v1, 5) ^ v0
    v0 = _rotl32(v0, 16)
    v2 = (v2 + v3) & _MASK32
    v3 = _rotl32(v3, 8) ^ v2
    v0 = (v0 + v3) & _MASK32
    v3 = _rotl32(v3, 13) ^ v0
    v2 = (v2 + v1) & _MASK32
    v1 = _rotl32(v1, 7) ^ v2
    v2 = _rotl32(v2, 16)
    return v0, v1, v2, v3


def _sponge_mac(words: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """``core.auth.sponge_mac`` over (..., W) words as int64 values in
    [0, 2^32): torch has no shifts or adds on uint32, so every add and
    rotation is masked to 32 bits.  Returns (..., 2) int64."""
    v0, v1, v2, v3 = ((key[i] ^ iv).expand(words.shape[:-1])
                      for i, iv in enumerate(_SPONGE_IV))
    for i in range(words.shape[-1]):
        w = words[..., i]
        v3 = v3 ^ w
        for _ in range(2):
            v0, v1, v2, v3 = _sponge_round(v0, v1, v2, v3)
        v0 = v0 ^ w
    v2 = v2 ^ 0xFF
    for _ in range(MAC_ROUNDS):
        v0, v1, v2, v3 = _sponge_round(v0, v1, v2, v3)
    return torch.stack([v0 ^ v1, v2 ^ v3], dim=-1)


def bulk_verify_tags(
    caps_words,
    key,
    device: str | torch.device = DEFAULT_DEVICE,
) -> torch.Tensor:
    """(N, CAP_WORDS) uint32 + (4,) key -> (N, 2) uint32 tags, on ``device``."""
    dev = resolve_device(device)
    return _sponge_mac(_words_on(caps_words, dev), _words_on(key, dev)).to(torch.uint32)


def bulk_verify(
    caps_words,
    tags,
    key,
    device: str | torch.device = DEFAULT_DEVICE,
) -> torch.Tensor:
    """Vector verdict for a batch of capabilities: (N,) bool MAC-match."""
    dev = resolve_device(device)
    want = _sponge_mac(_words_on(caps_words, dev), _words_on(key, dev))
    return (want == _words_on(tags, dev)).all(dim=-1)


# ---------------------------------------------------------------------------
# Flash attention (CUDA forward kernel; blockwise path on the CPU).
# ---------------------------------------------------------------------------


def _float_on(x, device: torch.device) -> torch.Tensor:
    """``x`` (numpy array or tensor) as a tensor on ``device``, dtype kept."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def flash_attention(
    q,
    k,
    v,
    causal: bool = True,
    backend: str | None = None,
    device: str | torch.device = DEFAULT_DEVICE,
) -> torch.Tensor:
    """Dispatch as the reference does: the hand-written kernel on a CUDA
    device (the counterpart of "Pallas on TPU") or with
    ``backend="kernel"`` (on CPU tensors, its plain version); else the
    differentiable ``blockwise_attention(q, k, v, causal, 512, 0)``.  The
    kernel path is forward only, as the TPU kernel is: it raises when q, k
    or v needs a gradient."""
    if backend not in (None, "kernel"):
        raise ValueError(f"unknown backend {backend!r}")
    dev = resolve_device(device)
    q, k, v = (_float_on(x, dev) for x in (q, k, v))
    if backend == "kernel" or dev.type == "cuda":
        return flash_attention_kernel.flash_attention_fwd(q, k, v, causal)
    from repro_torch.models.attention import blockwise_attention

    return blockwise_attention(q, k, v, causal, 512, 0)
