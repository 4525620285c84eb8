"""Public data-plane ops over the CUDA kernels (see ``repro.kernels.ops``).

Same surface as the reference: GF(2^8) matmul / RS encode on byte
streams, single and stripe-batched, the TriEC stream scaling and the
batched XOR aggregation.  Each op takes an explicit ``device``: inputs
(numpy arrays or tensors) move there and results stay there.  The default
is ``"cuda"``, and asking for it without a GPU raises; ``device="cpu"``
runs each kernel's plain PyTorch version.  ``backend="ref"`` routes to the
LUT oracles of :mod:`repro_torch.kernels.ref` instead of the kernels.

The kernels read and write bytes and mask ragged rows themselves, so
unlike the reference there is no padding to a tile, no bit-plane packing
and no tile-size argument here.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE
from repro_torch.core import gf256
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
    coeffs_t = _coeffs_device(coeffs_np.tobytes(), n, k, data.device)
    if backend == "ref":
        return ref.gf_matmul_batched_ref(coeffs_t, data)
    if backend != "kernel":
        raise ValueError(f"unknown backend {backend!r}")
    return gf256_encode.gf_matmul_bytes_batched(coeffs_t, data)


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
    coeffs_t = _coeffs_device(coeffs_np.tobytes(), m, k, data.device)
    return gf256_encode.gf_scale_bytes(coeffs_t, data)


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
    coeffs_t = _coeffs_device(coeffs_np.tobytes(), n, k, data.device)
    if backend == "ref":
        return ref.gf_matmul_ref(coeffs_t, data)
    if backend != "kernel":
        raise ValueError(f"unknown backend {backend!r}")
    return gf256_encode.gf_matmul_bytes(coeffs_t, data)


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
