"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one.  Run them on
the GPU machine from the repository root:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Integer work, so every comparison is bit-exact (tolerance 0).  The sizes
cover the shapes the kernels must take that the main path rarely gives
them: ragged and odd lengths, unaligned and non-contiguous operands, and
codes wide enough that a block holds fewer than all output rows.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import gf256
from repro_torch.kernels import gf256_encode as ge
from repro_torch.kernels import ops
from repro_torch.kernels import xor_reduce as xr

pytestmark = pytest.mark.cuda

LENGTHS = [1, 31, 33, 100, 1000, 4096]
CODES = [(3, 2), (6, 3), (10, 4), (200, 8), (255, 1), (128, 128)]


@pytest.fixture
def cuda() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bytes(rng, shape, device):
    return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(device)


def _coeffs(rng, n, k, device):
    return _bytes(rng, (n, k), device)


@pytest.mark.parametrize("k,n", CODES)
@pytest.mark.parametrize("length", LENGTHS)
def test_gf_matmul_kernel_matches_plain(cuda, k, n, length):
    rng = np.random.default_rng(k * 1000 + n + length)
    coeffs = _coeffs(rng, n, k, cuda)
    data = _bytes(rng, (3, k, length), cuda)
    before = ge.gf_matmul_bytes_batched.launches
    got = ge.gf_matmul_bytes_batched(coeffs, data)
    torch.cuda.synchronize()
    assert ge.gf_matmul_bytes_batched.launches == before + 1
    assert torch.equal(got, ge.gf_matmul_bytes_batched_plain(coeffs, data))
    one = ge.gf_matmul_bytes(coeffs, data[1])
    assert torch.equal(one, got[1])


@pytest.mark.parametrize("k,m", CODES)
@pytest.mark.parametrize("length", LENGTHS)
def test_gf_scale_kernel_matches_plain(cuda, k, m, length):
    rng = np.random.default_rng(k * 1000 + m + length)
    coeffs = _coeffs(rng, m, k, cuda)
    data = _bytes(rng, (k, length), cuda)
    got = ge.gf_scale_bytes(coeffs, data)
    assert torch.equal(got, ge.gf_scale_bytes_plain(coeffs, data))


@pytest.mark.parametrize("n", [1, 2, 7, 64])
@pytest.mark.parametrize("length", LENGTHS)
def test_xor_reduce_kernel_matches_plain(cuda, n, length):
    rng = np.random.default_rng(n * 1000 + length)
    x = _bytes(rng, (3, n, length), cuda)
    got = xr.xor_reduce_bytes_batched(x)
    want = np.bitwise_xor.reduce(x.cpu().numpy(), axis=1)
    assert np.array_equal(got.cpu().numpy(), want)
    assert torch.equal(xr.xor_reduce_bytes(x[2]), got[2])


def test_unaligned_non_contiguous_operands(cuda):
    rng = np.random.default_rng(7)
    base = _bytes(rng, (4, 7, 4099), cuda)
    x = base[:, 1:, 3:]                     # offset by 3 bytes, strided rows
    coeffs = torch.from_numpy(gf256.generator_matrix(6, 3)[6:].copy()).to(cuda)
    assert torch.equal(ge.gf_matmul_bytes_batched(coeffs, x),
                       ge.gf_matmul_bytes_batched_plain(coeffs, x.contiguous()))
    assert torch.equal(ge.gf_scale_bytes(coeffs, x[0]),
                       ge.gf_scale_bytes_plain(coeffs, x[0].contiguous()))
    assert torch.equal(xr.xor_reduce_bytes_batched(x),
                       xr.xor_reduce_bytes_batched_plain(x.contiguous()))


def test_ops_on_card_match_cpu(cuda):
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, (5, 6, 1000), dtype=np.uint8)
    on_card = ops.rs_encode_stripes(data, 6, 3, device=cuda)
    assert on_card.device.type == "cuda"
    assert np.array_equal(on_card.cpu().numpy(),
                          ops.rs_encode_stripes(data, 6, 3, device="cpu").numpy())


def test_wrappers_raise_on_operands_the_kernel_does_not_take(cuda):
    coeffs = torch.ones((2, 3), dtype=torch.uint8, device=cuda)
    with pytest.raises(TypeError):
        ge.gf_matmul_bytes_batched(coeffs, torch.ones((1, 3, 8), device=cuda))
    with pytest.raises(ValueError):
        ge.gf_matmul_bytes_batched(coeffs, torch.ones((1, 4, 8), dtype=torch.uint8,
                                                      device=cuda))
    with pytest.raises(ValueError):
        ge.gf_matmul_bytes_batched(coeffs.cpu(), torch.ones((1, 3, 8), dtype=torch.uint8,
                                                            device=cuda))
