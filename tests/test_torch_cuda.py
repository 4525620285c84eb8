"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one.  Run them on
the GPU machine from the repository root:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The GF(2^8), GF(2) and XOR kernels do integer work, so those comparisons
are bit-exact (tolerance 0).  Flash attention is held against its plain
version on the same inputs, which walks the kernel's KV tiles and so
rounds where the kernel rounds: in fp32 at rtol = atol = 3e-4 (the
reference's own, tests/test_kernels.py), in bf16 within one ulp (2^-7 of
the value) plus 1e-3 of the row's RMS, and in both within a relative RMS
error of 1e-5 (fp32) or 5e-4 (bf16).  The sizes cover the shapes the kernels
must take that the main path rarely gives them: ragged and odd lengths,
unaligned and non-contiguous operands, and codes wide enough that a block
holds fewer than all output rows; for the GF(2^8) matmul also matrices of
zeros and ones (which it skips or XORs), every RS(6,3) decode inverse,
and every row width its 16-byte, 4-byte and byte paths take; for the
stream scaling the same zero and unit coefficients, tables passed in and
tables over 48 KiB; for the XOR fold input counts on both sides of its
8-row load group and more stripes than a grid dimension may hold.  AdamW's
fused update equals its plain loop bit for bit given the same norm (fp32
roundings in the loop's order), on trees of stacked, unstacked, 0-d, odd
and unaligned leaves and more leaves than one launch takes; its fused norm
lies within 1e-6 relative of a float64 norm and repeats bit for bit.
"""

import importlib.util
import itertools
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import gf256
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gf256_encode as ge
from repro_torch.kernels import ops
from repro_torch.kernels import xor_reduce as xr
from repro_torch.models import attention as pt_attn
from repro_torch.models.attention import blockwise_attention

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


@pytest.mark.parametrize("n", [1, 7, 8, 9, 17, 64])
@pytest.mark.parametrize("length", [15, 16, 17, 32, 33, 48, 4096 + 16, 4096 + 20])
@pytest.mark.parametrize("offset", [0, 4, 1])
def test_xor_reduce_kernel_load_groups(cuda, n, length, offset):
    """n below, at and past the 8 rows whose loads go out before the first
    XOR; lengths around one and two 16-byte columns; bases moved by 0, 4
    and 1 bytes (the 16-byte, 4-byte and byte paths)."""
    rng = np.random.default_rng(n * 10_000 + length * 10 + offset)
    flat = _bytes(rng, (2 * n * length + offset,), cuda)
    x = flat[offset:].view(2, n, length)
    got = xr.xor_reduce_bytes_batched(x)
    want = np.bitwise_xor.reduce(x.cpu().numpy(), axis=1)
    assert np.array_equal(got.cpu().numpy(), want)
    assert torch.equal(xr.xor_reduce_bytes(x[1]), got[1])


@pytest.mark.parametrize("length", [16, 1, 48])
def test_xor_reduce_kernel_many_short_stripes(cuda, length):
    """S = 70,000 stripes of a short row: more than gridDim.y or z could
    hold, and a grid-stride walk whose step crosses many stripes."""
    rng = np.random.default_rng(length)
    x = _bytes(rng, (70_000, 3, length), cuda)
    got = xr.xor_reduce_bytes_batched(x)
    assert torch.equal(got, xr.xor_reduce_bytes_batched_plain(x))


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


def _rs63_decode_inverse(lost):
    g = gf256.generator_matrix(6, 3)
    return gf256.gf_mat_inv(g[[i for i in range(9) if i not in lost]])


def _eye_with_zero_row():
    eye = np.eye(5, dtype=np.uint8)
    eye[3] = 0
    return eye


#: coefficient matrices of zeros and ones, which the kernel skips or XORs
SPECIAL_COEFFS = {
    "identity": lambda: np.eye(6, dtype=np.uint8),
    "zero row": _eye_with_zero_row,
    "all ones": lambda: np.ones((3, 6), dtype=np.uint8),
    "all zeros": lambda: np.zeros((4, 6), dtype=np.uint8),
    "ones and general": lambda: np.array([[1, 0, 7], [0, 1, 1], [200, 0, 1]], dtype=np.uint8),
}


@pytest.mark.parametrize("case", sorted(SPECIAL_COEFFS))
@pytest.mark.parametrize("length", [1, 33, 1000, 4099, 65536])
def test_gf_matmul_kernel_zero_and_unit_coefficients(cuda, case, length):
    coeffs = torch.from_numpy(SPECIAL_COEFFS[case]()).to(cuda)
    rng = np.random.default_rng(length)
    data = _bytes(rng, (3, coeffs.shape[1], length), cuda)
    got = ge.gf_matmul_bytes_batched(coeffs, data)
    assert torch.equal(got, ge.gf_matmul_bytes_batched_plain(coeffs, data))


@pytest.mark.parametrize("case", sorted(SPECIAL_COEFFS))
@pytest.mark.parametrize("length", [1, 33, 1000, 4099, 65536])
def test_gf_scale_kernel_zero_and_unit_coefficients(cuda, case, length):
    coeffs = torch.from_numpy(SPECIAL_COEFFS[case]()).to(cuda)
    rng = np.random.default_rng(length + 1)
    data = _bytes(rng, (coeffs.shape[1], length), cuda)
    got = ge.gf_scale_bytes(coeffs, data)
    assert torch.equal(got, ge.gf_scale_bytes_plain(coeffs, data))


@pytest.mark.parametrize("k,m", [(6, 3), (200, 8), (256, 7)])
def test_gf_scale_kernel_takes_precomputed_tables(cuda, k, m):
    """Tables passed in (aligned, and copied to 16 bytes when not), and
    m * k tables over the 48 KiB a block holds (200 x 8: two tiles of
    output rows)."""
    rng = np.random.default_rng(k + m)
    coeffs = _coeffs(rng, m, k, cuda)
    data = _bytes(rng, (k, 1000), cuda)
    tables = ge.field_tables(coeffs)
    padded = torch.empty(tables.numel() + 1, dtype=torch.uint8, device=cuda)
    unaligned = padded[1:].view(tables.shape).copy_(tables)
    want = ge.gf_scale_bytes_plain(coeffs, data)
    before = ge.gf_scale_bytes.launches
    assert torch.equal(ge.gf_scale_bytes(coeffs, data, tables), want)
    assert torch.equal(ge.gf_scale_bytes(coeffs, data, unaligned), want)
    assert ge.gf_scale_bytes.launches == before + 2
    with pytest.raises(ValueError):
        ge.gf_scale_bytes(coeffs, data, tables[:, :k - 1])


@pytest.mark.parametrize("length", [16 * 64, 16 * 64 + 4, 16 * 64 + 7])
@pytest.mark.parametrize("offset", [0, 4, 1])
def test_gf_scale_kernel_row_widths_and_offsets(cuda, length, offset):
    rng = np.random.default_rng(length * 16 + offset + 1)
    flat = _bytes(rng, (6 * length + offset,), cuda)
    data = flat[offset:].view(6, length)
    coeffs = torch.from_numpy(gf256.generator_matrix(6, 3)[6:].copy()).to(cuda)
    assert torch.equal(ge.gf_scale_bytes(coeffs, data), ge.gf_scale_bytes_plain(coeffs, data))


@pytest.mark.parametrize("length", [1003, 4096])
def test_gf_matmul_kernel_decodes_every_rs63_erasure_pattern(cuda, length):
    """The inverted matrix of each of the 84 patterns of 3 lost cells, on
    the stripes' surviving cells, recovers the data bit for bit."""
    rng = np.random.default_rng(length)
    data = _bytes(rng, (2, 6, length), cuda)
    parity = torch.from_numpy(gf256.generator_matrix(6, 3)[6:].copy()).to(cuda)
    cells = torch.cat([data, ge.gf_matmul_bytes_batched(parity, data)], dim=1)
    for lost in itertools.combinations(range(9), 3):
        survivors = [i for i in range(9) if i not in lost]
        inv = torch.from_numpy(_rs63_decode_inverse(lost)).to(cuda)
        got = ge.gf_matmul_bytes_batched(inv, cells[:, survivors])
        assert torch.equal(got, ge.gf_matmul_bytes_batched_plain(inv, cells[:, survivors])), lost
        assert torch.equal(got, data), lost


@pytest.mark.parametrize("length", [16 * 64, 16 * 64 + 4, 16 * 64 + 8, 16 * 64 + 12, 16 * 64 + 7,
                                    16 * 64 + 1])
@pytest.mark.parametrize("offset", [0, 1, 4, 8, 12, 15])
def test_gf_matmul_kernel_row_widths_and_offsets(cuda, length, offset):
    """L % 16 in {0, 4, 8, 12} and odd, with the base moved by 0-15 bytes:
    the 16-byte, 4-byte and byte paths."""
    rng = np.random.default_rng(length * 16 + offset)
    flat = _bytes(rng, (2 * 6 * length + offset,), cuda)
    data = flat[offset:].view(2, 6, length)
    coeffs = torch.from_numpy(gf256.generator_matrix(6, 3)[6:].copy()).to(cuda)
    got = ge.gf_matmul_bytes_batched(coeffs, data)
    assert torch.equal(got, ge.gf_matmul_bytes_batched_plain(coeffs, data))
    assert torch.equal(ge.gf_matmul_bytes(coeffs, data[1]), got[1])


def test_gf_matmul_kernel_takes_precomputed_tables(cuda):
    rng = np.random.default_rng(21)
    coeffs = _coeffs(rng, 4, 6, cuda)
    data = _bytes(rng, (2, 6, 1000), cuda)
    tables = ge.field_tables(coeffs)
    padded = torch.empty(tables.numel() + 1, dtype=torch.uint8, device=cuda)
    unaligned = padded[1:].view(tables.shape).copy_(tables)      # copied to 16 bytes
    want = ge.gf_matmul_bytes_batched_plain(coeffs, data)
    assert torch.equal(ge.gf_matmul_bytes_batched(coeffs, data, tables), want)
    assert torch.equal(ge.gf_matmul_bytes_batched(coeffs, data, unaligned), want)
    with pytest.raises(ValueError):
        ge.gf_matmul_bytes_batched(coeffs, data, tables[:, :5])


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


# -- GF(2) bit-matrix product (the "MXU" RS encode) -------------------------------


MXU_LENGTHS = [1, 127, 1000, 4096, 1_000_003]


@pytest.mark.parametrize("k,m", [(3, 2), (6, 3), (10, 4), (200, 8), (255, 1)])
@pytest.mark.parametrize("n", MXU_LENGTHS)
def test_gf_matmul_mxu_kernel_matches_plain(cuda, k, m, n):
    rng = np.random.default_rng(k * 100 + m + n)
    bigmat = torch.from_numpy(rng.integers(0, 2, (8 * m, 8 * k), dtype=np.int8)).to(cuda)
    bits = torch.from_numpy(rng.integers(0, 2, (8 * k, n), dtype=np.int8)).to(cuda)
    before = ge.gf_matmul_mxu.launches
    got = ge.gf_matmul_mxu(bigmat, bits)
    torch.cuda.synchronize()
    assert ge.gf_matmul_mxu.launches == before + 1
    assert got.dtype == torch.int8 and got.shape == (8 * m, n)
    assert torch.equal(got, ge.gf_matmul_mxu_plain(bigmat, bits))


def test_gf_matmul_mxu_any_int8_values_and_unaligned_rows(cuda):
    """The int8 dot mod 2 for values beyond 0/1, and a bits tensor whose
    rows do not start on 4-byte boundaries (the byte path)."""
    rng = np.random.default_rng(5)
    bigmat = torch.from_numpy(rng.integers(-128, 128, (24, 48), dtype=np.int8)).to(cuda)
    flat = torch.from_numpy(rng.integers(-128, 128, 48 * 1001 + 3, dtype=np.int8)).to(cuda)
    bits = flat[3:].view(48, 1001)
    want = (bigmat.cpu().numpy().astype(np.int64) @ bits.cpu().numpy().astype(np.int64)) & 1
    got = ge.gf_matmul_mxu(bigmat, bits)
    assert np.array_equal(got.cpu().numpy(), want.astype(np.int8))
    assert torch.equal(got, ge.gf_matmul_mxu_plain(bigmat, bits))


@pytest.mark.parametrize("ek", [8, 48, 2040])
@pytest.mark.parametrize("em", [1, 24, 40])
@pytest.mark.parametrize("n", [1, 1001, 4096])
def test_gf_matmul_mxu_kernel_input_widths(cuda, ek, em, n):
    """One group of 8 input rows, RS(6,3)'s 6, and 255; output rows in one
    tile, filling it, and over two tiles."""
    rng = np.random.default_rng(ek * 10 + em + n)
    bigmat = torch.from_numpy(rng.integers(-128, 128, (em, ek), dtype=np.int8)).to(cuda)
    bits = torch.from_numpy(rng.integers(-128, 128, (ek, n), dtype=np.int8)).to(cuda)
    got = ge.gf_matmul_mxu(bigmat, bits)
    assert torch.equal(got, ge.gf_matmul_mxu_plain(bigmat, bits))
    assert torch.equal(ge.gf_matmul_mxu(bigmat, bits, ge.row_masks(bigmat)), got)


def test_gf_matmul_mxu_kernel_zero_matrix(cuda):
    bits = torch.ones((48, 1000), dtype=torch.int8, device=cuda)
    got = ge.gf_matmul_mxu(torch.zeros((24, 48), dtype=torch.int8, device=cuda), bits)
    assert got.shape == (24, 1000) and not bool(got.any())
    with pytest.raises(ValueError):
        ge.gf_matmul_mxu(torch.zeros((24, 48), dtype=torch.int8, device=cuda), bits,
                         torch.zeros((24, 5), dtype=torch.uint8, device=cuda))


@pytest.mark.parametrize("k,m", [(3, 2), (6, 3)])
@pytest.mark.parametrize("length", [1, 33, 1000, 1 << 20])
def test_rs_encode_mxu_on_card_matches_rs_encode(cuda, k, m, length):
    data = np.random.default_rng(length).integers(0, 256, (k, length), dtype=np.uint8)
    got = ops.rs_encode_mxu(data, k, m, device=cuda)
    assert got.device.type == "cuda"
    assert torch.equal(got, ops.rs_encode(data, k, m, device=cuda))


def test_gf_matmul_mxu_refuses_operands_the_kernel_does_not_take(cuda):
    ones = torch.ones((24, 48), dtype=torch.int8, device=cuda)
    with pytest.raises(TypeError):
        ge.gf_matmul_mxu(ones, torch.ones((48, 8), dtype=torch.uint8, device=cuda))
    with pytest.raises(ValueError):
        ge.gf_matmul_mxu(ones, torch.ones((40, 8), dtype=torch.int8, device=cuda))
    with pytest.raises(ValueError):
        big = torch.ones((8, 2056), dtype=torch.int8, device=cuda)
        ge.gf_matmul_mxu(big, torch.ones((2056, 8), dtype=torch.int8, device=cuda))


# -- flash attention ------------------------------------------------------------------


HEAD_DIMS = list(fa.HEAD_DIMS)
#: |got - want| <= rtol |want| + row_atol rms(want's row) + atol, and the
#: relative RMS error at most rel_rms (as chip_smoke.py's SAME_ARITHMETIC)
TOLERANCE = {
    torch.float32: {"rtol": 3e-4, "row_atol": 0.0, "atol": 3e-4, "rel_rms": 1e-5},
    torch.bfloat16: {"rtol": 2 ** -7, "row_atol": 1e-3, "atol": 0.0, "rel_rms": 5e-4},
}


def _qkv(rng, b, s, h, hkv, d, dv, dtype, device):
    def draw(shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(
            device=device, dtype=dtype)

    return draw((b, s, h, d)), draw((b, s, hkv, d)), draw((b, s, hkv, dv))


def _assert_close(got, want, dtype):
    tol = TOLERANCE[dtype]
    got, want = got.float(), want.float()
    assert bool(torch.isfinite(got).all())
    diff = (got - want).abs()
    row_rms = want.square().mean(dim=-1, keepdim=True).sqrt()
    allowed = tol["rtol"] * want.abs() + tol["row_atol"] * row_rms + tol["atol"]
    worst = torch.where(diff == 0, 0.0, diff / allowed).max()
    assert float(worst) <= 1.0, f"max |err| {float(diff.max())}, {float(worst)} of the allowance"
    assert float(diff.norm()) <= tol["rel_rms"] * float(want.norm())


@pytest.mark.parametrize("d,dv", HEAD_DIMS)
@pytest.mark.parametrize("s", [1, 63, 64, 65, 127, 128, 129, 1500])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_flash_attention_kernel_matches_plain(cuda, d, dv, s, causal, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False    # the plain version's fp32 matmuls
    rng = np.random.default_rng(d * 1000 + dv + s)
    q, k, v = _qkv(rng, 2, s, 4, 2, d, dv, dtype, cuda)
    before = fa.flash_attention_fwd.launches
    got = fa.flash_attention_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == before + 1
    assert got.dtype == dtype and got.shape == (2, s, 4, dv)
    _assert_close(got, fa.flash_attention_fwd_plain(q, k, v, causal)[0], dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_flash_attention_reads_strided_layouts(cuda, dtype):
    """q/k/v as (B,S,H,D) views of (B,H,S,D) storage: read through strides."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(11)
    q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
               for t in _qkv(rng, 2, 300, 8, 2, 128, 128, dtype, cuda))
    assert not q.is_contiguous()
    got = fa.flash_attention_fwd(q, k, v, True)
    _assert_close(got, fa.flash_attention_fwd_plain(q.contiguous(), k.contiguous(),
                                                    v.contiguous(), True)[0], dtype)


@pytest.mark.parametrize("rep", [1, 4, 8])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_flash_attention_gqa_groups(cuda, rep, causal, dtype):
    """Every query head reads kv head h // rep, over several q and KV tiles."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(100 + rep)
    q, k, v = _qkv(rng, 2, 300, 2 * rep, 2, 128, 128, dtype, cuda)
    got = fa.flash_attention_fwd(q, k, v, causal)
    _assert_close(got, fa.flash_attention_fwd_plain(q, k, v, causal)[0], dtype)


@pytest.mark.parametrize("sq,skv,q_offset", [(128, 512, 384), (100, 300, 200), (64, 256, 64),
                                             (300, 300, 0), (1, 129, 128), (200, 700, 37),
                                             (128, 128, 256)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_flash_attention_query_offset_matches_plain(cuda, sq, skv, q_offset, causal, dtype):
    """q rows at positions q_offset + i against Skv keys (a context-parallel
    rank's rows), in both bodies, offsets on and off the tile grid."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(sq * 7 + skv * 3 + q_offset)
    q, _, _ = _qkv(rng, 2, sq, 4, 2, 128, 128, dtype, cuda)
    _, k, v = _qkv(rng, 2, skv, 4, 2, 128, 128, dtype, cuda)
    before = fa.flash_attention_fwd.offset_launches
    got = fa.flash_attention_fwd(q, k, v, causal, q_offset)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.offset_launches == before + (q_offset > 0)
    assert got.shape == (2, sq, 4, 128)
    _assert_close(got, fa.flash_attention_fwd_plain(q, k, v, causal, q_offset)[0], dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_flash_attention_row_blocks_with_offsets_equal_the_whole(cuda, dtype):
    """q cut into 4 row blocks, each launched with its offset against all of
    k/v, gives the unsplit launch's bytes: every row walks the same tiles in
    the same order."""
    rng = np.random.default_rng(77)
    q, k, v = _qkv(rng, 1, 1024, 8, 2, 128, 128, dtype, cuda)
    whole = fa.flash_attention_fwd(q, k, v, True)
    parts = [fa.flash_attention_fwd(q[:, i:i + 256], k, v, True, i) for i in range(0, 1024, 256)]
    assert torch.equal(torch.cat(parts, dim=1), whole)


@pytest.mark.parametrize("case", ["base", "stride", "head_dim"])
def test_flash_attention_copies_operands_tma_cannot_read(cuda, case):
    """bf16 operands whose base address or (B,S,H) stride is not a multiple
    of 16 bytes, or whose head dim is strided, are copied first and give the
    same result as their contiguous copies."""
    rng = np.random.default_rng(15)
    q, k, v = _qkv(rng, 2, 200, 4, 2, 64, 64, torch.bfloat16, cuda)
    if case == "base":          # one element (2 bytes) into a flat buffer
        flat = torch.empty(k.numel() + 1, dtype=k.dtype, device=cuda)
        k2 = flat[1:].view(k.shape).copy_(k)
    elif case == "stride":      # rows 65 elements apart
        k2 = torch.empty((2, 200, 2, 65), dtype=k.dtype, device=cuda)[..., :64].copy_(k)
    else:                       # the head dim two elements apart
        k2 = torch.empty((2, 200, 2, 64, 2), dtype=k.dtype, device=cuda)[..., 0].copy_(k)
    assert fa.needs_copy(k2) and not fa.needs_copy(k)
    got = fa.flash_attention_fwd(q, k2, v, True)
    assert torch.equal(got, fa.flash_attention_fwd(q, k, v, True))
    _assert_close(got, fa.flash_attention_fwd_plain(q, k, v, True)[0], torch.bfloat16)


def test_flash_attention_is_forward_only_on_card(cuda):
    rng = np.random.default_rng(14)
    q, k, v = _qkv(rng, 1, 64, 4, 2, 64, 64, torch.bfloat16, cuda)
    before = fa.flash_attention_fwd.launches
    with pytest.raises(RuntimeError, match="no backward"):
        fa.flash_attention_fwd(q.requires_grad_(), k, v)
    # a gradient routes the layers' attention to the differentiable blockwise path
    out = pt_attn.attention(q, k, v)
    assert out.requires_grad
    assert torch.equal(out.detach(), blockwise_attention(q.detach(), k, v, True, 512, 0))
    assert fa.flash_attention_fwd.launches == before
    with torch.no_grad():
        got = pt_attn.attention(q, k, v)
    assert fa.flash_attention_fwd.launches == before + 1
    _assert_close(got, fa.flash_attention_fwd_plain(q.detach(), k, v, True)[0], torch.bfloat16)
    # the fp32 body against the CPU's plain version: across devices, the
    # reference's elementwise bound (the host CPU's fp32 products need not
    # round as the card's do)
    q32, k32, v32 = (t.detach().float() for t in (q, k, v))
    with torch.no_grad():
        got = pt_attn.attention(q32, k32, v32)
    assert fa.flash_attention_fwd.launches == before + 2
    want = fa.flash_attention_fwd(q32.cpu(), k32.cpu(), v32.cpu())
    torch.testing.assert_close(got.cpu(), want, rtol=3e-4, atol=3e-4)


def test_flash_attention_refuses_operands_the_kernel_does_not_take(cuda):
    rng = np.random.default_rng(13)
    q, k, v = _qkv(rng, 1, 64, 4, 2, 128, 128, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention_fwd(q[..., :96], k[..., :96], v)
    with pytest.raises(ValueError, match="share B"):
        fa.flash_attention_fwd(q, k[:, :32], v)           # k and v of two lengths
    with pytest.raises(ValueError, match="negative"):
        fa.flash_attention_fwd(q, k, v, True, -1)
    with pytest.raises(TypeError, match="dtypes differ"):
        fa.flash_attention_fwd(q, k.float(), v)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        fa.flash_attention_fwd(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention_fwd(q[:, :, :3], k, v)


# -- the training pair: the flash forward with lse, the fused backward --------------------
#
# Tolerances, each with its reason.  out is the forward kernel's (the same
# launch as flash_attention_fwd: equal bit for bit), held against its plain
# version at the forward's bf16 TOLERANCE.  lse is an fp32 log of an fp32 sum
# that the two take in another order: 1e-5.  dq, dk and dv are held against
# the plain training backward given the same q, k, v, out, dout and lse
# under chip_smoke.py's PAIR_GRADS, the smoke run's own check of the kernel:
# both keep P and dS at fp32 precision (the kernel in three bf16 terms,
# each product exact, summed in fp32), so they differ only in the order of
# fp32 sums (and the plain scaling q before its products) before one
# rounding to bf16 each.  Two such sums round to the same bf16 value or to
# neighbours: elementwise, one ulp (2^-7 of the value) plus 1e-3 of the
# row's RMS, the bf16 counterpart of the 3e-4 fp32 attention tolerance,
# and 1e-4 only where the function is 0 in exact arithmetic
# (chip_smoke.pair_exact_zeros: a row that sees one key has dP = delta, so
# its dS is 0; both sides' fp32 sums leave residues of about 1e-7 there,
# each its own).  In RMS over the other elements, the kernel's bf16 output is no further from the plain
# backward's unrounded fp32 result than that result's own rounding to bf16
# is, within 5%: where a sum falls on a bf16 tie (S = 1: a sum of rep bf16
# values), either side is one rounding.  A backward that rounded P or dS
# once to bf16 lands near 1.4 times that rounding, and fails
# (test_kernel_pair_check_rejects_a_once_rounded_backward).

PAIR_LSE_TOL = 1e-5
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)


def _assert_pair_close(got, want, want32, exact_zero):
    """``got`` (bf16) against the plain backward's ``want`` (bf16) and its
    unrounded fp32 ``want32``, ``exact_zero`` where the function is 0."""
    close = smoke.pair_closeness(got, want, want32, exact_zero)
    assert close["ok"], close


def _pair_inputs(rng, b, sq, skv, h, hkv, device, dims=(128, 128)):
    """q, k, v and dout in bf16 at head dims ``dims`` = (D, Dv), one of
    ``fa.BWD_HEAD_DIMS``."""
    d, dv = dims
    q, _, _ = _qkv(rng, b, sq, h, hkv, d, dv, torch.bfloat16, device)
    _, k, v = _qkv(rng, b, skv, h, hkv, d, dv, torch.bfloat16, device)
    dout = torch.from_numpy(rng.standard_normal((b, sq, h, dv), dtype=np.float32)).to(
        device=device, dtype=torch.bfloat16)
    return q, k, v, dout


#: the attention of a train_4k layer at each of the pair's head dims, (B, S,
#: H, Hkv): yi-9b's 32 query heads over 4, and deepseek-v2-lite's MLA, 16
#: heads each with its own K and V (the cell's batch of 4 is 4 such calls)
TRAIN_4K_LAYERS = {(128, 128): (1, 4096, 32, 4), (192, 128): (1, 4096, 16, 16)}


def _check_pair(q, k, v, dout, causal, q_offset=0):
    """The kernel pair against its plain versions on the same inputs; returns
    the kernels' (out, lse, dq, dk, dv)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    before = (fa.flash_attention_fwd_lse.launches, fa.flash_attention_bwd.launches)
    out, lse = fa.flash_attention_fwd_lse(q, k, v, causal, q_offset)
    grads = fa.flash_attention_bwd(q, k, v, out, dout, lse, causal, q_offset)
    torch.cuda.synchronize()
    assert (fa.flash_attention_fwd_lse.launches, fa.flash_attention_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(out, fa.flash_attention_fwd(q, k, v, causal, q_offset))
    out_plain, lse_plain = fa.flash_attention_fwd_plain(q, k, v, causal, q_offset)
    _assert_close(out, out_plain, torch.bfloat16)
    torch.testing.assert_close(lse, lse_plain, rtol=PAIR_LSE_TOL, atol=PAIR_LSE_TOL)
    want = fa.flash_attention_bwd_plain(q, k, v, out, dout, lse, causal, q_offset)
    want32 = fa.flash_attention_bwd_plain(*(t.float() for t in (q, k, v, out, dout)), lse,
                                          causal, q_offset)
    zeros = smoke.pair_exact_zeros(q.shape[1], k.shape[1], causal, q_offset, q.device)
    for got, ref, ref32, zero, like in zip(grads, want, want32, zeros, (q, k, v), strict=True):
        assert got.dtype == torch.bfloat16 and got.shape == like.shape
        _assert_pair_close(got, ref, ref32, zero)
    return (out, lse, *grads)


@pytest.mark.parametrize("s", [1, 63, 64, 65, 127, 128, 129, 300])
@pytest.mark.parametrize("dims,rep", [((128, 128), 1), ((128, 128), 4), ((128, 128), 8),
                                      ((192, 128), 1), ((192, 128), 4)])
@pytest.mark.parametrize("causal", [True, False])
def test_kernel_pair_matches_plain(cuda, s, dims, rep, causal):
    """Ragged lengths on both sides of the 32-, 64- and 128-row tiles, GQA
    groups of 1, 4 and 8 query heads a KV head (MLA's 1 and 4 at 192/128),
    causal and not."""
    rng = np.random.default_rng(1000 * rep + s + causal)
    _check_pair(*_pair_inputs(rng, 2, s, s, 2 * rep, 2, cuda, dims), causal)


def test_kernel_pair_matches_plain_at_yi_train_4k(cuda):
    """yi-9b's train_4k attention: B=1, S=4096, 32 query heads over 4, D=128."""
    rng = np.random.default_rng(4096)
    _check_pair(*_pair_inputs(rng, 1, 4096, 4096, 32, 4, cuda), True)


def test_kernel_pair_matches_plain_at_dsv2lite_train_4k(cuda):
    """deepseek-v2-lite's train_4k MLA attention, one of the cell's 4
    sequences: S=4096, 16 heads, q and k 192 wide (128 + 64 rotary), v 128."""
    rng = np.random.default_rng(4097)
    _check_pair(*_pair_inputs(rng, 1, 4096, 4096, 16, 16, cuda, (192, 128)), True)


@pytest.mark.parametrize("sq,skv,q_offset", [(128, 512, 384), (100, 300, 200), (64, 256, 64),
                                             (1, 129, 128), (200, 700, 37), (128, 128, 256)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dims", fa.BWD_HEAD_DIMS)
def test_kernel_pair_query_offset_matches_plain(cuda, sq, skv, q_offset, causal, dims):
    """q rows at positions q_offset + i against Skv keys (a context-parallel
    rank's rows, as MLA's on a mesh), Sq < Skv, offsets on and off the tile
    grids; keys no row sees get a zero gradient."""
    rng = np.random.default_rng(sq * 7 + skv * 3 + q_offset)
    _check_pair(*_pair_inputs(rng, 2, sq, skv, 8, 2, cuda, dims), causal, q_offset)


@pytest.mark.parametrize("rounded", ["P", "dS"])
@pytest.mark.parametrize("dims", fa.BWD_HEAD_DIMS)
def test_kernel_pair_check_rejects_a_once_rounded_backward(cuda, rounded, dims):
    """The planted control, at the train_4k layer of each head-dim pair: a
    backward that rounds P (or dS) once to bf16 before its products fails
    the check that the kernel passes (test_kernel_pair_matches_plain_at_yi_
    train_4k, ..._at_dsv2lite_train_4k)."""
    b, s, h, hkv = TRAIN_4K_LAYERS[dims]
    rng = np.random.default_rng(4096 if dims == (128, 128) else 4097)
    q, k, v, dout = _pair_inputs(rng, b, s, s, h, hkv, cuda, dims)
    torch.backends.cuda.matmul.allow_tf32 = False
    out, lse = fa.flash_attention_fwd_lse(q, k, v, True)
    want = fa.flash_attention_bwd_plain(q, k, v, out, dout, lse, True)
    want32 = fa.flash_attention_bwd_plain(*(t.float() for t in (q, k, v, out, dout)), lse, True)
    wrong = smoke.pair_bwd_rounded_once(q, k, v, out, dout, lse, True, 0, rounded)
    zeros = smoke.pair_exact_zeros(s, s, True, 0, cuda)
    close = [smoke.pair_closeness(*args) for args in zip(wrong, want, want32, zeros,
                                                         strict=True)]
    assert not all(c["ok"] for c in close), close


@pytest.mark.parametrize("dims", fa.BWD_HEAD_DIMS)
def test_kernel_pair_repeats_bit_for_bit(cuda, dims):
    """No atomics: two runs on the same inputs give the same bits."""
    rng = np.random.default_rng(21)
    q, k, v, dout = _pair_inputs(rng, 1, 1000, 1000, 16, 2, cuda, dims)
    first = _check_pair(q, k, v, dout, True)
    out, lse = fa.flash_attention_fwd_lse(q, k, v, True)
    again = (out, lse, *fa.flash_attention_bwd(q, k, v, out, dout, lse, True))
    for x, y in zip(first, again, strict=True):
        assert torch.equal(x, y)


@pytest.mark.parametrize("dims", fa.BWD_HEAD_DIMS)
def test_kernel_pair_reads_strided_layouts(cuda, dims):
    """q, k, v and dout as (B,S,H,D) views of (B,H,S,D) storage."""
    rng = np.random.default_rng(22)
    q, k, v, dout = (t.transpose(1, 2).contiguous().transpose(1, 2)
                     for t in _pair_inputs(rng, 2, 300, 300, 8, 2, cuda, dims))
    assert not q.is_contiguous() and not dout.is_contiguous()
    got = _check_pair(q, k, v, dout, True)
    want = _check_pair(*(t.contiguous() for t in (q, k, v, dout)), True)
    for x, y in zip(got, want, strict=True):
        assert torch.equal(x, y)


def _grads_float64(q, k, v, dout, causal):
    """(out, dq, dk, dv) of the exact function in float64 on the same values."""
    q64, k64, v64 = (t.double().requires_grad_() for t in (q, k, v))
    rep = q.shape[2] // k.shape[2]
    kr, vr = k64.repeat_interleave(rep, dim=2), v64.repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q64, kr) / q.shape[-1] ** 0.5
    if causal:
        mask = torch.ones(s.shape[-2:], dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    out = torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), vr)
    out.backward(dout.double())
    return out.detach(), q64.grad, k64.grad, v64.grad


def _rel_rms(got, want):
    return float((got.double() - want).norm() / want.norm())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dims", fa.BWD_HEAD_DIMS)
def test_kernel_pair_is_no_less_precise_than_the_plain_path(cuda, causal, dims):
    """Against the function in float64 on the same bf16 values, the kernel
    pair's out, dq, dk and dv are within 1.25x the relative RMS error of the
    plain path's (blockwise forward and backward in fp32, rounded to bf16):
    P and dS are not rounded to a narrower type on the way."""
    rng = np.random.default_rng(23 + causal)
    q, k, v, dout = _pair_inputs(rng, 1, 700, 700, 8, 2, cuda, dims)
    exact = _grads_float64(q, k, v, dout, causal)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = pt_attn._BlockwiseAttention.apply(*leaves, causal, 512, 0, False)
    out.backward(dout)
    plain = (out.detach(), *(t.grad for t in leaves))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = blockwise_attention(*leaves, causal, 512, 0)
    out.backward(dout)
    pair = (out.detach(), *(t.grad for t in leaves))
    for name, got, ref, want in zip(("out", "dq", "dk", "dv"), pair, plain, exact, strict=True):
        assert _rel_rms(got, want) <= 1.25 * _rel_rms(ref, want), name


def test_blockwise_attention_on_card_takes_the_kernel_pair(cuda):
    """The route: bf16 q, k, v of D = Dv = 128 (and MLA's 192/128,
    test_mla_layer_trains_on_the_kernel_pair) take the kernel pair, both
    directions, with a gradient or without; fp32 and other widths take the
    plain loops (counted in PLAIN_CALLS)."""
    rng = np.random.default_rng(24)
    q, k, v, dout = _pair_inputs(rng, 1, 200, 200, 8, 2, cuda)

    def run(q, k, v, grad=True):
        counts = (fa.flash_attention_fwd_lse.launches, fa.flash_attention_bwd.launches,
                  pt_attn.PLAIN_CALLS["cuda"])
        with torch.set_grad_enabled(grad):
            leaves = [t.detach().clone().requires_grad_(grad) for t in (q, k, v)]
            out = blockwise_attention(*leaves, True, 512, 0)
            if grad:
                out.backward(torch.ones_like(out))
        torch.cuda.synchronize()
        return (fa.flash_attention_fwd_lse.launches - counts[0],
                fa.flash_attention_bwd.launches - counts[1],
                pt_attn.PLAIN_CALLS["cuda"] - counts[2])

    assert run(q, k, v) == (1, 1, 0)
    assert run(q.float(), k.float(), v.float()) == (0, 0, 1)
    assert run(q[..., :64], k[..., :64], v[..., :64]) == (0, 0, 1)
    assert run(q, k, v, grad=False) == (1, 0, 0)


def test_mla_layer_trains_on_the_kernel_pair(cuda, monkeypatch):
    """One MLA layer at DeepSeek-V2-Lite's widths (d_model 2048, 16 heads,
    latent 512 with its RMSNorm, q and k 128 + 64 rotary, v 128, YaRN as
    published), forward and backward on bf16 products: its attention takes
    the kernel pair, one forward with lse and one backward, none on the
    plain loops.  The backward kernel's gradients, on the operands the layer
    gave it, are within pair_closeness of its plain version.  The layer's
    parameter gradients are no further in RMS from the layer's with every
    product in fp32 than PAIR_GRADS' rms_factor times the same layer's on
    the plain loops.  (Elementwise, parameter gradients after bf16
    activations move by more than an ulp under any change of the order of
    fp32 sums, the plain versions' own included, so only the RMS is held.)"""
    from repro_torch.models import layers

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda)
    gen.manual_seed(30)
    widths = dict(n_heads=16, kv_lora=512, qk_nope=128, qk_rope=64, v_head=128)
    params = pt_attn.mla_init(gen, 2048, **widths, kv_norm=True)
    yarn = layers.Yarn(factor=40.0, original_max_position=4096, beta_fast=32.0, beta_slow=1.0,
                       mscale_all_dim=0.707)
    x = torch.randn((2, 1024, 2048), generator=gen, device=cuda)
    dy = torch.randn((2, 1024, 2048), generator=gen, device=cuda)
    seen = []
    kernel = fa.flash_attention_bwd

    def recording(*args):
        grads = kernel(*args)
        seen.append((args, grads))
        return grads

    def layer_grads():
        p = {name: {key: t.detach().clone().requires_grad_() for key, t in sub.items()}
             for name, sub in params.items()}
        y = pt_attn.mla_apply(p, x, **widths, yarn=yarn, norm_eps=1e-6)
        y.backward(dy.to(y.dtype))
        torch.cuda.synchronize()
        return {f"{name}.{key}": t.grad for name, sub in p.items() for key, t in sub.items()}

    monkeypatch.setattr(pt_attn, "fa", types.SimpleNamespace(
        **{**vars(fa), "flash_attention_bwd": recording}))
    counts = (fa.flash_attention_fwd_lse.launches, kernel.launches, pt_attn.PLAIN_CALLS["cuda"])
    pair = layer_grads()
    assert (fa.flash_attention_fwd_lse.launches - counts[0], kernel.launches - counts[1],
            pt_attn.PLAIN_CALLS["cuda"] - counts[2]) == (1, 1, 0)

    (q, k, v, out, dout, lse, causal, q_offset), got = seen[0]
    assert q.shape[-1] == 192 and v.shape[-1] == 128 and causal and q_offset == 0
    want = fa.flash_attention_bwd_plain(q, k, v, out, dout, lse, causal, q_offset)
    want32 = fa.flash_attention_bwd_plain(*(t.float() for t in (q, k, v, out, dout)), lse,
                                          causal, q_offset)
    zeros = smoke.pair_exact_zeros(q.shape[1], k.shape[1], causal, q_offset, cuda)
    for g, ref, ref32, zero in zip(got, want, want32, zeros, strict=True):
        _assert_pair_close(g, ref, ref32, zero)

    monkeypatch.setattr(pt_attn, "attention_route", lambda *args: "plain")
    plain = layer_grads()
    monkeypatch.setattr(layers.dense_apply, "__defaults__", (torch.float32,))
    exact = layer_grads()
    for name, g in pair.items():
        zero = torch.zeros((1,) * g.ndim, dtype=torch.bool, device=cuda)
        close = smoke.pair_closeness(g, plain[name], exact[name], zero)
        assert close["rms_ratio"] <= smoke.PAIR_GRADS["rms_factor"], (name, close)


# -- the routed experts' grouped products (models/moe.py) ------------------------------------


def _grouped_plain(a, b, ends):
    """``torch._grouped_mm``'s plain version: each group's product of the
    bf16 operands in fp32, rounded to bf16 once."""
    from repro_torch.models import moe

    starts = torch.cat([ends.new_zeros(1), ends[:-1]]).tolist()
    parts = []
    for e, (lo, hi) in enumerate(zip(starts, ends.tolist())):
        if a.dim() == 2 and b.dim() == 3:
            parts.append(a[lo:hi].float() @ b[e].float())
        else:                                  # (M, N) x (N, K) over row groups of N
            parts.append(a[:, lo:hi].float() @ b[lo:hi].float())
    out = torch.cat(parts) if b.dim() == 3 else torch.stack(parts)
    return out.to(torch.bfloat16)


@pytest.mark.parametrize("widths,counts", [
    ((256, 192), [5, 0, 7, 3, 0, 0, 17, 1]),               # empty and odd groups
    ((2048, 1408), [1536] * 60 + [0, 3000, 64, 1]),        # the published widths, uneven
])
def test_grouped_experts_match_per_group_products(cuda, monkeypatch, widths, counts):
    """``moe._GroupedExperts`` forward and backward with ``torch._grouped_mm``
    against the same arithmetic with each group's product in fp32 rounded
    to bf16 once: every result within a relative RMS of 4e-3 (one bf16
    rounding is 2^-9 of a value, and the backward chains three products),
    and the weight gradients of empty groups exactly 0."""
    from repro_torch.models import moe

    d, ff = widths
    gen = torch.Generator(device=cuda).manual_seed(7)
    counts_t = torch.tensor(counts, device=cuda)
    ends = torch.cumsum(counts_t, 0).to(torch.int32)
    n, e = int(counts_t.sum()), len(counts)
    xs = torch.randn(n, d, generator=gen, device=cuda).to(torch.bfloat16)
    ws = [torch.randn(e, d, ff, generator=gen, device=cuda) / d ** 0.5,
          torch.randn(e, d, ff, generator=gen, device=cuda) / d ** 0.5,
          torch.randn(e, ff, d, generator=gen, device=cuda) / ff ** 0.5]
    dy = torch.randn(n, d, generator=gen, device=cuda).to(torch.bfloat16)

    def run():
        x = xs.clone().requires_grad_()
        w = [t.clone().requires_grad_() for t in ws]
        y = moe._GroupedExperts.apply(x, ends, *w)
        y.backward(dy)
        return [y.detach(), x.grad, *(t.grad for t in w)]

    got = run()
    monkeypatch.setattr(moe, "_grouped", _grouped_plain)
    want = run()
    for name, g, w in zip(("y", "dx", "dw_gate", "dw_up", "dw_down"), got, want):
        assert torch.isfinite(g).all(), name
        rel = float((g.float() - w.float()).norm() / w.float().norm())
        assert rel < 4e-3, (name, rel)
    empty = counts_t == 0
    for g in got[2:]:
        assert (g[empty] == 0).all()


# -- AdamW: the fused gradient norm and update (kernels/adamw.py) ------------------------------

#: a tree's leaf shapes: stacked (L, d) and (L, d, f), unstacked (d,) and
#: (d, f), a 0-d leaf, sizes 1, 3 and 4k + 1, and a leaf of many tiles
ADAM_SHAPES = [(3, 64), (3, 64, 40), (64,), (64, 40), (), (1,), (3,), (4 * 1000 + 1,),
               (2, 4 * 257 + 1), (4, 1024, 1000)]


def _adam_tree(cuda, shapes, seed, scale):
    """(params, grads, m, v) leaf lists, fp32 on the card; the moments as a
    few steps leave them (v >= 0)."""
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def draw(shape, s=1.0):
        return s * torch.randn(shape, generator=gen, device=cuda)

    params = [draw(s) for s in shapes]
    grads = [draw(s, scale) for s in shapes]
    m = [draw(s, 0.1) for s in shapes]
    v = [draw(s, 0.1).square() for s in shapes]
    return params, grads, m, v


def _as_trees(params, grads, m, v, step):
    opt = {"m": list(m), "v": list(v), "step": torch.tensor(step, dtype=torch.int32,
                                                            device=params[0].device)}
    return list(params), list(grads), opt


@pytest.mark.parametrize("scale", [3.0, 1e-4], ids=["clipped", "unclipped"])
@pytest.mark.parametrize("step", [0, 7])
def test_adamw_kernel_matches_plain_bit_for_bit(cuda, monkeypatch, scale, step):
    """The update through the kernel equals the plain loop on the card, bit
    for bit, at the same norm; the schedule's 0-d learning rate and a clip
    that acts and one that does not."""
    from repro_torch.kernels import adamw as ka
    from repro_torch.optim import adamw as pt_adamw
    from repro_torch.optim.schedule import warmup_cosine

    cfg = pt_adamw.AdamWConfig(lr=3e-2)
    leaves = _adam_tree(cuda, ADAM_SHAPES, 11 + step, scale)
    copies = [[t.clone() for t in ts] for ts in leaves]
    gnorm = ka.grad_norm(leaves[1])
    assert (float(gnorm) > cfg.grad_clip) == (scale > 1)
    params, grads, opt = _as_trees(*leaves, step)
    lr_scale = warmup_cosine(opt["step"])
    before = ka.adamw_step.launches
    pt_adamw.adamw_update(params, grads, opt, cfg, lr_scale, grad_norm=gnorm)
    assert ka.adamw_step.launches == before + 1
    monkeypatch.setattr(ka, "adamw_step", ka.adamw_step_plain)
    plain_params, plain_grads, plain_opt = _as_trees(*copies, step)
    pt_adamw.adamw_update(plain_params, plain_grads, plain_opt, cfg, lr_scale, grad_norm=gnorm)
    torch.cuda.synchronize()
    for what, got, want in [("params", params, plain_params), ("m", opt["m"], plain_opt["m"]),
                            ("v", opt["v"], plain_opt["v"])]:
        for shape, g, w in zip(ADAM_SHAPES, got, want):
            assert torch.equal(g, w), (what, shape, float((g - w).abs().max()))


def test_adamw_kernel_takes_unaligned_leaves_and_many_launches(cuda, monkeypatch):
    """Leaves that start off a 16-byte boundary (the one-float path) and a
    tree of more leaves than one launch takes, bit for bit as the plain
    loop."""
    from repro_torch.kernels import adamw as ka

    shapes = [(5, 7)] * 70 + [(4 * 500 + 3,)]
    leaves = _adam_tree(cuda, shapes, 5, 1.0)
    leaves = [ts[:-1] + [torch.cat([ts[-1][:1], ts[-1]])[1:]] for ts in leaves]   # offset 4 B
    assert leaves[0][-1].data_ptr() % 16 == 4 and leaves[0][-1].is_contiguous()
    copies = [[t.clone() for t in ts] for ts in leaves]
    scalars = [torch.tensor(x, device=cuda) for x in (0.5, 0.19, 0.0975, 1e-3)]
    ka.adamw_step(*leaves, *scalars, 0.9, 0.95, 1e-8, 0.1)
    ka.adamw_step_plain(*copies, *scalars, 0.9, 0.95, 1e-8, 0.1)
    for what, got, want in zip(("params", "grads", "m", "v"), leaves, copies):
        for i, (g, w) in enumerate(zip(got, want)):
            assert torch.equal(g, w), (what, i)


@pytest.mark.parametrize("shapes", [ADAM_SHAPES, [(5, 7)] * 70, [(64, 1 << 20)]],
                         ids=["tree", "many_leaves", "large"])
def test_adamw_fused_norm_is_close_and_repeats(cuda, shapes):
    """The fused norm within 1e-6 relative of a float64 norm, and the same
    bits on a second run."""
    from repro_torch.kernels import adamw as ka

    grads = _adam_tree(cuda, shapes, 3, 2.0)[1]
    before = ka.sum_of_squares.launches
    first, second = ka.grad_norm(grads), ka.grad_norm(grads)
    assert ka.sum_of_squares.launches == before + 2
    exact = float(torch.sqrt(sum(g.double().square().sum() for g in grads)))
    assert first.dtype == torch.float32 and first.shape == ()
    assert abs(float(first) - exact) <= 1e-6 * exact
    assert torch.equal(first, second)


def test_adamw_given_norm_skips_the_norm_pass(cuda):
    from repro_torch.kernels import adamw as ka
    from repro_torch.optim import adamw as pt_adamw

    params, grads, opt = _as_trees(*_adam_tree(cuda, ADAM_SHAPES[:5], 2, 1.0), 0)
    norm = ka.sum_of_squares.launches
    step = ka.adamw_step.launches
    given = torch.tensor(5.0, device=cuda)
    _, _, metrics = pt_adamw.adamw_update(params, grads, opt, pt_adamw.AdamWConfig(),
                                          grad_norm=given)
    assert ka.sum_of_squares.launches == norm and ka.adamw_step.launches == step + 1
    assert metrics["grad_norm"] is given
    pt_adamw.adamw_update(params, grads, opt, pt_adamw.AdamWConfig())
    assert ka.sum_of_squares.launches == norm + 1 and ka.adamw_step.launches == step + 2


def test_adamw_launches_advance(cuda):
    from repro_torch.kernels import adamw as ka
    from repro_torch.optim import adamw as pt_adamw

    params, grads, opt = _as_trees(*_adam_tree(cuda, ADAM_SHAPES, 4, 1.0), 0)
    launches = (ka.sum_of_squares.launches, ka.adamw_step.launches)
    pt_adamw.adamw_update(params, grads, opt, pt_adamw.AdamWConfig())
    assert (ka.sum_of_squares.launches, ka.adamw_step.launches) == (launches[0] + 1,
                                                                   launches[1] + 1)


def test_adamw_wrappers_refuse_leaves_the_kernel_does_not_take(cuda):
    from repro_torch.kernels import adamw as ka

    p, g, m, v = (ts[:2] for ts in _adam_tree(cuda, [(8, 12), (12,)], 9, 1.0))
    scalars = [torch.tensor(x, device=cuda) for x in (1.0, 0.1, 0.05, 1e-3)]
    consts = (0.9, 0.95, 1e-8, 0.1)
    with pytest.raises(ValueError, match="not contiguous"):
        ka.adamw_step([p[0].t()], [g[0].t()], [m[0].t()], [v[0].t()], *scalars, *consts)
    with pytest.raises(ValueError, match="not contiguous"):
        ka.grad_norm([g[0].t()])
    with pytest.raises(TypeError, match="float32"):
        ka.adamw_step(p, [g[0].bfloat16(), g[1]], m, v, *scalars, *consts)
    with pytest.raises(TypeError, match="float32"):
        ka.adamw_step([t.bfloat16() for t in p], [t.bfloat16() for t in g], m, v, *scalars,
                      *consts)
    with pytest.raises(ValueError, match="several devices"):
        ka.adamw_step([p[0].cpu(), p[1]], g, m, v, *scalars, *consts)
    with pytest.raises(ValueError, match="several devices"):
        ka.adamw_step(p, g, m, v, scalars[0].cpu(), *scalars[1:], *consts)
    with pytest.raises(ValueError, match="several devices"):
        ka.grad_norm([g[0], g[1].cpu()])
    with pytest.raises(ValueError, match="leaf 1"):
        ka.adamw_step(p, [g[0], g[0]], m, v, *scalars, *consts)
