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
8-row load group and more stripes than a grid dimension may hold.
"""

import itertools

import numpy as np
import pytest
import torch

from repro_torch.core import gf256
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gf256_encode as ge
from repro_torch.kernels import ops
from repro_torch.kernels import xor_reduce as xr
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
    _assert_close(got, fa.flash_attention_fwd_plain(q, k, v, causal), dtype)


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
                                                    v.contiguous(), True), dtype)


@pytest.mark.parametrize("rep", [1, 4, 8])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_flash_attention_gqa_groups(cuda, rep, causal, dtype):
    """Every query head reads kv head h // rep, over several q and KV tiles."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(100 + rep)
    q, k, v = _qkv(rng, 2, 300, 2 * rep, 2, 128, 128, dtype, cuda)
    got = fa.flash_attention_fwd(q, k, v, causal)
    _assert_close(got, fa.flash_attention_fwd_plain(q, k, v, causal), dtype)


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
    _assert_close(got, fa.flash_attention_fwd_plain(q, k, v, causal, q_offset), dtype)


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
    _assert_close(got, fa.flash_attention_fwd_plain(q, k, v, True), torch.bfloat16)


def test_ops_flash_attention_on_card_launches_the_kernel(cuda):
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(12)
    q, k, v = (t.numpy() for t in _qkv(rng, 1, 130, 4, 4, 64, 64, torch.float32, "cpu"))
    before = fa.flash_attention_fwd.launches
    got = ops.flash_attention(q, k, v, device=cuda)
    assert fa.flash_attention_fwd.launches == before + 1
    on_card = [torch.from_numpy(x).to(cuda) for x in (q, k, v)]
    _assert_close(got, fa.flash_attention_fwd_plain(*on_card, True), torch.float32)
    # across devices, the reference's elementwise bound: the host CPU's fp32
    # products need not round as the card's do
    want = ops.flash_attention(q, k, v, backend="kernel", device="cpu")
    torch.testing.assert_close(got.cpu(), want, rtol=3e-4, atol=3e-4)


def test_flash_attention_is_forward_only_on_card(cuda):
    rng = np.random.default_rng(14)
    q, k, v = _qkv(rng, 1, 64, 4, 2, 64, 64, torch.bfloat16, cuda)
    before = fa.flash_attention_fwd.launches
    with pytest.raises(RuntimeError, match="no backward"):
        fa.flash_attention_fwd(q.requires_grad_(), k, v)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention(q, k, v, backend="kernel", device=cuda)
    # a gradient routes the dispatch to the differentiable blockwise path
    out = ops.flash_attention(q, k, v, device=cuda)
    assert out.requires_grad
    assert torch.equal(out.detach(), blockwise_attention(q.detach(), k, v, True, 512, 0))
    assert fa.flash_attention_fwd.launches == before
    with torch.no_grad():
        got = ops.flash_attention(q, k, v, device=cuda)
    assert fa.flash_attention_fwd.launches == before + 1
    _assert_close(got, fa.flash_attention_fwd_plain(q.detach(), k, v, True), torch.bfloat16)


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
