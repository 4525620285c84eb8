"""The GF kernels' arithmetic, emulated on the CPU, against the JAX reference.

The CUDA kernels in ``repro_torch/kernels/csrc/`` cannot run here, so
this file holds what they take from the host (the matmul's bit-field
tables, the GF(2) product's packed row masks) bit for bit against
``repro.core.gf256``, and replays their word-level arithmetic in torch:
PTX ``prmt`` in its generic mode (3-bit byte selectors, bit 3 of a
selector nibble replicating the selected byte's sign bit), the kernel's
``split`` (selectors gathered by a wrapping 32-bit multiply) and
``mul4_fields`` with its zero and unit coefficient branches and swapped
byte order (in the matmul, and in the stream scaling, which stores every
product without the fold), and the GF(2) kernel's bit packing, AND-XOR
accumulation and bytewise parity.  The emulations run on seeded inputs
against ``repro.kernels.ref`` and the reference's Pallas kernels
``gf_scale_bitsliced`` and ``gf_matmul_mxu`` (interpret mode).  All of it is integer work: tolerance 0.  Words are u32 values
held in int64 tensors, since torch has no shifts on uint32 on the CPU.
"""

import itertools

import numpy as np
import pytest
import torch

from repro.core import gf256 as jx_gf256
from repro.kernels import gf256_encode as jx_ge
from repro.kernels import ops as jx_ops
from repro.kernels import ref as jx_ref
from repro_torch.kernels import gf256_encode as ge
from repro_torch.kernels import ops as pt_ops

U32 = 0xFFFFFFFF


def _rand(seed, shape, low=0, high=256, dtype=np.uint8):
    return np.random.default_rng(seed).integers(low, high, shape, dtype=dtype)


# -- the kernels' word arithmetic, replayed -----------------------------------------


def prmt(a, b, sel):
    """``prmt.b32 d, a, b, sel`` (generic mode) elementwise: byte i of d is
    byte ``sel[4i+2:4i]`` of {b, a}, or its sign bit replicated when bit
    ``4i+3`` of ``sel`` is set."""
    a, b = torch.as_tensor(a, dtype=torch.int64), torch.as_tensor(b, dtype=torch.int64)
    sel = torch.as_tensor(sel, dtype=torch.int64)
    out = torch.zeros(torch.broadcast_shapes(a.shape, b.shape, sel.shape), dtype=torch.int64)
    for i in range(4):
        s = (sel >> (4 * i)) & 15
        index = s & 7
        byte = (torch.where(index < 4, a, b) >> (8 * (index & 3))) & 0xFF
        sign = torch.where((byte & 0x80) != 0, 0xFF, 0)
        out |= torch.where((s & 8) != 0, sign, byte) << (8 * i)
    return out


def swap12(x):
    """gf256_encode.cu ``swap12``: bytes 0, 2, 1, 3 of x."""
    return prmt(x, 0, 0x3120)


def split(x):
    """gf256_encode.cu ``split``: the 3 selectors of word x (32-bit
    multiplies, so the product wraps) and x in their byte order."""
    def window(mask, shift):
        return (((x & mask) * 0x1001) & U32) >> shift

    return (window(0x07070707, 12), window(0x38383838, 15), window(0xC0C0C0C0, 18), swap12(x))


def mul4_fields(ab, c4, fields):
    """gf256_encode.cu ``mul4_fields``: c * x bytewise, bytes 1 and 2
    swapped, through c's tables (``ab``: T_a and T_b as 4 little-endian
    words, ``c4``: T_c as one)."""
    a, b, c, _ = fields
    return prmt(ab[0], ab[1], a) ^ prmt(ab[2], ab[3], b) ^ prmt(c4, 0, c)


def _words(data: torch.Tensor) -> torch.Tensor:
    """(..., 4w) uint8 -> (..., w) little-endian u32 words in int64."""
    b = data.to(torch.int64).reshape(*data.shape[:-1], -1, 4)
    return b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)


def _bytes(words: torch.Tensor) -> torch.Tensor:
    shifts = torch.tensor([0, 8, 16, 24])
    return ((words[..., None] >> shifts) & 0xFF).to(torch.uint8).flatten(-2)


def _pad(data: torch.Tensor, multiple: int) -> torch.Tensor:
    """Zero bytes past L up to a multiple: what the byte path loads there."""
    extra = -data.shape[-1] % multiple
    return torch.nn.functional.pad(data, (0, extra)) if extra else data


def emulate_gf_matmul(coeffs: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """gf_matmul_kernel's arithmetic: (n, k) x (S, k, L) -> (S, n, L)."""
    tables = _words(ge.field_tables(coeffs))           # (n, k, 8): T_a T_b, T_c, zeros
    length = data.shape[-1]
    x = _words(_pad(data, 16))                          # (S, k, W)
    n, k = coeffs.shape
    acc = torch.zeros((x.shape[0], n, x.shape[2]), dtype=torch.int64)
    for j in range(k):
        fields = split(x[:, j])
        for t in range(n):
            words = tables[t, j].tolist()
            c = (words[0] >> 8) & 0xFF
            if c == 0:
                continue
            acc[:, t] ^= fields[3] if c == 1 else mul4_fields(words[:4], words[4], fields)
    return _bytes(swap12(acc))[..., :length]


def emulate_gf_scale(coeffs: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """gf_scale_kernel's arithmetic: (m, k) x (k, L) -> (m, k, L), each
    product stored as it is made: zeros for a zero coefficient, the word
    itself for a unit one, else the lookups with bytes 1 and 2 swapped back."""
    tables = _words(ge.field_tables(coeffs))           # (m, k, 8)
    length = data.shape[-1]
    x = _words(_pad(data, 16))                          # (k, W)
    m, k = coeffs.shape
    out = torch.zeros((m, k, x.shape[1]), dtype=torch.int64)
    for j in range(k):
        fields = split(x[j])
        for t in range(m):
            words = tables[t, j].tolist()
            c = (words[0] >> 8) & 0xFF
            if c == 1:
                out[t, j] = x[j]
            elif c != 0:
                out[t, j] = swap12(mul4_fields(words[:4], words[4], fields))
    return _bytes(out)[..., :length]


def emulate_gf_mxu(bigmat: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """gf_mxu_kernel's arithmetic: (em, ek) x (ek, n) -> (em, n) int8."""
    masks = ge.row_masks(bigmat).to(torch.int64) * 0x01010101   # replicated words
    n = bits.shape[1]
    x = _words(_pad(bits.view(torch.uint8), 4))                  # (ek, W)
    acc = torch.zeros((bigmat.shape[0], x.shape[1]), dtype=torch.int64)
    for j in range(bigmat.shape[1] // 8):
        packed = torch.zeros_like(x[0])
        for r in range(8):
            packed |= (x[8 * j + r] & 0x01010101) << r
        acc ^= packed[None, :] & masks[:, j:j + 1]
    acc ^= acc >> 4
    acc ^= acc >> 2
    acc ^= acc >> 1
    return _bytes(acc & 0x01010101)[:, :n].view(torch.int8)


# -- what the kernels take from the host ----------------------------------------------


def test_field_tables_hold_every_product():
    """All 256 x 256 (c, x): t[x & 7] ^ t[8 + ((x >> 3) & 7)] ^ t[16 + (x >> 6)]
    == c * x, t[1] == c, and the padding is zero."""
    coeffs = torch.arange(256, dtype=torch.int64).to(torch.uint8).reshape(16, 16)
    tables = ge.field_tables(coeffs).reshape(256, 32).to(torch.int64)
    x = torch.arange(256)
    got = tables[:, x & 7] ^ tables[:, 8 + ((x >> 3) & 7)] ^ tables[:, 16 + (x >> 6)]
    want = jx_gf256.gf_mul_vec(np.arange(256, dtype=np.uint8)[:, None],
                               np.arange(256, dtype=np.uint8)[None, :])
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tables[:, 1].numpy(), np.arange(256))
    np.testing.assert_array_equal(tables[:, 0].numpy(), 0)
    np.testing.assert_array_equal(tables[:, 20:].numpy(), 0)


def test_field_tables_follow_the_coefficient_layout():
    coeffs = torch.from_numpy(_rand(1, (5, 7)))
    tables = ge.field_tables(coeffs)
    assert tables.shape == (5, 7, 32) and tables.dtype == torch.uint8
    full = jx_gf256.full_mul_table()
    for i, j in itertools.product(range(5), range(7)):
        c = int(coeffs[i, j])
        np.testing.assert_array_equal(tables[i, j].numpy(), full[c, list(ge.FIELD_OPERANDS)])


@pytest.mark.parametrize("em,ek", [(8, 8), (24, 48), (16, 2040)])
def test_row_masks_pack_the_low_bits(em, ek):
    bigmat = torch.from_numpy(_rand(em + ek, (em, ek), -128, 128, np.int8))
    masks = ge.row_masks(bigmat)
    assert masks.shape == (em, ek // 8) and masks.dtype == torch.uint8
    low = bigmat.numpy().astype(np.int64) & 1
    want = (low.reshape(em, ek // 8, 8) << np.arange(8)).sum(-1)
    np.testing.assert_array_equal(masks.numpy(), want)


def test_ops_cache_the_tables_and_masks_per_matrix(monkeypatch):
    parity = jx_gf256.generator_matrix(6, 3)[6:]
    key = (parity.tobytes(), 3, 6, torch.device("cpu"))
    tables = pt_ops._tables_device(*key)
    assert tables is pt_ops._tables_device(*key)
    assert torch.equal(tables, ge.field_tables(torch.from_numpy(parity.copy())))
    # the matmul and the stream scaling are handed those cached tables
    passed = []
    for name in ("gf_matmul_bytes_batched", "gf_scale_bytes"):
        monkeypatch.setattr(ge, name, lambda c, d, t, name=name: passed.append((name, t)))
    data = _rand(2, (6, 40))
    pt_ops.gf_matmul_bytes_batched(parity, data[None], device="cpu")
    pt_ops.gf_scale_streams(parity, data, device="cpu")
    assert [name for name, _ in passed] == ["gf_matmul_bytes_batched", "gf_scale_bytes"]
    assert all(t is tables for _, t in passed)
    masks = pt_ops._rs_block_masks(6, 3, "cauchy", torch.device("cpu"))
    assert torch.equal(masks, ge.row_masks(pt_ops.rs_block_bitmatrix(6, 3, "cauchy",
                                                                     torch.device("cpu"))))


# -- prmt and the split lookup ----------------------------------------------------------


def test_prmt_emulation_selects_and_replicates_signs():
    a, b = 0x84_03_82_01, 0x08_87_06_85
    assert int(prmt(a, b, 0x3210)) == a and int(prmt(a, b, 0x7654)) == b
    assert int(prmt(a, b, 0x0527)) == 0x01_06_03_08
    # bit 3 set: bytes 0-3 of a replicated from their sign bits
    assert int(prmt(a, b, 0xBA98)) == 0xFF_00_FF_00


def test_split_gathers_each_field_in_the_swapped_byte_order():
    """The multiply leaves no carries: for every byte value in each of the
    four positions, selector nibble i holds the field of byte (0, 2, 1, 3)[i],
    and bit 3 of every selector nibble is clear."""
    order = (0, 2, 1, 3)
    for pos in range(4):
        x = torch.arange(256, dtype=torch.int64) << (8 * pos)
        x |= 0x5A5A5A5A & ~(0xFF << (8 * pos))            # other bytes set too
        for sel, (shift, width) in zip(split(x)[:3], [(0, 3), (3, 3), (6, 2)]):
            for i in range(4):
                byte = (x >> (8 * order[i])) & 0xFF
                field = (byte >> shift) & ((1 << width) - 1)
                assert torch.equal((sel >> (4 * i)) & 15, field)


@pytest.mark.parametrize("seed", range(4))
def test_split_lookup_multiplies_every_byte(seed):
    """Every coefficient times words that hold every byte value in each of
    their four positions, plus seeded words."""
    rng = np.random.default_rng(seed)
    cols = [np.roll(np.arange(256, dtype=np.uint8), 64 * p + seed) for p in range(4)]
    data = np.concatenate([np.stack(cols, axis=1).reshape(-1),
                           rng.integers(0, 256, 1024, dtype=np.uint8)])
    x = _words(torch.from_numpy(data))
    fields = split(x)
    tables = _words(ge.field_tables(torch.arange(256).to(torch.uint8)[None, :]))[0]
    full = jx_gf256.full_mul_table()
    for c in range(256):
        got = swap12(mul4_fields(tables[c, :4].tolist(), int(tables[c, 4]), fields))
        np.testing.assert_array_equal(_bytes(got).numpy(), full[c, data])


def _decode_inverse(lost):
    g = jx_gf256.generator_matrix(6, 3)
    return jx_gf256.gf_mat_inv(g[[i for i in range(9) if i not in lost]])


_ROW_ONES = np.eye(4, dtype=np.uint8)
_ROW_ONES[2] = 0                                     # an all-zero row
MATMUL_CASES = {
    "rs63 parity": jx_gf256.generator_matrix(6, 3)[6:],
    "rs63 decode (0,1,2)": _decode_inverse((0, 1, 2)),
    "rs63 decode (2,5,7)": _decode_inverse((2, 5, 7)),
    "identity": np.eye(6, dtype=np.uint8),
    "identity with a zero row": _ROW_ONES,
    "all ones": np.ones((3, 5), dtype=np.uint8),
    "all zeros": np.zeros((2, 3), dtype=np.uint8),
    "random (10,4)": _rand(5, (4, 10)),
    "random 9 rows": _rand(6, (9, 3)),
}


@pytest.mark.parametrize("case", sorted(MATMUL_CASES))
@pytest.mark.parametrize("length", [1, 16, 36, 100, 1000])
def test_emulated_gf_matmul_matches_reference(case, length):
    coeffs = MATMUL_CASES[case]
    n, k = coeffs.shape
    data = _rand(n * 100 + k * 10 + length, (2, k, length))
    want = np.asarray(jx_ref.gf_matmul_batched_ref(coeffs, data))
    got = emulate_gf_matmul(torch.from_numpy(coeffs.copy()), torch.from_numpy(data))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", sorted(MATMUL_CASES))
@pytest.mark.parametrize("length", [1, 16, 36, 100, 1000])
def test_emulated_gf_scale_matches_reference(case, length):
    """Against the reference's stream scaling, its Pallas kernel
    ``gf_scale_bitsliced`` in interpret mode."""
    coeffs = MATMUL_CASES[case]
    m, k = coeffs.shape
    data = _rand(m * 100 + k * 10 + length + 7, (k, length))
    want = np.asarray(jx_ops.gf_scale_streams(coeffs, data))
    got = emulate_gf_scale(torch.from_numpy(coeffs.copy()), torch.from_numpy(data))
    assert got.shape == (m, k, length)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ge.gf_scale_bytes_plain(torch.from_numpy(coeffs.copy()),
                                                          torch.from_numpy(data)).numpy(), want)


def test_decode_inverses_of_rs63_are_mostly_zeros_and_units():
    """What the zero and unit branches save: over all 84 patterns of 3
    erasures, each inverted (6, 6) matrix keeps as many general (> 1)
    coefficients as the (3, 6) parity matrix has, or fewer."""
    general = (jx_gf256.generator_matrix(6, 3)[6:] > 1).sum()
    counts = [(_decode_inverse(lost) > 1).sum()
              for lost in itertools.combinations(range(9), 3)]
    assert len(counts) == 84 and max(counts) <= general


# -- the packed-parity GF(2) product --------------------------------------------------


@pytest.mark.parametrize("em,ek,n", [(8, 8, 64), (24, 48, 128), (24, 48, 36), (16, 2040, 8),
                                     (32, 16, 20)])
def test_emulated_gf_mxu_matches_reference(em, ek, n):
    """Any int8 values (only the low bits count), against the reference's
    Pallas kernel in interpret mode."""
    bigmat = _rand(em * ek, (em, ek), -128, 128, np.int8)
    bits = _rand(n + ek, (ek, n), -128, 128, np.int8)
    want = np.asarray(jx_ge.gf_matmul_mxu(bigmat, bits, block_n=n))
    got = emulate_gf_mxu(torch.from_numpy(bigmat), torch.from_numpy(bits))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ge.gf_matmul_mxu_plain(torch.from_numpy(bigmat),
                                                         torch.from_numpy(bits)).numpy(), want)


def test_emulated_gf_mxu_of_a_zero_matrix_is_zero():
    bits = torch.from_numpy(_rand(3, (48, 40), -128, 128, np.int8))
    got = emulate_gf_mxu(torch.zeros((24, 48), dtype=torch.int8), bits)
    assert got.dtype == torch.int8 and not got.any()
