"""The port's data plane against the JAX reference, bit for bit, on the CPU.

The same numpy-seeded bytes go through ``repro`` (its Pallas kernels in
interpret mode, as its own tests run them on the CPU) and ``repro_torch``
with ``device="cpu"`` (each kernel wrapper's plain PyTorch version).  All
of it is integer work, so the tolerance is 0: arrays must be equal.
Sizes stay small because the interpret-mode side is slow.
"""

import itertools

import numpy as np
import pytest
import torch

from repro.core import erasure as jx_erasure
from repro.core import gf256 as jx_gf256
from repro.kernels import ops as jx_ops
from repro.kernels import ref as jx_ref
from repro_torch.core import erasure as pt_erasure
from repro_torch.core import gf256 as pt_gf256
from repro_torch.kernels import ops as pt_ops
from repro_torch.kernels import ref as pt_ref

CPU = "cpu"
CODES = [(3, 2), (6, 3), (10, 4)]
LENGTHS = [1, 33, 1000]


def _rand(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# -- ops: GF matmul, RS encode, stream scaling, XOR folds ----------------------


@pytest.mark.parametrize("k,m", CODES)
@pytest.mark.parametrize("s", [1, 3])
@pytest.mark.parametrize("length", LENGTHS)
def test_gf_matmul_and_rs_encode_stripes_match_reference(k, m, s, length):
    data = _rand(1000 * k + 10 * s + length, (s, k, length))
    parity = jx_gf256.generator_matrix(k, m)[k:]
    want = _np(jx_ops.gf_matmul_bytes_batched(parity, data))
    got = pt_ops.gf_matmul_bytes_batched(parity, data, device=CPU)
    assert got.dtype == torch.uint8 and got.shape == (s, m, length)
    np.testing.assert_array_equal(_np(got), want)
    np.testing.assert_array_equal(_np(pt_ops.rs_encode_stripes(data, k, m, device=CPU)),
                                  _np(jx_ops.rs_encode_stripes(data, k, m)))
    np.testing.assert_array_equal(
        _np(pt_ops.gf_matmul_bytes_batched(parity, data, backend="ref", device=CPU)), want)


@pytest.mark.parametrize("k,m", CODES)
@pytest.mark.parametrize("s", [1, 3])
@pytest.mark.parametrize("length", LENGTHS)
def test_gf_scale_streams_matches_reference(k, m, s, length):
    """Every stripe of the batch through the TriEC data-node stage."""
    data = _rand(2000 * k + 10 * s + length, (s, k, length))
    parity = jx_gf256.generator_matrix(k, m)[k:]
    for stripe in data:
        want = _np(jx_ops.gf_scale_streams(parity, stripe))
        got = pt_ops.gf_scale_streams(parity, stripe, device=CPU)
        assert got.shape == (m, k, length)
        np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("length", [1, 3, 33, 1001])
def test_xor_reduce_bytes_match_reference(length):
    x = _rand(length, (3, 5, length))
    np.testing.assert_array_equal(_np(pt_ops.xor_reduce_bytes_batched(x, device=CPU)),
                                  _np(jx_ops.xor_reduce_bytes_batched(x)))
    np.testing.assert_array_equal(_np(pt_ops.xor_reduce_bytes(x[1], device=CPU)),
                                  _np(jx_ops.xor_reduce_bytes(x[1])))
    np.testing.assert_array_equal(
        _np(pt_ops.xor_reduce_bytes_batched(x, backend="ref", device=CPU)),
        _np(jx_ops.xor_reduce_bytes_batched(x, backend="ref")))


def test_single_stripe_ops_match_reference():
    data = _rand(5, (6, 1000))
    parity = jx_gf256.generator_matrix(6, 3)[6:]
    want = _np(jx_ops.gf_matmul_bytes(parity, data, block_w=None))
    np.testing.assert_array_equal(_np(pt_ops.rs_encode(data, 6, 3, device=CPU)), want)
    np.testing.assert_array_equal(_np(pt_ops.gf_matmul_bytes(parity, data, device=CPU)), want)
    np.testing.assert_array_equal(
        _np(pt_ops.gf_matmul_bytes(parity, data, backend="ref", device=CPU)), want)


@pytest.mark.parametrize("k,m", [(3, 2), (6, 3)])
@pytest.mark.parametrize("length", LENGTHS)
def test_rs_encode_mxu_matches_reference_and_rs_code(k, m, length):
    """The bit-matrix encode: unpack to bits, GF(2) product, pack back."""
    data = _rand(3000 * k + length, (k, length))
    got = pt_ops.rs_encode_mxu(data, k, m, device=CPU)
    assert got.dtype == torch.uint8 and got.shape == (m, length)
    np.testing.assert_array_equal(_np(got),
                                  _np(jx_ops.rs_encode_mxu(data, k, m, block_n=128)))
    np.testing.assert_array_equal(_np(got), jx_erasure.RSCode(k, m).encode(data))


def test_zero_parity_rows_and_empty_length():
    data = _rand(6, (2, 4, 0))
    assert pt_ops.rs_encode_stripes(data, 4, 2, device=CPU).shape == (2, 2, 0)
    assert pt_ops.gf_matmul_bytes_batched(np.zeros((0, 4), np.uint8), _rand(7, (2, 4, 9)),
                                          device=CPU).shape == (2, 0, 9)
    assert pt_ops.gf_scale_streams(np.zeros((0, 4), np.uint8), _rand(8, (4, 9)),
                                   device=CPU).shape == (0, 4, 9)


# -- ref.py oracles ----------------------------------------------------------------


def test_gf_mul_ref_matches_reference_table():
    a = np.repeat(np.arange(256, dtype=np.uint8), 256)
    b = np.tile(np.arange(256, dtype=np.uint8), 256)
    got = pt_ref.gf_mul_ref(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(_np(got), _np(jx_ref.gf_mul_ref(a, b)))
    np.testing.assert_array_equal(_np(got).reshape(256, 256), pt_gf256.full_mul_table())


def test_matmul_oracles_match_reference():
    k, m = 6, 3
    coeffs = jx_gf256.generator_matrix(k, m)[k:]
    data = _rand(k, (3, k, 77))
    c, d = torch.from_numpy(coeffs), torch.from_numpy(data)
    np.testing.assert_array_equal(_np(pt_ref.gf_matmul_ref(c, d[0])),
                                  _np(jx_ref.gf_matmul_ref(coeffs, data[0])))
    np.testing.assert_array_equal(_np(pt_ref.gf_matmul_batched_ref(c, d)),
                                  _np(jx_ref.gf_matmul_batched_ref(coeffs, data)))
    np.testing.assert_array_equal(_np(pt_ref.rs_encode_ref(d[1], k, m)),
                                  _np(jx_ref.rs_encode_ref(data[1], k, m)))
    np.testing.assert_array_equal(_np(pt_ref.xor_reduce_ref(d[2])),
                                  _np(jx_ref.xor_reduce_ref(data[2])))


def test_bitplane_oracles_match_reference_and_round_trip():
    data = _rand(11, (2, 3, 128))
    planes = pt_ref.pack_bitplanes(torch.from_numpy(data))
    assert planes.dtype == torch.uint32 and planes.shape == (2, 3, 8, 4)
    np.testing.assert_array_equal(_np(planes), _np(jx_ref.pack_bitplanes(data)))
    np.testing.assert_array_equal(_np(planes), jx_gf256.bytes_to_bitplanes(data))
    np.testing.assert_array_equal(_np(pt_ref.unpack_bitplanes(planes)), data)
    words = _rand(12, (2, 8, 5 * 4)).view(np.uint32)  # every bit pattern, incl. bit 31
    np.testing.assert_array_equal(_np(pt_ref.unpack_bitplanes(torch.from_numpy(words))),
                                  _np(jx_ref.unpack_bitplanes(words)))
    np.testing.assert_array_equal(_np(pt_ref.pack_bitplanes(pt_ref.unpack_bitplanes(
        torch.from_numpy(words)))), words)


@pytest.mark.parametrize("k,m", [(3, 2), (6, 3)])
def test_bitsliced_oracle_matches_reference(k, m):
    bitmat = jx_gf256.parity_bitmatrix(jx_gf256.generator_matrix(k, m)[k:])
    planes = jx_gf256.bytes_to_bitplanes(_rand(k + m, (k, 64)))
    got = pt_ref.gf_matmul_bitsliced_ref(torch.from_numpy(bitmat.copy()),
                                         torch.from_numpy(planes))
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(_np(got), _np(jx_ref.gf_matmul_bitsliced_ref(bitmat, planes)))


# -- erasure layer --------------------------------------------------------------


def _patterns(n, m):
    return [p for r in range(m + 1) for p in itertools.combinations(range(n), r)]


def test_rs32_decode_stripes_every_erasure_pattern_matches_reference():
    k, m = 3, 2
    jx_code, pt_code = jx_erasure.RSCode(k, m), pt_erasure.RSCode(k, m)
    data = _rand(21, (4, k, 100))
    parity = pt_code.encode_stripes(data, device=CPU)
    np.testing.assert_array_equal(parity, jx_code.encode_stripes(data))
    full = [data[:, i] for i in range(k)] + [parity[:, i] for i in range(m)]
    patterns = _patterns(k + m, m)
    assert len(patterns) == 16
    for lost in patterns:
        shards = [None if i in lost else s for i, s in enumerate(full)]
        got = pt_code.decode_stripes(shards, device=CPU)
        np.testing.assert_array_equal(got, jx_code.decode_stripes(shards))
        np.testing.assert_array_equal(got, data)


@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_decode_stripes_too_many_losses_raises(backend):
    code = pt_erasure.RSCode(3, 2)
    data = _rand(22, (2, 3, 40))
    parity = code.encode_stripes(data, backend="numpy")
    shards = [None, None, None, parity[:, 0], parity[:, 1]]
    with pytest.raises(ValueError, match="unrecoverable"):
        code.decode_stripes(shards, backend=backend, device=CPU)
    with pytest.raises(ValueError, match="unrecoverable"):
        jx_erasure.RSCode(3, 2).decode_stripes(shards)


def test_single_stripe_encode_decode_match_reference():
    jx_code, pt_code = jx_erasure.RSCode(6, 3), pt_erasure.RSCode(6, 3)
    data = _rand(23, (6, 1000))
    parity = pt_code.encode(data, backend="torch", device=CPU)
    np.testing.assert_array_equal(parity, jx_code.encode(data, backend="jax"))
    shards = list(data) + list(parity)
    for slot in (0, 4, 7):
        shards[slot] = None
    got = pt_code.decode(shards, backend="torch", device=CPU)
    np.testing.assert_array_equal(got, jx_code.decode(shards, backend="jax"))
    np.testing.assert_array_equal(got, data)


@pytest.mark.parametrize("k,m,length,packet", [(3, 2, 1000, 64), (6, 3, 4097, 512)])
@pytest.mark.parametrize("interleaved", [True, False])
def test_stream_encode_matches_reference(k, m, length, packet, interleaved):
    data = _rand(length, (k, length))
    got = pt_erasure.stream_encode(pt_erasure.RSCode(k, m), data, packet, pool_size=512,
                                   interleaved=interleaved, backend="torch", device=CPU)
    want = jx_erasure.stream_encode(jx_erasure.RSCode(k, m), data, packet, pool_size=512,
                                    interleaved=interleaved, backend="jax")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pt_erasure.stream_encode_packets(
        pt_erasure.RSCode(k, m), data, packet, pool_size=512, interleaved=interleaved))


def test_stream_encode_pool_exhaustion_message_matches_reference():
    data = _rand(31, (3, 64 * 40))

    def message(module, **backend):
        with pytest.raises(RuntimeError, match="accumulator pool exhausted") as info:
            module.stream_encode(module.RSCode(3, 2), data, 64, pool_size=8,
                                 interleaved=False, **backend)
        return str(info.value)

    want = message(jx_erasure, backend="jax")
    assert "(88 packets fell back)" in want
    assert message(pt_erasure, backend="torch", device=CPU) == want
    assert message(pt_erasure, backend="numpy") == want
