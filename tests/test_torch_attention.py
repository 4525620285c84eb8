"""The port's attention layer against the JAX reference, on the CPU.

The same numpy-seeded inputs, and params made by ``repro``'s own
``*_init(jax.random.PRNGKey(0), ...)`` carried across with
``params_from_numpy``, go through ``repro`` and ``repro_torch``
(``device="cpu"``).  The reference's flash kernel runs as its own tests
run it: Pallas in interpret mode.  Tolerances, each with its reason:

* fp32 attention: 2e-4 (forward) and 3e-3 (gradients), the reference's
  own (tests/test_attention.py); the plain flash version against the
  Pallas kernel: 3e-4 (tests/test_kernels.py);
* one bf16 rounding (a dense layer, a rotation): 1e-2, since XLA and torch
  may sum in another order and round one ulp (2^-8) apart;
* whole bf16 layers (projections, attention, output projection): 3e-2,
  because those one-ulp flips compound through three rounded stages;
* decode against prefill: 0.1, the reference's own (bf16 accumulation
  differences between the two paths).

The reference's layer functions run under ``jax.jit`` (the same functions,
compiled whole rather than op by op, which keeps this file fast).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jx_ops
from repro.kernels.flash_attention import flash_attention_fwd as jx_flash_fwd
from repro.models import attention as jx_attn
from repro.models import layers as jx_layers
from repro_torch.kernels import flash_attention as pt_flash
from repro_torch.models import attention as pt_attn
from repro_torch.models import layers as pt_layers
from repro_torch.models.convert import params_from_numpy, params_to_numpy

CPU = "cpu"
ONE_ROUNDING = 1e-2
BF16_LAYER = 3e-2
GQA = dict(n_heads=4, n_kv_heads=2, head_dim=16)
MLA = dict(n_heads=4, kv_lora=32, qk_nope=16, qk_rope=8, v_head=16)
D_MODEL = 64


def _carry(tree):
    """A ``repro`` params pytree as the port's dict of CPU tensors."""
    return params_from_numpy(jax.device_get(tree), device=CPU)


def _pair(x: np.ndarray, dtype: str):
    """The same float32 values as a jnp and a torch array of ``dtype``."""
    return jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(getattr(torch, dtype))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _jit(fn, **static):
    """``fn`` with its static arguments bound, jit-compiled."""
    return jax.jit(lambda *arrays, **kw: fn(*arrays, **kw, **static))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _gqa_params():
    return _jit(jx_attn.gqa_init, d_model=D_MODEL, **GQA)(jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _mla_params():
    return _jit(jx_attn.mla_init, d_model=D_MODEL, **MLA)(jax.random.PRNGKey(0))


# -- params carried across ---------------------------------------------------------


#: (reference init, port init) of every layer, at small widths
INITS = {
    "dense": (lambda key: jx_layers.dense_init(key, 8, 12, bias=True),
              lambda gen: pt_layers.dense_init(gen, 8, 12, bias=True)),
    "rmsnorm": (lambda key: jx_layers.rmsnorm_init(8),
                lambda gen: pt_layers.rmsnorm_init(8, device=CPU)),
    "layernorm": (lambda key: jx_layers.layernorm_init(8),
                  lambda gen: pt_layers.layernorm_init(8, device=CPU)),
    "swiglu": (lambda key: jx_layers.swiglu_init(key, 8, 16),
               lambda gen: pt_layers.swiglu_init(gen, 8, 16)),
    "gelu_mlp": (lambda key: jx_layers.gelu_mlp_init(key, 8, 16),
                 lambda gen: pt_layers.gelu_mlp_init(gen, 8, 16)),
    "embed": (lambda key: jx_layers.embed_init(key, 10, 8),
              lambda gen: pt_layers.embed_init(gen, 10, 8)),
    "gqa": (lambda key: jx_attn.gqa_init(key, 32, 4, 2, 8, qkv_bias=True),
            lambda gen: pt_attn.gqa_init(gen, 32, 4, 2, 8, qkv_bias=True)),
    "mla": (lambda key: jx_attn.mla_init(key, 32, 4, 16, 8, 4, 8),
            lambda gen: pt_attn.mla_init(gen, 32, 4, 16, 8, 4, 8)),
}


def _layout(tree):
    if isinstance(tree, dict):
        return {key: _layout(value) for key, value in tree.items()}
    return tuple(tree.shape), np.dtype(tree.dtype).name


@pytest.mark.parametrize("name", sorted(INITS))
def test_init_gives_the_reference_layout(name):
    """Same names, shapes and dtypes as ``repro``'s init, so params carry
    across either way."""
    jx_init, pt_init = INITS[name]
    want = jax.eval_shape(jx_init, jax.random.PRNGKey(0))
    got = pt_init(torch.Generator().manual_seed(0))
    assert _layout(params_to_numpy(got)) == _layout(want)


def test_params_round_trip_through_numpy_keeps_every_value():
    tree = jax.device_get({"gqa": _gqa_params(),
                           "cache": jnp.asarray(_normal(1, (2, 3)), jnp.bfloat16)})
    carried = params_from_numpy(tree, device=CPU)
    assert carried["cache"].dtype == torch.bfloat16
    np.testing.assert_array_equal(carried["cache"].float().numpy(),
                                  tree["cache"].astype(np.float32))
    back = params_to_numpy(carried)
    for key in ("wq", "wk", "wv", "wo"):
        np.testing.assert_array_equal(back["gqa"][key]["w"], tree["gqa"][key]["w"])
    assert back["cache"].dtype == np.float32


# -- layers.py ----------------------------------------------------------------------


@pytest.mark.parametrize("bias", [False, True])
def test_dense_apply_matches_reference(bias):
    p = jax.device_get(jx_layers.dense_init(jax.random.PRNGKey(2), 32, 24, bias=bias))
    if bias:
        p["b"] = _normal(3, (24,))
    x = _normal(4, (5, 32))
    want = jx_layers.dense_apply(p, jnp.asarray(x))
    got = pt_layers.dense_apply(params_from_numpy(p, device=CPU), torch.from_numpy(x))
    assert got.dtype == torch.bfloat16 and got.shape == (5, 24)
    _close(got, want, ONE_ROUNDING)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", ONE_ROUNDING)])
def test_norms_match_reference(dtype, tol):
    x = _normal(5, (3, 7, 16)) * 3 + 1
    jx, pt = _pair(x, dtype)
    scale, bias = _normal(6, (16,)), _normal(7, (16,))
    rms = {"scale": scale}
    ln = {"scale": scale, "bias": bias}
    got = pt_layers.rmsnorm_apply(params_from_numpy(rms, device=CPU), pt)
    assert got.dtype == pt.dtype
    _close(got, jx_layers.rmsnorm_apply(rms, jx), tol)
    _close(pt_layers.layernorm_apply(params_from_numpy(ln, device=CPU), pt),
           jx_layers.layernorm_apply(ln, jx), tol)


@pytest.mark.parametrize("kind", ["swiglu", "gelu_mlp"])
def test_mlps_match_reference(kind):
    p = _jit(getattr(jx_layers, f"{kind}_init"), d=32, d_ff=64)(jax.random.PRNGKey(8))
    x = _normal(9, (2, 5, 32))
    want = _jit(getattr(jx_layers, f"{kind}_apply"))(p, jnp.asarray(x))
    got = getattr(pt_layers, f"{kind}_apply")(_carry(p), torch.from_numpy(x))
    _close(got, want, BF16_LAYER)


def test_embed_matches_reference_exactly():
    p = jx_layers.embed_init(jax.random.PRNGKey(10), 50, 16)
    tokens = np.random.default_rng(11).integers(0, 50, (2, 9), dtype=np.int32)
    want = jx_layers.embed_apply(p, jnp.asarray(tokens))
    got = pt_layers.embed_apply(_carry(p), torch.from_numpy(tokens))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", ONE_ROUNDING)])
def test_rope_matches_reference(dtype, tol):
    np.testing.assert_allclose(pt_layers.rope_freqs(32, 5e5, device=CPU).numpy(),
                               np.asarray(jx_layers.rope_freqs(32, 5e5)), rtol=1e-6)
    x = _normal(12, (2, 40, 3, 32))
    positions = np.arange(40)[None, :] + np.array([[0], [100]])
    jx, pt = _pair(x, dtype)
    want = jx_layers.apply_rope(jx, jnp.asarray(positions), 1e4)
    got = pt_layers.apply_rope(pt, torch.from_numpy(positions), 1e4)
    assert got.dtype == pt.dtype
    _close(got, want, tol)


def test_chunked_cross_entropy_matches_reference():
    hidden = _normal(13, (2, 32, 16))
    unembed = _normal(14, (16, 50))
    labels = np.random.default_rng(15).integers(0, 50, (2, 32), dtype=np.int32)
    want = jx_layers.chunked_cross_entropy(jnp.asarray(hidden), jnp.asarray(unembed),
                                           jnp.asarray(labels), chunk=8)
    got = pt_layers.chunked_cross_entropy(torch.from_numpy(hidden), torch.from_numpy(unembed),
                                          torch.from_numpy(labels), chunk=8)
    _close(got, want, ONE_ROUNDING)
    with pytest.raises(ValueError, match="multiple of chunk"):
        pt_layers.chunked_cross_entropy(torch.from_numpy(hidden), torch.from_numpy(unembed),
                                        torch.from_numpy(labels), chunk=5)


# -- blockwise attention: forward and gradients -----------------------------------------

CASES = [
    (2, 64, 4, 2, 16, 16, True),
    (1, 48, 8, 8, 8, 32, True),      # MHA
    (2, 64, 4, 1, 16, 16, False),    # MQA, bidirectional
    (2, 40, 6, 2, 16, 16, True),     # ragged block count
    (1, 33, 3, 3, 8, 16, True),      # non-divisible seq/block
]


def _qkv(seed, b, s, h, hkv, d, dv=None):
    rng = np.random.default_rng(seed)
    dv = d if dv is None else dv
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, dv)))


@pytest.mark.parametrize("b,s,h,hkv,d,blk,causal", CASES)
def test_blockwise_forward_matches_reference(b, s, h, hkv, d, blk, causal):
    q, k, v = _qkv(s * h, b, s, h, hkv, d)
    want = _jit(jx_attn.blockwise_attention, causal=causal, block=blk)(
        *map(jnp.asarray, (q, k, v)))
    got = pt_attn.blockwise_attention(*map(torch.from_numpy, (q, k, v)), causal, blk, 0)
    _close(got, want, 2e-4)


@pytest.mark.parametrize("b,s,h,hkv,d,blk,causal", CASES[:3])
def test_blockwise_gradients_match_reference_and_autodiff(b, s, h, hkv, d, blk, causal):
    q, k, v = _qkv(7, b, s, h, hkv, d)

    def jx_loss(q, k, v):
        return (jx_attn.blockwise_attention(q, k, v, causal, blk, 0) ** 2).sum()

    want = jax.jit(jax.grad(jx_loss, argnums=(0, 1, 2)))(*map(jnp.asarray, (q, k, v)))

    def pt_grads(fn):
        leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        (fn(*leaves, causal, blk, 0) ** 2).sum().backward()
        return [leaf.grad for leaf in leaves]

    got = pt_grads(pt_attn.blockwise_attention)
    oracle = pt_grads(pt_attn._blockwise_attention_autodiff)
    for g, w, o in zip(got, want, oracle):
        _close(g, w, 3e-3)
        _close(g, o, 3e-3)


@pytest.mark.parametrize("sq,skv,q_offset,blk", [(16, 48, 32, 8), (20, 40, 20, 16), (5, 33, 28, 8)])
def test_blockwise_with_query_offset_matches_reference(sq, skv, q_offset, blk):
    """A query chunk at ``q_offset`` into a longer causal cache (chunked
    prefill): the rows that see none of a block skip it.  Forward and
    gradients."""
    q = _normal(40, (2, sq, 4, 16))
    k, v = _normal(41, (2, skv, 2, 16)), _normal(42, (2, skv, 2, 16))
    arrays = tuple(map(jnp.asarray, (q, k, v)))
    want = _jit(jx_attn.blockwise_attention, causal=True, block=blk, q_offset=q_offset)(*arrays)
    jx_grads = jax.jit(jax.grad(
        lambda *a: (jx_attn.blockwise_attention(*a, True, blk, q_offset) ** 2).sum(),
        argnums=(0, 1, 2)))(*arrays)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    got = pt_attn.blockwise_attention(*leaves, True, blk, q_offset)
    _close(got, want, 2e-4)
    (got ** 2).sum().backward()
    for leaf, w in zip(leaves, jx_grads):
        _close(leaf.grad, w, 3e-3)


def test_mla_head_dims_differ():
    """V head dim != QK head dim (MLA): forward and gradients."""
    q, k, v = _qkv(3, 2, 32, 4, 4, 24, dv=16)
    want = _jit(jx_attn.blockwise_attention, causal=True, block=16)(
        *map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    got = pt_attn.blockwise_attention(*leaves, True, 16, 0)
    assert got.shape == (2, 32, 4, 16)
    _close(got, want, 2e-4)
    got.sum().backward()
    assert leaves[2].grad.shape == (2, 32, 4, 16)
    jx_grads = jax.jit(jax.grad(lambda *a: jx_attn.blockwise_attention(*a, True, 16, 0).sum(),
                                argnums=(0, 1, 2)))(*map(jnp.asarray, (q, k, v)))
    for leaf, w in zip(leaves, jx_grads):
        _close(leaf.grad, w, 3e-3)


# -- GQA / MLA layers on params carried across ---------------------------------------------


@pytest.mark.parametrize("variant", ["causal", "qkv_bias", "cross"])
def test_gqa_apply_matches_reference(variant):
    init = _jit(jx_attn.gqa_init, d_model=D_MODEL, **GQA, qkv_bias=variant == "qkv_bias")
    jp = jax.device_get(init(jax.random.PRNGKey(0)))
    if variant == "qkv_bias":
        for i, key in enumerate(("wq", "wk", "wv")):
            jp[key]["b"] = _normal(20 + i, jp[key]["b"].shape)
    x_j, x_t = _pair(_normal(21, (2, 9, D_MODEL)), "bfloat16")
    kw = {}
    if variant == "cross":
        kv_j, kv_t = _pair(_normal(22, (2, 5, D_MODEL)), "bfloat16")
        kw = dict(kv_j=kv_j, kv_t=kv_t)
    want = _jit(jx_attn.gqa_apply, **GQA, block=4)(jp, x_j, kv_in=kw.get("kv_j"))
    got = pt_attn.gqa_apply(params_from_numpy(jp, device=CPU), x_t, **GQA, block=4,
                            kv_in=kw.get("kv_t"))
    assert got.dtype == torch.bfloat16 and got.shape == (2, 9, D_MODEL)
    _close(got, want, BF16_LAYER)


def test_gqa_decode_matches_reference_step_by_step():
    jp = _gqa_params()
    decode = _jit(jx_attn.gqa_decode, **GQA)
    pp = _carry(jp)
    x_j, x_t = _pair(_normal(23, (1, 6, D_MODEL)), "bfloat16")
    ck_j = cv_j = jnp.zeros((1, 8, 2, 16), jnp.bfloat16)
    ck_t, cv_t = torch.zeros((1, 8, 2, 16), dtype=torch.bfloat16), torch.zeros(
        (1, 8, 2, 16), dtype=torch.bfloat16)
    for t in range(6):
        o_j, ck_j, cv_j = decode(jp, x_j[:, t:t + 1], ck_j, cv_j, jnp.asarray(t, jnp.int32))
        o_t, ck_t, cv_t = pt_attn.gqa_decode(pp, x_t[:, t:t + 1], ck_t, cv_t, t, **GQA)
        _close(o_t, o_j, BF16_LAYER)
        _close(ck_t, ck_j, ONE_ROUNDING)
        _close(cv_t, cv_j, ONE_ROUNDING)


def test_mla_apply_matches_reference():
    jp = _mla_params()
    x_j, x_t = _pair(_normal(24, (2, 9, D_MODEL)), "bfloat16")
    want = _jit(jx_attn.mla_apply, **MLA, block=4)(jp, x_j)
    got = pt_attn.mla_apply(_carry(jp), x_t, **MLA, block=4)
    assert got.shape == (2, 9, D_MODEL)
    _close(got, want, BF16_LAYER)


def test_mla_decode_matches_reference_step_by_step():
    jp = _mla_params()
    decode = _jit(jx_attn.mla_decode, **MLA)
    pp = _carry(jp)
    x_j, x_t = _pair(_normal(25, (1, 6, D_MODEL)), "bfloat16")
    cc_j, ckr_j = jnp.zeros((1, 8, 32), jnp.bfloat16), jnp.zeros((1, 8, 8), jnp.bfloat16)
    cc_t, ckr_t = torch.zeros((1, 8, 32), dtype=torch.bfloat16), torch.zeros(
        (1, 8, 8), dtype=torch.bfloat16)
    for t in range(6):
        o_j, cc_j, ckr_j = decode(jp, x_j[:, t:t + 1], cc_j, ckr_j, jnp.asarray(t, jnp.int32))
        o_t, cc_t, ckr_t = pt_attn.mla_decode(pp, x_t[:, t:t + 1], cc_t, ckr_t, t, **MLA)
        _close(o_t, o_j, BF16_LAYER)
        _close(cc_t, cc_j, ONE_ROUNDING)
        _close(ckr_t, ckr_j, ONE_ROUNDING)


SMAX = 8


@pytest.mark.parametrize("cur_len", [SMAX - 1, SMAX, SMAX + 3])
def test_gqa_decode_at_a_full_cache_matches_reference(cur_len):
    """From ``cur_len >= Smax`` on, the reference's ``dynamic_update_slice``
    clamps the write to the cache's last row; the step still rotates at
    ``cur_len`` and attends to every row."""
    jp = _gqa_params()
    x_j, x_t = _pair(_normal(26, (2, 1, D_MODEL)), "bfloat16")
    ck_j, ck_t = _pair(_normal(27, (2, SMAX, 2, 16)), "bfloat16")
    cv_j, cv_t = _pair(_normal(28, (2, SMAX, 2, 16)), "bfloat16")
    o_j, ck_j, cv_j = _jit(jx_attn.gqa_decode, **GQA)(jp, x_j, ck_j, cv_j,
                                                      jnp.asarray(cur_len, jnp.int32))
    o_t, ck_t, cv_t = pt_attn.gqa_decode(_carry(jp), x_t, ck_t, cv_t, cur_len, **GQA)
    _close(o_t, o_j, BF16_LAYER)
    _close(ck_t, ck_j, ONE_ROUNDING)
    _close(cv_t, cv_j, ONE_ROUNDING)


@pytest.mark.parametrize("cur_len", [SMAX - 1, SMAX, SMAX + 3])
def test_mla_decode_at_a_full_cache_matches_reference(cur_len):
    jp = _mla_params()
    x_j, x_t = _pair(_normal(29, (2, 1, D_MODEL)), "bfloat16")
    cc_j, cc_t = _pair(_normal(30, (2, SMAX, 32)), "bfloat16")
    ckr_j, ckr_t = _pair(_normal(31, (2, SMAX, 8)), "bfloat16")
    o_j, cc_j, ckr_j = _jit(jx_attn.mla_decode, **MLA)(jp, x_j, cc_j, ckr_j,
                                                       jnp.asarray(cur_len, jnp.int32))
    o_t, cc_t, ckr_t = pt_attn.mla_decode(_carry(jp), x_t, cc_t, ckr_t, cur_len, **MLA)
    _close(o_t, o_j, BF16_LAYER)
    _close(cc_t, cc_j, ONE_ROUNDING)
    _close(ckr_t, ckr_j, ONE_ROUNDING)


def test_gqa_decode_consistent_with_prefill():
    """Greedy decode over a cache reproduces blockwise attention at every
    position, as tests/test_attention.py holds the reference."""
    pp = _carry(_gqa_params())
    x = torch.from_numpy(_normal(0, (1, 9, D_MODEL))).to(torch.bfloat16)
    full = pt_attn.gqa_apply(pp, x, **GQA, rope_theta=1e4, block=8)
    ck = torch.zeros((1, 16, 2, 16), dtype=torch.bfloat16)
    cv = torch.zeros_like(ck)
    outs = []
    for t in range(9):
        o, ck, cv = pt_attn.gqa_decode(pp, x[:, t:t + 1], ck, cv, torch.tensor(t), **GQA)
        outs.append(o)
    _close(torch.cat(outs, dim=1), full, 0.1)


def test_mla_decode_consistent_with_prefill():
    pp = _carry(_mla_params())
    x = torch.from_numpy(_normal(1, (1, 9, D_MODEL))).to(torch.bfloat16)
    full = pt_attn.mla_apply(pp, x, **MLA, block=8)
    cc = torch.zeros((1, 16, 32), dtype=torch.bfloat16)
    ckr = torch.zeros((1, 16, 8), dtype=torch.bfloat16)
    outs = []
    for t in range(9):
        o, cc, ckr = pt_attn.mla_decode(pp, x[:, t:t + 1], cc, ckr, t, **MLA)
        outs.append(o)
    _close(torch.cat(outs, dim=1), full, 0.1)


# -- the flash kernel's plain version and the layers' attention ----------------------------


@pytest.mark.parametrize("b,s,h,hkv,d,causal,bq,bk", [
    (2, 64, 4, 2, 16, True, 16, 32), (2, 64, 4, 4, 16, True, 32, 32),
    (2, 64, 4, 1, 16, False, 32, 64),
    (1, 50, 6, 2, 8, True, 16, 16),            # ragged S against every tile
])
def test_flash_plain_matches_reference_pallas_kernel(b, s, h, hkv, d, causal, bq, bk):
    q, k, v = _qkv(hkv * bq, b, s, h, hkv, d)
    want = jx_flash_fwd(*map(jnp.asarray, (q, k, v)), causal=causal, bq=bq, bk=bk)
    got = pt_flash.flash_attention_fwd_plain(*map(torch.from_numpy, (q, k, v)), causal)[0]
    _close(got, want, 3e-4)


@pytest.mark.parametrize("b,s,h,hkv,causal", [
    (1, 129, 4, 1, True), (1, 129, 4, 1, False),     # one key past a 128-key tile
    (2, 300, 4, 2, True), (2, 300, 4, 2, False),     # ragged last tile (300 = 2 x 128 + 44)
])
def test_flash_plain_tile_walks_match_reference_pallas_kernel(b, s, h, hkv, causal):
    """Both bodies' tile walks across several KV tiles and a ragged last
    one, against the reference's kernel: the fp32 body's (q scaled first,
    64-key tiles, through the wrapper's plain version) and the bf16 body's
    (scores scaled after the product, 128-key tiles; fp32 inputs, so the
    check isolates the walk from bf16 rounding)."""
    from repro_torch.kernels.flash_attention import _flash_fwd_scan, _group_q

    q, k, v = _qkv(s + h, b, s, h, hkv, 16)
    want = jx_flash_fwd(*map(jnp.asarray, (q, k, v)), causal=causal, bq=64, bk=128)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    _close(pt_flash.flash_attention_fwd_plain(tq, tk, tv, causal)[0], want, 3e-4)
    out, _ = _flash_fwd_scan(_group_q(tq, hkv), tk, tv, causal, pt_flash.KV_TILE, 0, 0.25)
    _close(out.reshape(b, s, h, 16), want, 3e-4)


def test_flash_kv_tile_follows_the_kernel_body():
    """The plain version walks the tiles of the body the dtype selects."""
    assert pt_flash.kv_tile(torch.bfloat16) == pt_flash.KV_TILE == 128
    assert pt_flash.kv_tile(torch.float32) == pt_flash.FP32_KV_TILE == 64
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in _qkv(36, 1, 200, 4, 2, 64))
    from repro_torch.kernels.flash_attention import _flash_fwd_scan, _group_q

    out, _ = _flash_fwd_scan(_group_q(q, 2), k, v, True, 128, 0, 1 / 8)
    assert torch.equal(pt_flash.flash_attention_fwd_plain(q, k, v, True)[0],
                       out.reshape(1, 200, 4, 64).to(torch.bfloat16))


@pytest.mark.parametrize("case,copy", [
    ("contiguous", False), ("transposed_storage", False), ("head_slice", False),
    ("base_offset", True), ("odd_row_stride", True), ("strided_head_dim", True),
    ("fp32_base_offset", False), ("fp32_strided_head_dim", True),
])
def test_flash_wrapper_copy_rule(case, copy):
    """Which operands the wrapper copies before a launch: TMA (the bf16
    body) takes 16-byte aligned bases and strides only; both bodies need a
    unit-stride head dim.  The rule is pure Python, so it runs here."""
    bf16 = torch.bfloat16
    flat = torch.zeros(2 * 40 * 3 * 130 + 8, dtype=bf16)
    x = {
        "contiguous": lambda: flat[:2 * 40 * 3 * 64].view(2, 40, 3, 64),
        "transposed_storage": lambda: flat[:2 * 3 * 40 * 64].view(2, 3, 40, 64).transpose(1, 2),
        "head_slice": lambda: flat[:2 * 40 * 3 * 128].view(2, 40, 3, 128)[..., 64:],
        "base_offset": lambda: flat[1:1 + 2 * 40 * 3 * 64].view(2, 40, 3, 64),
        "odd_row_stride": lambda: flat[:2 * 40 * 3 * 65].view(2, 40, 3, 65)[..., :64],
        "strided_head_dim": lambda: flat[:2 * 40 * 3 * 128].view(2, 40, 3, 64, 2)[..., 0],
        "fp32_base_offset": lambda: flat.float()[1:1 + 2 * 40 * 3 * 64].view(2, 40, 3, 64),
        "fp32_strided_head_dim":
            lambda: flat.float()[:2 * 40 * 3 * 128].view(2, 40, 3, 64, 2)[..., 0],
    }[case]()
    assert pt_flash.needs_copy(x) is copy


def test_flash_wrapper_on_cpu_tensors_matches_reference_pallas_kernel():
    """A supported head dim through the wrapper: CPU tensors take the plain
    version; ragged S = 40 against the reference's 16-row tiles."""
    q, k, v = _qkv(31, 1, 40, 4, 2, 64)
    want = jx_flash_fwd(*map(jnp.asarray, (q, k, v)), causal=True, bq=16, bk=16)
    got = pt_flash.flash_attention_fwd(*map(torch.from_numpy, (q, k, v)), True)
    _close(got, want, 3e-4)


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-4), ("bfloat16", BF16_LAYER)])
@pytest.mark.parametrize("causal", [True, False])
def test_ops_flash_attention_on_cpu_matches_reference(dtype, tol, causal):
    """The layers' attention off the accelerator (the port's route, the
    reference's ops dispatch): blockwise attention in both packages."""
    arrays = _qkv(32, 2, 40, 4, 2, 16)
    jx = [jnp.asarray(x).astype(dtype) for x in arrays]
    pt = [torch.from_numpy(x).to(getattr(torch, dtype)) for x in arrays]
    want = jx_ops.flash_attention(*jx, causal=causal)
    got = pt_attn.attention(*pt, causal)
    assert got.dtype == pt[0].dtype
    _close(got, want, tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_row_blocks_with_offsets_equal_the_unsplit_call(dtype, d):
    """q cut into 4 row blocks (a context-parallel prefill's ranks), each
    with its offset against the whole K/V, concatenated: the unsplit call.
    Each row walks the same tiles in the same order, so the plain version
    gives the same bytes (the kernel on the card, tests/test_torch_cuda.py)."""
    q, k, v = (torch.from_numpy(x).to(getattr(torch, dtype))
               for x in _qkv(34, 2, 128, 4, 2, d))
    whole = pt_flash.flash_attention_fwd(q, k, v, True)
    parts = [pt_flash.flash_attention_fwd(q[:, i:i + 32], k, v, True, i)
             for i in range(0, 128, 32)]
    assert torch.equal(torch.cat(parts, dim=1), whole)


@pytest.mark.parametrize("sq,skv,q_offset", [(32, 128, 96), (40, 100, 60), (16, 64, 0), (7, 90, 50)])
def test_flash_with_query_offset_matches_reference_blockwise(sq, skv, q_offset):
    """The plain flash version with ``q_offset`` against the reference's
    ``blockwise_attention`` with the same offset (fp32, 3e-4 as the
    reference holds its kernel)."""
    q = _normal(43, (2, sq, 4, 64))
    k, v = _normal(44, (2, skv, 2, 64)), _normal(45, (2, skv, 2, 64))
    want = _jit(jx_attn.blockwise_attention, causal=True, block=16, q_offset=q_offset)(
        *map(jnp.asarray, (q, k, v)))
    got = pt_flash.flash_attention_fwd(*(torch.from_numpy(x) for x in (q, k, v)), True, q_offset)
    _close(got, want, 3e-4)
    with pytest.raises(ValueError):
        pt_flash.flash_attention_fwd(*(torch.from_numpy(x) for x in (q, k, v)), True, -1)


@pytest.mark.parametrize("case", ["head_dim", "seq", "dtype_mismatch", "fp16", "heads"])
def test_flash_wrapper_refuses_operands_the_kernel_does_not_take(case):
    q, k, v = (torch.from_numpy(x) for x in _qkv(33, 1, 16, 4, 2, 64))
    args, error = {
        "head_dim": ((q[..., :48], k[..., :48], v), ValueError),
        "seq": ((q, k[:, :8], v), ValueError),          # k and v of two lengths
        "dtype_mismatch": ((q, k.to(torch.bfloat16), v), TypeError),
        "fp16": ((q.half(), k.half(), v.half()), TypeError),
        "heads": ((q[:, :, :3], k, v), ValueError),
    }[case]
    with pytest.raises(error):
        pt_flash.flash_attention_fwd(*args)


@pytest.mark.parametrize("needs_grad", [0, 1, 2])
def test_flash_wrapper_is_forward_only(needs_grad):
    """Like the TPU kernel, the wrapper has no backward: it raises rather than
    hand back an output cut off from autograd, and runs under no_grad."""
    qkv = [torch.from_numpy(x) for x in _qkv(35, 1, 16, 4, 2, 64)]
    qkv[needs_grad].requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        pt_flash.flash_attention_fwd(*qkv)
    with torch.no_grad():
        got = pt_flash.flash_attention_fwd(*qkv)
    want = pt_flash.flash_attention_fwd_plain(*(t.detach() for t in qkv))[0]
    assert torch.equal(got, want)


# -- the training kernel pair: its route, and its plain versions on the CPU ----------------


@pytest.mark.parametrize("device,dtypes,d,dv,grad,cross,route", [
    # training self-attention, a gradient needed: the pair or the plain loops
    ("cuda", ("bfloat16",) * 3, 128, 128, True, False, "pair"),      # yi's train_4k
    ("cpu", ("bfloat16",) * 3, 128, 128, True, False, "plain"),
    ("meta", ("bfloat16",) * 3, 128, 128, True, False, "plain"),
    ("cuda", ("float32",) * 3, 128, 128, True, False, "plain"),
    ("cuda", ("bfloat16", "float32", "bfloat16"), 128, 128, True, False, "plain"),
    ("cuda", ("bfloat16",) * 3, 192, 128, True, False, "pair"),      # MLA
    ("cpu", ("bfloat16",) * 3, 192, 128, True, False, "plain"),
    ("cuda", ("float32",) * 3, 192, 128, True, False, "plain"),
    ("cuda", ("bfloat16",) * 3, 160, 160, True, False, "plain"),     # zamba2's shared block
    ("cuda", ("bfloat16",) * 3, 64, 64, True, False, "plain"),       # whisper
    ("cuda", ("bfloat16",) * 3, 192, 64, True, False, "plain"),
    ("cuda", ("bfloat16",) * 3, 128, 192, True, False, "plain"),
    ("cuda", ("float16",) * 3, 128, 128, True, False, "plain"),
    # self-attention with no gradient needed: the forward kernel on the card
    ("cuda", ("bfloat16",) * 3, 128, 128, False, False, "flash"),
    ("cuda", ("float32",) * 3, 64, 64, False, False, "flash"),
    ("cuda", ("bfloat16",) * 3, 160, 160, False, False, "flash"),
    ("cpu", ("bfloat16",) * 3, 128, 128, False, False, "plain"),
    # cross-attention (and blockwise_attention by name): never the forward kernel
    ("cuda", ("bfloat16",) * 3, 128, 128, False, True, "pair"),
    ("cuda", ("bfloat16",) * 3, 192, 128, True, True, "pair"),
    ("cuda", ("bfloat16",) * 3, 64, 64, False, True, "plain"),       # whisper's decoder
    ("cuda", ("bfloat16",) * 3, 64, 64, True, True, "plain"),
    ("cuda", ("float32",) * 3, 128, 128, False, True, "plain"),
    ("cpu", ("bfloat16",) * 3, 128, 128, False, True, "plain"),
])
def test_kernel_pair_route(device, dtypes, d, dv, grad, cross, route):
    """The route of an attention call, from its device, dtypes, head dims,
    whether it needs a gradient and whether it is cross-attention: the
    forward kernel for self-attention on the card with no gradient; the
    kernel pair, both directions, for any other call on the card on bf16 q,
    k and v of head dims the backward takes; the plain loops for the rest."""
    dtypes = tuple(getattr(torch, name) for name in dtypes)
    assert pt_attn.attention_route(device, dtypes, d, dv, grad, cross) == route


@pytest.mark.parametrize("grad", [False, True])
def test_plain_path_counter_counts_cpu_calls(grad):
    """Every forward on the plain loops counts once under its device type,
    with a gradient or without; the backward adds nothing."""
    q, k, v = (torch.from_numpy(x).requires_grad_(grad) for x in _qkv(36, 1, 40, 4, 2, 16))
    before = dict(pt_attn.PLAIN_CALLS)
    out = pt_attn.blockwise_attention(q, k, v, True, 16, 0)
    if grad:
        out.sum().backward()
    assert pt_attn.PLAIN_CALLS["cpu"] == before.get("cpu", 0) + 1
    assert pt_attn.PLAIN_CALLS["cuda"] == before.get("cuda", 0)
    torch.testing.assert_close(out.detach(), pt_attn._blockwise_attention_autodiff(
        *(t.detach() for t in (q, k, v)), True, 16, 0), rtol=0, atol=0)


def _attention_float64(q, k, v, causal, q_offset):
    """(out, lse (B, Sq, H)) of the exact function in float64, GQA heads
    repeated, query row i at position q_offset + i."""
    rep = q.shape[2] // k.shape[2]
    kr, vr = k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kr) / q.shape[-1] ** 0.5
    if causal:
        rows = q_offset + torch.arange(q.shape[1])[:, None]
        s = s.masked_fill(torch.arange(k.shape[1])[None, :] > rows, float("-inf"))
    out = torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), vr)
    return out, s.logsumexp(-1).permute(0, 2, 1)


@pytest.mark.parametrize("sq,skv,rep,q_offset,causal", [
    (70, 70, 4, 0, True), (64, 64, 1, 0, False), (130, 130, 8, 0, True), (20, 90, 2, 50, True),
    (33, 100, 4, 17, False)])
def test_kernel_pair_plain_versions_match_float64(sq, skv, rep, q_offset, causal):
    """The kernel pair's route on CPU tensors runs its wrappers' plain
    versions (the forward's bf16 arithmetic with lse in the kernels'
    padded (B, H, rows) layout, the plain backward given it): lse within
    1e-5 of float64's on the same bf16 values (fp32 sums), the padding rows
    0, and out, dq, dk, dv within 1.25x the relative RMS error of the plain
    route against the float64 function's (neither rounds P or dS below
    fp32; both round each output once to bf16)."""
    rng = np.random.default_rng(sq + skv + rep)
    q, k, v, dout = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16()
                     for shape in ((1, sq, 2 * rep, 128), (1, skv, 2, 128), (1, skv, 2, 128),
                                   (1, sq, 2 * rep, 128)))
    leaves64 = [t.double().requires_grad_() for t in (q, k, v)]
    out64, lse64 = _attention_float64(*leaves64, causal, q_offset)
    out64.backward(dout.double())
    exact = (out64.detach(), *(t.grad for t in leaves64))

    out, lse = pt_flash.flash_attention_fwd_lse(q, k, v, causal, q_offset)
    assert lse.shape == (1, 2 * rep, pt_flash.lse_rows(sq)) and lse.dtype == torch.float32
    torch.testing.assert_close(lse[..., :sq].double(), lse64.permute(0, 2, 1), rtol=1e-5,
                               atol=1e-5)
    assert not lse[..., sq:].any()

    def route(kernels):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        got = pt_attn._BlockwiseAttention.apply(*leaves, causal, 16, q_offset, kernels)
        got.backward(dout)
        return (got.detach(), *(t.grad for t in leaves))

    launches = (pt_flash.flash_attention_fwd_lse.launches, pt_flash.flash_attention_bwd.launches)
    pair, plain = route(True), route(False)
    assert launches == (pt_flash.flash_attention_fwd_lse.launches,
                        pt_flash.flash_attention_bwd.launches)
    torch.testing.assert_close(pair[0], out, rtol=0, atol=0)

    def rel_rms(got, want):
        return float((got.double() - want).norm() / want.norm())

    for name, got, ref, want in zip(("out", "dq", "dk", "dv"), pair, plain, exact, strict=True):
        assert got.dtype == torch.bfloat16
        assert rel_rms(got, want) <= 1.25 * rel_rms(ref, want), name


@pytest.mark.parametrize("sq,skv,h,hkv,q_offset,causal", [
    (70, 70, 2, 2, 0, True), (64, 64, 8, 2, 0, False), (130, 130, 4, 4, 0, True),
    (20, 90, 4, 1, 50, True), (33, 100, 2, 2, 17, False)])
def test_kernel_pair_takes_mla_head_dims(sq, skv, h, hkv, q_offset, causal):
    """The pair's wrappers take bf16 q and k 192 wide and v 128 (MLA's
    heads); on CPU tensors their plain versions run.  out is the flash
    forward's, lse within 1e-5 of float64's, and dq, dk, dv within 1.25x
    the relative RMS error that blockwise attention's autograd gradients
    (float64, on the same bf16 values) take from their own rounding to
    bf16: one rounding each, P and dS kept at fp32 (a backward that
    rounded either once to bf16 lands near 1.4x)."""
    rng = np.random.default_rng(sq + skv)
    q, k, v, dout = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16()
                     for shape in ((1, sq, h, 192), (1, skv, hkv, 192), (1, skv, hkv, 128),
                                   (1, sq, h, 128)))
    launches = (pt_flash.flash_attention_fwd_lse.launches, pt_flash.flash_attention_bwd.launches)
    out, lse = pt_flash.flash_attention_fwd_lse(q, k, v, causal, q_offset)
    grads = pt_flash.flash_attention_bwd(q, k, v, out, dout, lse, causal, q_offset)
    assert launches == (pt_flash.flash_attention_fwd_lse.launches,
                        pt_flash.flash_attention_bwd.launches)
    assert torch.equal(out, pt_flash.flash_attention_fwd(q, k, v, causal, q_offset))

    leaves = [t.double().requires_grad_() for t in (q, k, v)]
    out64 = pt_attn._blockwise_attention_autodiff(*leaves, causal, 16, q_offset)
    out64.backward(dout.double())
    _, lse64 = _attention_float64(*(t.detach() for t in leaves), causal, q_offset)
    torch.testing.assert_close(lse[..., :sq].double(), lse64.permute(0, 2, 1), rtol=1e-5,
                               atol=1e-5)

    def rel_rms(got, want):
        return float((got.double() - want).norm() / want.norm())

    for name, got, like, leaf in zip(("dq", "dk", "dv"), grads, (q, k, v), leaves, strict=True):
        assert got.dtype == torch.bfloat16 and got.shape == like.shape, name
        assert rel_rms(got, leaf.grad) <= 1.25 * rel_rms(leaf.grad.bfloat16(), leaf.grad), name


@pytest.mark.parametrize("case", ["fp32", "head_dim", "lse_rows", "lse_dtype", "dout_dtype",
                                  "out_shape"])
def test_kernel_pair_wrappers_refuse_operands_the_kernels_do_not_take(case):
    q, k, v = (torch.from_numpy(x).bfloat16() for x in _qkv(37, 1, 70, 4, 2, 128))
    out, lse = pt_flash.flash_attention_fwd_lse(q, k, v)
    bwd = dict(q=q, k=k, v=v, out=out, dout=out, lse=lse)
    args, error = {
        "fp32": (dict(bwd, q=q.float(), k=k.float(), v=v.float()), TypeError),
        "head_dim": (dict(bwd, q=q[..., :64], k=k[..., :64], v=v[..., :64]), ValueError),
        "lse_rows": (dict(bwd, lse=lse[..., :70]), ValueError),
        "lse_dtype": (dict(bwd, lse=lse.double()), ValueError),
        "dout_dtype": (dict(bwd, dout=out.float()), ValueError),
        "out_shape": (dict(bwd, out=out[:, :64]), ValueError),
    }[case]
    with pytest.raises(error):
        pt_flash.flash_attention_bwd(**args)
    if case in ("fp32", "head_dim"):
        with pytest.raises(error):
            pt_flash.flash_attention_fwd_lse(args["q"], args["k"], args["v"])


def test_kernel_pair_forward_refuses_autograd():
    """Forward only itself, as flash_attention_fwd: _BlockwiseAttention calls
    it with autograd off and pairs it with the backward kernel."""
    q, k, v = (torch.from_numpy(x).bfloat16() for x in _qkv(38, 1, 16, 4, 2, 128))
    with pytest.raises(RuntimeError, match="no backward"):
        pt_flash.flash_attention_fwd_lse(q.requires_grad_(), k, v)


@pytest.mark.parametrize("sq,rows", [(1, 64), (63, 64), (64, 64), (65, 128), (4096, 4096)])
def test_lse_rows_pad_to_the_kernels_tiles(sq, rows):
    assert pt_flash.lse_rows(sq) == rows
