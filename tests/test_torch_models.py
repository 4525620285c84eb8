"""The port's model stack against the JAX reference, on the CPU.

Per module (MoE, Mamba2, mLSTM, sLSTM, the decoder, encoder and
cross-decoder layers) and per registered architecture (its smoke config:
``init_params`` layouts, params and caches carried across and back,
``forward``'s hidden states, ``loss_fn``'s value, and four ``decode_step``s
with their caches, the last at ``cur_len >= max_len``).  Params come from
``repro``'s own init and are carried across with ``params_from_numpy``;
inputs are drawn from seeded numpy generators; both packages run on the CPU
(the port with ``device="cpu"``, where prefill self-attention takes
``blockwise_attention``).  The reference's functions run under
``jax.jit`` where a call is repeated or large (the same functions,
compiled whole, which keeps this file fast).

Every comparison asks, in the row-RMS form of ``chip_smoke.py``,
``|got - want| <= rtol |want| + row_atol rms(want's row)`` everywhere (a row
is the last axis) and ``||got - want|| <= rel_rms ||want||`` overall:

* ``MODULE`` (2^-7, 5e-2, 1e-2): one module of bf16 dense layers.  The two
  packages round every bf16 product and activation, but XLA and torch sum
  in other orders, so single elements flip by one bf16 ulp (2^-8) and the
  flips pass through a few rounded stages (measured: at most 0.029 of a
  row's RMS, 0.0046 relative RMS error);
* ``ATTENTION_STACK`` (2^-7, 0.1, 2e-2): a whole model of attention and MLP
  layers, where those flips compound through the stack (measured: at most
  0.047 and 0.0115);
* ``RECURRENT_STACK`` (2^-7, 0.4, 8e-2): a whole model with Mamba2 or xLSTM
  blocks, whose exponential gates and decays amplify the same flips
  (measured: at most 0.19 and 0.046);
* ``ONE_ROUNDING`` (2^-7, 1e-2, 5e-3): a cache entry, one rounding away
  from values the two packages agree on.

An MoE router picks the top k of its probabilities: where the k-th and the
(k+1)-th of the reference's lie within ``ROUTING_GAP`` of each other, a
one-ulp difference in the hidden state may pick the other expert in the
port, so that token's output, and in a causal stack every later position of
its sequence, is held to the relative RMS bound only.  The gap is recorded
from inside the reference's ``moe_apply``.  ``ROUTING_GAP`` (5e-3) is an
order above what the bf16 flips move a probability (about 4e-4 at the
smoke widths: router logits of ~0.16 moved by ~1%).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jx_models
from repro.configs import ARCHS as JX_ARCHS
from repro.models import mamba2 as jx_m2
from repro.models import moe as jx_moe
from repro.models import transformer as jx_tf
from repro.models import xlstm as jx_xl
from repro_torch import models as pt_models
from repro_torch.configs import ARCHS as PT_ARCHS
from repro_torch.models import mamba2 as pt_m2
from repro_torch.models import moe as pt_moe
from repro_torch.models import transformer as pt_tf
from repro_torch.models import xlstm as pt_xl
from repro_torch.models.convert import params_from_numpy, params_to_numpy

CPU = "cpu"
MODULE = {"rtol": 2 ** -7, "row_atol": 5e-2, "rel_rms": 1e-2}
ATTENTION_STACK = {"rtol": 2 ** -7, "row_atol": 0.1, "rel_rms": 2e-2}
RECURRENT_STACK = {"rtol": 2 ** -7, "row_atol": 0.4, "rel_rms": 8e-2}
ONE_ROUNDING = {"rtol": 2 ** -7, "row_atol": 1e-2, "rel_rms": 5e-3}
ROUTING_GAP = 5e-3
BATCH, SEQ, MAX_LEN = 2, 32, 3
CUR_LENS = (0, 1, 2, 3)          # the last step finds the cache full
NAMES = sorted(JX_ARCHS)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _assert_close(got, want, tol, what="", unsure=None, rms_axes=(-1,)):
    """``got`` within ``tol`` of ``want``: every element within ``rtol`` of
    itself plus ``row_atol`` of the RMS of its row (the last axis, or
    ``rms_axes``), and the whole within ``rel_rms`` relative RMS error.
    Positions where ``unsure`` (a mask of the leading axes) is set are left
    out of both."""
    got_np, want_np = _np(got), _np(want)
    assert got_np.shape == want_np.shape, (what, got_np.shape, want_np.shape)
    assert np.isfinite(got_np).all(), f"{what}: non-finite values"
    if got_np.ndim == 0:
        assert got_np == want_np, (what, got_np, want_np)
        return
    if unsure is not None:
        mask = unsure.reshape(unsure.shape + (1,) * (got_np.ndim - unsure.ndim))
        got_np, want_np = np.where(mask, 0.0, got_np), np.where(mask, 0.0, want_np)
    diff = np.abs(got_np - want_np)
    scale = np.sqrt(np.square(want_np).mean(axis=rms_axes, keepdims=True))
    allowed = tol["rtol"] * np.abs(want_np) + tol["row_atol"] * scale
    with np.errstate(divide="ignore", invalid="ignore"):
        worst = float(np.where(diff == 0, 0.0, diff / allowed).max())
    rel = float(np.linalg.norm(diff) / max(np.linalg.norm(want_np), 1e-30))
    assert worst <= 1.0 and rel <= tol["rel_rms"], (
        f"{what}: {worst:.3g} of the allowance, relative RMS error {rel:.3g} ({tol})")


def _pair(x: np.ndarray, dtype="bfloat16"):
    return jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(getattr(torch, dtype))


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


#: XLA options for every reference function this file compiles: LLVM's
#: optimisation level changes no rounding, and this halves the compile time
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _fast_jit(fn):
    """``jax.jit(fn)``, compiled with ``FAST_COMPILE`` at its first call (the
    arguments' shapes then stay fixed): the same function and its rounding,
    compiled in about half the time."""
    compiled = []

    def call(*args):
        if not compiled:
            compiled.append(jax.jit(fn).lower(*args).compile(FAST_COMPILE))
        return compiled[0](*args)

    return call


def _reference_init(init, seed: int):
    """``init(jax.random.PRNGKey(seed))`` of the reference, on the host."""
    key = jax.random.PRNGKey(seed)
    return jax.device_get(_fast_jit(init)(key))


# -- routing near-ties ----------------------------------------------------------------------


class Routing:
    """The top-k choices of every MoE call of both packages, in call order,
    and the reference's gap between its k-th and (k+1)-th probabilities."""

    def __init__(self):
        self.ref, self.port = [], []

    def patch(self, mp) -> "Routing":
        ref_apply, port_apply = jx_moe.moe_apply, pt_moe.moe_apply

        def ref_recording(p, x, n_experts, top_k, *args, **kwargs):
            logits = x.reshape(-1, x.shape[-1]).astype(jnp.float32) @ p["router"]["w"].astype(
                jnp.float32)
            top_p, top_i = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), top_k + 1)
            jax.debug.callback(lambda i, g: self.ref.append((np.sort(i, axis=-1), g)),
                               top_i[:, :top_k], top_p[:, top_k - 1] - top_p[:, top_k],
                               ordered=True)
            return ref_apply(p, x, n_experts, top_k, *args, **kwargs)

        def port_recording(p, x, n_experts, top_k, *args, **kwargs):
            logits = x.reshape(-1, x.shape[-1]).float() @ p["router"]["w"].float()
            top_i = torch.topk(torch.softmax(logits, dim=-1), top_k, dim=-1).indices
            self.port.append(np.sort(top_i.numpy(), axis=-1))
            return port_apply(p, x, n_experts, top_k, *args, **kwargs)

        mp.setattr(jx_moe, "moe_apply", ref_recording)
        mp.setattr(pt_moe, "moe_apply", port_recording)
        return self

    def unsure(self, shape, causal=True, since=None) -> np.ndarray:
        """(B, S) mask of the positions a routing flip moved: each token the
        two packages routed apart and, in a causal stack, every later
        position of its row (``since``: the mask of earlier steps, which a
        decode cache carries on).  Asserts that every flip lies where the
        reference's gap is below ``ROUTING_GAP``.  Clears the records."""
        jax.effects_barrier()
        assert len(self.ref) == len(self.port), (len(self.ref), len(self.port))
        unsure = np.zeros(shape, bool) if since is None else since.copy()
        for (ref_i, gap), port_i in zip(self.ref, self.port):
            flipped = (ref_i != port_i).any(axis=-1).reshape(shape)
            new = flipped & ~unsure
            assert (gap.reshape(shape)[new] < ROUTING_GAP).all(), (
                f"routing differs where the reference's gap is {gap.reshape(shape)[new]}")
            unsure |= np.cumsum(flipped, axis=1) > 0 if causal else flipped
        self.ref.clear()
        self.port.clear()
        return unsure


@pytest.fixture
def routing(monkeypatch):
    return Routing().patch(monkeypatch)


# -- MoE ------------------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["capacity", "capacity_drops", "dense_fallback", "shared"])
def test_moe_apply_matches_reference(case):
    d, ff, n_exp, top_k = 32, 48, 4, 2
    n_shared = 1 if case == "shared" else 0
    jp = _reference_init(lambda k: jx_moe.moe_init(k, d, ff, n_exp, n_shared=n_shared), 3)
    xj, xt = _pair(_normal(4, (2, 24, d)))
    factor = 0.5 if case == "capacity_drops" else 1.25
    dense = case == "dense_fallback"
    want = jx_moe.moe_apply(jp, xj, n_exp, top_k, capacity_factor=factor, dense_fallback=dense)
    got = pt_moe.moe_apply(params_from_numpy(jp, device=CPU), xt, n_exp, top_k,
                           capacity_factor=factor, dense_fallback=dense)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 24, d)
    # the router in fp32 on identical inputs: no near-tie can flip a choice here
    probs = jax.nn.softmax(xj.reshape(-1, d).astype(jnp.float32) @ jp["router"]["w"], -1)
    top = np.sort(np.asarray(probs), axis=-1)[:, ::-1]
    assert (top[:, top_k - 1] - top[:, top_k]).min() > 1e-5
    if case == "capacity_drops":
        capacity = int(24 * top_k / n_exp * factor)
        chosen = np.asarray(jax.lax.top_k(probs, top_k)[1]).reshape(2, -1)
        most = max(np.bincount(row, minlength=n_exp).max() for row in chosen)
        assert most > capacity, "the case must drop choices past capacity"
    _assert_close(got, want, MODULE, case)


def test_moe_flops_per_token_matches_reference():
    args = (2048, 1408, 6, 2, 1408)
    assert pt_moe.moe_flops_per_token(*args) == jx_moe.moe_flops_per_token(*args)


# -- Mamba2 ---------------------------------------------------------------------------------

M2 = dict(d_inner=128, n_heads=4, d_state=16, n_groups=2)


def test_mamba2_apply_and_decode_match_reference():
    jp = _reference_init(lambda k: jx_m2.mamba2_init(k, 64, **M2), 5)
    pp = params_from_numpy(jp, device=CPU)
    xj, xt = _pair(_normal(6, (2, 32, 64)))
    want = jx_m2.mamba2_apply(jp, xj, **M2, chunk=8)
    got = pt_m2.mamba2_apply(pp, xt, **M2, chunk=8)
    _assert_close(got, want, MODULE, "apply")
    with pytest.raises(ValueError, match="multiple of chunk"):
        pt_m2.mamba2_apply(pp, xt[:, :30], **M2, chunk=8)
    # decode step by step: against the reference's decode, and against apply
    hd = M2["d_inner"] // M2["n_heads"]
    h_j = jnp.zeros((2, M2["n_heads"], hd, M2["d_state"]), jnp.float32)
    h_t = torch.zeros((2, M2["n_heads"], hd, M2["d_state"]))
    steps = []
    decode = _fast_jit(lambda p, x, h: jx_m2.mamba2_decode(p, x, h, **M2))
    for t in range(12):
        y_j, h_j = decode(jp, xj[:, t:t + 1], h_j)
        y_t, h_t = pt_m2.mamba2_decode(pp, xt[:, t:t + 1], h_t, **M2)
        _assert_close(y_t, y_j, MODULE, f"decode step {t}")
        _assert_close(h_t, h_j, MODULE, f"state after step {t}")
        steps.append(y_t)
    _assert_close(torch.cat(steps, dim=1), got[:, :12], MODULE, "decode against apply")


# -- xLSTM ----------------------------------------------------------------------------------


def test_mlstm_apply_and_decode_match_reference():
    jp = _reference_init(lambda k: jx_xl.mlstm_init(k, 64, 4), 7)
    pp = params_from_numpy(jp, device=CPU)
    xj, xt = _pair(_normal(8, (2, 32, 64)))
    want = jx_xl.mlstm_apply(jp, xj, 4, chunk=8)
    got = pt_xl.mlstm_apply(pp, xt, 4, chunk=8)
    _assert_close(got, want, MODULE, "apply")
    hd = 128 // 4
    state_j = (jnp.zeros((2, 4, hd, hd)), jnp.zeros((2, 4, hd)), jnp.full((2, 4), -1e30))
    state_t = (torch.zeros((2, 4, hd, hd)), torch.zeros((2, 4, hd)), torch.full((2, 4), -1e30))
    decode = _fast_jit(lambda p, x, s: jx_xl.mlstm_decode(p, x, s, 4))
    steps = []
    for t in range(10):
        y_j, state_j = decode(jp, xj[:, t:t + 1], state_j)
        y_t, state_t = pt_xl.mlstm_decode(pp, xt[:, t:t + 1], state_t, 4)
        _assert_close(y_t, y_j, MODULE, f"decode step {t}")
        for a, b in zip(state_t, state_j):
            _assert_close(a, b, MODULE, f"state after step {t}")
        steps.append(y_t)
    _assert_close(torch.cat(steps, dim=1), got[:, :10], MODULE, "decode against apply")


def test_slstm_apply_and_decode_match_reference():
    jp = _reference_init(lambda k: jx_xl.slstm_init(k, 64, 4), 9)
    pp = params_from_numpy(jp, device=CPU)
    xj, xt = _pair(_normal(10, (2, 16, 64)))
    want = _fast_jit(lambda p, x: jx_xl.slstm_apply(p, x, 4))(jp, xj)
    got = pt_xl.slstm_apply(pp, xt, 4)
    _assert_close(got, want, MODULE, "apply")
    state_j = tuple(jnp.zeros((2, 64)) for _ in range(3)) + (jnp.full((2, 64), -1e30),)
    state_t = pt_xl.slstm_init_state(2, 64, CPU)
    decode = _fast_jit(lambda p, x, s: jx_xl.slstm_decode(p, x, s, 4))
    steps = []
    for t in range(8):
        y_j, state_j = decode(jp, xj[:, t:t + 1], state_j)
        y_t, state_t = pt_xl.slstm_decode(pp, xt[:, t:t + 1], state_t, 4)
        _assert_close(y_t, y_j, MODULE, f"decode step {t}")
        for a, b in zip(state_t, state_j):
            _assert_close(a, b, MODULE, f"state after step {t}")
        steps.append(y_t)
    _assert_close(torch.cat(steps, dim=1), got[:, :8], MODULE, "decode against apply")


# -- transformer layers ---------------------------------------------------------------------

#: decoder layers of these architectures' smoke configs
LAYER_ARCHS = {"dense": "yi-9b", "gelu_bias": "starcoder2-7b", "moe": "dbrx-132b",
               "mla_moe_shared": "deepseek-v2-lite-16b"}


@pytest.mark.parametrize("kind", sorted(LAYER_ARCHS))
def test_decoder_layer_apply_and_decode_match_reference(kind, routing):
    jx_cfg, cfg = JX_ARCHS[LAYER_ARCHS[kind]].smoke, PT_ARCHS[LAYER_ARCHS[kind]].smoke
    jp = _reference_init(lambda k: jx_tf.decoder_layer_init(k, jx_cfg), 11)
    pp = params_from_numpy(jp, device=CPU)
    xj, xt = _pair(_normal(12, (2, 16, cfg.d_model)))
    want = _fast_jit(lambda p, x: jx_tf.decoder_layer_apply(p, x, jx_cfg))(jp, xj)
    got = pt_tf.decoder_layer_apply(pp, xt, cfg)
    _assert_close(got, want, MODULE, "apply", routing.unsure((2, 16), causal=False))
    cache_t = pt_tf.layer(pt_models.init_cache(cfg, 2, 8, device=CPU)["scan"], 0)
    cache_j = {key: jnp.zeros(a.shape, jnp.bfloat16) for key, a in cache_t.items()}
    decode = _fast_jit(lambda p, x, c, t: jx_tf.decoder_layer_decode(p, x, c, t, jx_cfg))
    for t in range(5):
        y_j, cache_j = decode(jp, xj[:, t:t + 1], cache_j, jnp.asarray(t, jnp.int32))
        y_t, cache_t = pt_tf.decoder_layer_decode(pp, xt[:, t:t + 1], cache_t, t, cfg)
        _assert_close(y_t, y_j, MODULE, f"decode step {t}", routing.unsure((2, 1), causal=False))
        for key in cache_t:
            _assert_close(cache_t[key], cache_j[key], ONE_ROUNDING, f"cache {key} step {t}")


def test_encoder_and_cross_decoder_layers_match_reference():
    cfg = PT_ARCHS["whisper-base"].smoke
    jx_cfg = JX_ARCHS["whisper-base"].smoke
    enc_p = _reference_init(lambda k: jx_tf.encoder_layer_init(k, jx_cfg), 13)
    dec_p = _reference_init(lambda k: jx_tf.cross_decoder_layer_init(k, jx_cfg), 14)
    xj, xt = _pair(_normal(15, (2, 20, cfg.d_model)))
    ej, et = _pair(_normal(16, (2, 12, cfg.d_model)))
    want = _fast_jit(lambda p, x: jx_tf.encoder_layer_apply(p, x, jx_cfg))(enc_p, xj)
    _assert_close(pt_tf.encoder_layer_apply(params_from_numpy(enc_p, device=CPU), xt, cfg),
                  want, MODULE, "encoder layer")
    want = _fast_jit(lambda p, x, e: jx_tf.cross_decoder_layer_apply(p, x, e, jx_cfg))(
        dec_p, xj, ej)
    _assert_close(pt_tf.cross_decoder_layer_apply(params_from_numpy(dec_p, device=CPU), xt, et,
                                                  cfg), want, MODULE, "cross-decoder layer")


def test_stacked_init_stacks_each_layer_once():
    calls = []

    def init_one(gen):
        calls.append(1)
        return {"w": torch.full((2, 3), float(len(calls))), "n": [torch.zeros(1)]}

    out = pt_tf.stacked_init(torch.Generator(), 4, init_one)
    assert len(calls) == 4 and out["w"].shape == (4, 2, 3) and isinstance(out["n"], list)
    assert [float(w[0, 0]) for w in out["w"]] == [1.0, 2.0, 3.0, 4.0]
    assert pt_tf.layer(out, 2)["w"].data_ptr() == out["w"][2].data_ptr()   # a view


# -- every registered architecture ---------------------------------------------------------


def _layout(tree):
    if isinstance(tree, dict):
        return {key: _layout(value) for key, value in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_layout(value) for value in tree)
    if isinstance(tree, torch.Tensor):
        return tuple(tree.shape), str(tree.dtype).removeprefix("torch.")
    return tuple(tree.shape), np.dtype(tree.dtype).name


@functools.lru_cache(maxsize=None)
def _reference_params(name):
    cfg = JX_ARCHS[name].smoke
    return _reference_init(lambda k: jx_models.init_params(cfg, k), 0)


def _inputs(name):
    """Seeded (reference batch, port batch)."""
    cfg = JX_ARCHS[name].smoke
    rng = np.random.default_rng(17)
    tokens = rng.integers(0, cfg.vocab, (BATCH, SEQ)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (BATCH, SEQ)).astype(np.int32)
    jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    pb = {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)}
    extra = {}
    if cfg.family == "encdec":
        extra["frames"] = rng.standard_normal((BATCH, SEQ, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "vision_stub":
        extra["patch_embeds"] = rng.standard_normal(
            (BATCH, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    for key, value in extra.items():
        jb[key], pb[key] = _pair(value)
    return jb, pb


def _stack_tolerance(name):
    return RECURRENT_STACK if JX_ARCHS[name].smoke.family in ("hybrid", "xlstm") else \
        ATTENTION_STACK


@pytest.mark.parametrize("name", NAMES)
def test_init_params_and_cache_have_the_reference_layout(name):
    jx_cfg, cfg = JX_ARCHS[name].smoke, PT_ARCHS[name].smoke
    want = jax.eval_shape(lambda key: jx_models.init_params(jx_cfg, key), jax.random.PRNGKey(0))
    assert _layout(pt_models.init_params(cfg, seed=0, device=CPU)) == _layout(want)
    want_cache = jax.eval_shape(lambda: jx_models.init_cache(jx_cfg, BATCH, MAX_LEN))
    assert _layout(pt_models.init_cache(cfg, BATCH, MAX_LEN, device=CPU)) == _layout(want_cache)


@pytest.mark.parametrize("name", NAMES)
def test_params_and_cache_round_trip_keeping_every_value(name):
    """Lists (deepseek's first layers, the xLSTM blocks), tuples (the xLSTM
    cache) and a 0-d ``enc_len`` carry across and back, every value kept."""
    cfg = JX_ARCHS[name].smoke
    params = _reference_params(name)
    rng = np.random.default_rng(20)
    cache = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32).astype(a.dtype),
                         jax.device_get(jx_models.init_cache(cfg, BATCH, MAX_LEN)))
    if cfg.family == "encdec":
        cache["enc_len"] = np.asarray(5, np.int32)
    for tree in (params, cache):
        again = params_to_numpy(params_from_numpy(tree, device=CPU))
        assert _layout(jax.tree.map(lambda a: np.zeros(a.shape, np.float32), tree)) == \
            _layout(jax.tree.map(lambda a: np.zeros(a.shape, np.float32), again))
        for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(again)):
            np.testing.assert_array_equal(np.asarray(a, np.float32), b)
    if cfg.family == "encdec":
        enc_len = params_from_numpy(cache, device=CPU)["enc_len"]
        assert enc_len.shape == () and enc_len.dtype == torch.int32 and int(enc_len) == 5


@functools.lru_cache(maxsize=None)
def _forward_pair(name):
    """(hidden, loss) of both packages, and the positions a routing flip
    moved."""
    jx_cfg, cfg = JX_ARCHS[name].smoke, PT_ARCHS[name].smoke
    jp = _reference_params(name)
    jb, pb = _inputs(name)
    with pytest.MonkeyPatch.context() as mp:
        routing = Routing().patch(mp)
        # forward, then loss_fn (a second forward) in both packages
        want_h, want_loss = _fast_jit(
            lambda p, b: (jx_models.forward(p, jx_cfg, b), jx_models.loss_fn(p, jx_cfg, b)))(
            jp, jb)
        pp = params_from_numpy(jp, device=CPU)
        got_h = pt_models.forward(pp, cfg, pb)
        got_loss = pt_models.loss_fn(pp, cfg, pb)
        unsure = routing.unsure(tuple(want_h.shape[:2]))
    return got_h, want_h, got_loss, want_loss, unsure


@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_reference(name):
    got, want, _, _, unsure = _forward_pair(name)
    assert got.dtype == torch.bfloat16
    _assert_close(got, want, _stack_tolerance(name), "hidden states", unsure)


@pytest.mark.parametrize("name", NAMES)
def test_loss_matches_reference(name):
    _, _, got, want, _ = _forward_pair(name)
    assert got.shape == () and got.dtype == torch.float32
    # a mean of per-token CE: the hidden states' relative error, scaled down
    assert abs(float(got) - float(want)) <= 2e-2 * abs(float(want)), (float(got), float(want))


@pytest.mark.parametrize("name", NAMES)
def test_decode_steps_match_reference(name, routing):
    """Four steps from empty caches of ``MAX_LEN`` rows, the last at
    ``cur_len == MAX_LEN`` (the reference clamps its cache write to the last
    row); logits and every cache leaf after each step."""
    jx_cfg, cfg = JX_ARCHS[name].smoke, PT_ARCHS[name].smoke
    jp = _reference_params(name)
    pp = params_from_numpy(jp, device=CPU)
    cache_j = jx_models.init_cache(jx_cfg, BATCH, MAX_LEN)
    if cfg.family == "encdec":
        # an encoder K/V to attend to, two rows of it valid
        for key in ("k", "v"):
            cache_j["cross"][key] = jnp.asarray(
                _normal(18, cache_j["cross"][key].shape)).astype(jnp.bfloat16)
        cache_j["enc_len"] = jnp.asarray(2, jnp.int32)
    cache_t = params_from_numpy(jax.device_get(cache_j), device=CPU)
    tokens = np.random.default_rng(19).integers(0, cfg.vocab, (BATCH, len(CUR_LENS)))
    step = _fast_jit(lambda p, c, b: jx_models.decode_step(p, jx_cfg, c, b))
    tol = _stack_tolerance(name)
    unsure = np.zeros((BATCH, 1), bool)
    for i, cur_len in enumerate(CUR_LENS):
        tok = tokens[:, i:i + 1].astype(np.int32)
        want, cache_j = step(jp, cache_j, {"tokens": jnp.asarray(tok),
                                           "cur_len": jnp.asarray(cur_len, jnp.int32)})
        jax.effects_barrier()
        got, cache_t = pt_models.decode_step(pp, cfg, cache_t, {"tokens": torch.from_numpy(tok),
                                                                "cur_len": cur_len})
        unsure = routing.unsure((BATCH, 1), since=unsure)
        assert got.dtype == torch.float32 and got.shape == (BATCH, 1, cfg.vocab)
        _assert_close(got, want, tol, f"logits at cur_len {cur_len}", unsure)
        want_leaves = jax.tree.leaves(jax.device_get(cache_j))
        got_leaves = jax.tree.leaves(params_to_numpy(cache_t))
        assert len(got_leaves) == len(want_leaves)
        for j, (a, b) in enumerate(zip(got_leaves, want_leaves)):
            # an SSM state or an mLSTM memory is a (P, N) matrix of outer
            # products a head: its scale is the matrix's, not a row's
            matrix = cfg.family in ("hybrid", "xlstm") and a.ndim >= 4
            _assert_close(a, b, tol, f"cache leaf {j} at cur_len {cur_len}",
                          rms_axes=(-2, -1) if matrix else (-1,))


def test_decode_step_takes_an_int_or_a_0d_tensor():
    cfg = PT_ARCHS["yi-9b"].smoke
    pp = pt_models.init_params(cfg, seed=1, device=CPU)
    tokens = torch.tensor([[3], [5]])
    outs = []
    for cur_len in (2, torch.tensor(2, dtype=torch.int32)):
        cache = pt_models.init_cache(cfg, 2, 4, device=CPU)
        outs.append(pt_models.decode_step(pp, cfg, cache, {"tokens": tokens,
                                                           "cur_len": cur_len})[0])
    assert torch.equal(outs[0], outs[1])
