"""The port's gradients against the JAX reference, on the CPU.

For every registered architecture's smoke config, ``loss_fn``'s value and
gradients: ``jax.value_and_grad`` of the reference against
``repro_torch.launch.steps.loss_and_grads`` (``torch.autograd.grad``), on the
reference's params carried across with ``params_from_numpy`` and the same
seeded batch.  The metric is each parameter leaf's relative RMS error,
``||g_port - g_ref|| / ||g_ref||``; every leaf must have a gradient.

* With every product in fp32 in both packages (the defaults of
  ``dense_apply`` and ``embed_apply`` switched to float32 in this test
  process only), the two compute one function up to fp32 rounding: every
  leaf within ``FP32_GRAD`` (1e-3; read at most 7.6e-4, xlstm-125m).  Two exceptions:
  an MoE layer's experts run bf16 einsums in both packages whatever the
  switch, so the MoE families are held to ``BF16_GRAD`` here too (read
  6-8e-3: one-ulp bf16 flips, as the MoE forward's 5e-3); and whisper's
  encoder scan in the reference carries bf16 frames, which fp32 products
  would promote, so the reference refuses the switch there.
* As shipped (bf16 products), the attention families' leaves within
  ``BF16_GRAD`` (5e-2).  The hybrid (Mamba2) and xLSTM families are held
  only to finite gradients and the loss's 2e-2 of ``test_torch_models.py``:
  their random recurrent stacks amplify the one-ulp bf16 differences
  between the packages (about 0.2 relative RMS error), as their forward
  does, and the same comparison in fp32 holds them to ``FP32_GRAD``.

Both packages run with ``remat`` off here (``test_torch_train.py`` holds
remat against no remat).  An MoE router picks the top k of its
probabilities, and where the k-th and (k+1)-th of the reference's lie
within ``ROUTING_GAP`` of each other (the rule of ``test_torch_models.py``)
a one-ulp difference may pick another expert in the port, which would
change every later position of its row.  So the port routes every token
as the reference did (``PinnedRouting``), after asserting that each choice
of its own that differs lies under that gap.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jx_models
from repro.configs import ARCHS as JX_ARCHS
from repro.models import layers as jx_layers
from repro.models import moe as jx_moe
from repro_torch.configs import ARCHS as PT_ARCHS
from repro_torch.launch.steps import loss_and_grads
from repro_torch.models import layers as pt_layers
from repro_torch.models import moe as pt_moe
from repro_torch.models.convert import params_from_numpy, params_to_numpy

CPU = "cpu"
FP32_GRAD = 1e-3
BF16_GRAD = 5e-2
LOSS = 2e-2
FP32_LOSS = 1e-4
ROUTING_GAP = 5e-3
BATCH, SEQ = 2, 32
NAMES = sorted(JX_ARCHS)
#: whisper's encoder scan in the reference carries bf16 frames, which fp32
#: products would promote: the reference refuses the switch there
FP32_NAMES = [name for name in NAMES if JX_ARCHS[name].smoke.family != "encdec"]
RECURRENT = ("hybrid", "xlstm")
#: XLA options of ``test_torch_models.FAST_COMPILE``: no rounding changes
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(FAST_COMPILE)


@functools.lru_cache(maxsize=None)
def _reference_params(name):
    cfg = JX_ARCHS[name].smoke
    key = jax.random.PRNGKey(0)
    return jax.device_get(_compiled(lambda k: jx_models.init_params(cfg, k), key)(key))


def _batch(name):
    """Seeded (reference batch, port batch)."""
    cfg = JX_ARCHS[name].smoke
    rng = np.random.default_rng(23)
    arrays = {"tokens": rng.integers(0, cfg.vocab, (BATCH, SEQ)).astype(np.int32),
              "labels": rng.integers(0, cfg.vocab, (BATCH, SEQ)).astype(np.int32)}
    if cfg.family == "encdec":
        arrays["frames"] = rng.standard_normal((BATCH, SEQ, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "vision_stub":
        arrays["patch_embeds"] = rng.standard_normal(
            (BATCH, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    jb, pb = {}, {}
    for key, value in arrays.items():
        if value.dtype == np.float32:
            jb[key] = jnp.asarray(value).astype(jnp.bfloat16)
            pb[key] = torch.from_numpy(value).to(torch.bfloat16)
        else:
            jb[key], pb[key] = jnp.asarray(value), torch.from_numpy(value)
    return jb, pb


@contextlib.contextmanager
def products_in(dtype: str):
    """Both packages' ``dense_apply`` and ``embed_apply`` computing in
    ``dtype`` (their defaults switched, and restored after)."""
    fns = [(jx_layers.dense_apply, getattr(jnp, dtype)),
           (jx_layers.embed_apply, getattr(jnp, dtype)),
           (pt_layers.dense_apply, getattr(torch, dtype)),
           (pt_layers.embed_apply, getattr(torch, dtype))]
    saved = [fn.__defaults__ for fn, _ in fns]
    for fn, value in fns:
        fn.__defaults__ = (value,)
    try:
        yield
    finally:
        for (fn, _), defaults in zip(fns, saved):
            fn.__defaults__ = defaults


class PinnedRouting:
    """The reference's top-k choices of every MoE call, recorded in call
    order with its gap between the k-th and (k+1)-th probabilities
    (``record``); the port's MoE calls then route as those did (``pin``:
    ``torch.topk`` inside ``repro_torch.models.moe`` returns the recorded
    experts, weighted by the port's own probabilities), after asserting
    that wherever the port's own choice differs, the reference's gap is
    under ``ROUTING_GAP``.  Both packages run with ``remat`` off, so each
    MoE layer is called once, in the forward's order."""

    def __init__(self):
        self.calls: list = []
        self.apart = 0

    @contextlib.contextmanager
    def record(self):
        ref_apply = jx_moe.moe_apply

        def recording(p, x, n_experts, top_k, *args, **kwargs):
            logits = x.reshape(-1, x.shape[-1]).astype(jnp.float32) @ p["router"]["w"].astype(
                jnp.float32)
            top_p, top_i = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), top_k + 1)
            jax.debug.callback(lambda i, g: self.calls.append((np.asarray(i), np.asarray(g))),
                               top_i[:, :top_k], top_p[:, top_k - 1] - top_p[:, top_k],
                               ordered=True)
            return ref_apply(p, x, n_experts, top_k, *args, **kwargs)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jx_moe, "moe_apply", recording)
            yield
            jax.effects_barrier()

    @contextlib.contextmanager
    def pin(self):
        recorded = iter(self.calls)
        routing = self

        class PinnedTorch:
            def __getattr__(self, name):
                return getattr(torch, name)

            def topk(self, probs, k, dim=-1, sorted=True):
                ref_i, gap = next(recorded)
                own = torch.topk(probs, k, dim=dim).indices.numpy()
                apart = (np.sort(own, axis=-1) != np.sort(ref_i, axis=-1)).any(axis=-1)
                assert (gap[apart] < ROUTING_GAP).all(), f"routed apart at gaps {gap[apart]}"
                routing.apart += int(apart.sum())
                idx = torch.from_numpy(np.array(ref_i)).long()
                return probs.gather(dim, idx), idx

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(pt_moe, "torch", PinnedTorch())
            yield
        assert next(recorded, None) is None, "the port made fewer MoE calls"


def _value_and_grads(name):
    """(loss, gradients by leaf path) of both packages, remat off, the port
    routing every MoE token as the reference did."""
    jx_cfg = dataclasses.replace(JX_ARCHS[name].smoke, remat=False)
    cfg = dataclasses.replace(PT_ARCHS[name].smoke, remat=False)
    jp = _reference_params(name)
    jb, pb = _batch(name)
    routing = PinnedRouting()
    with routing.record():
        want_loss, want = _compiled(
            jax.value_and_grad(lambda p, b: jx_models.loss_fn(p, jx_cfg, b)), jp, jb)(jp, jb)
    with routing.pin():
        got_loss, got = loss_and_grads(params_from_numpy(jp, device=CPU), cfg, pb)
    return (float(got_loss), _named_leaves(params_to_numpy(got)),
            float(want_loss), _named_leaves(jax.device_get(want)))


def _named_leaves(tree) -> dict[str, np.ndarray]:
    """A numpy tree's leaves by path, in ``jax.tree_util``'s order."""
    return {jax.tree_util.keystr(path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _relative_errors(got: dict, want: dict) -> dict[str, float]:
    assert list(got) == list(want)
    errs = {}
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape and np.isfinite(g).all(), path
        errs[path] = float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))
    return errs


def _worst(errs: dict) -> tuple[str, float]:
    path = max(errs, key=errs.get)
    return path, errs[path]


def _tolerance(name: str, fp32: bool) -> float | None:
    """The bound on every leaf's relative RMS error, or None where only
    finite gradients and the loss are held (see the module's docstring)."""
    cfg = PT_ARCHS[name].smoke
    if fp32 and not cfg.moe_experts:
        return FP32_GRAD
    if cfg.family in RECURRENT:
        return None
    return BF16_GRAD


@pytest.mark.parametrize("name", FP32_NAMES)
def test_gradients_match_reference_in_fp32(name):
    with products_in("float32"):
        got_loss, got, want_loss, want = _value_and_grads(name)
    errs = _relative_errors(got, want)
    tol = _tolerance(name, fp32=True)
    assert _worst(errs)[1] <= tol, (name, _worst(errs))
    loss_tol = FP32_LOSS if tol == FP32_GRAD else LOSS
    assert abs(got_loss - want_loss) <= loss_tol * abs(want_loss), (got_loss, want_loss)


@pytest.mark.parametrize("name", NAMES)
def test_gradients_match_reference_in_bf16(name):
    got_loss, got, want_loss, want = _value_and_grads(name)
    errs = _relative_errors(got, want)
    assert abs(got_loss - want_loss) <= LOSS * abs(want_loss), (got_loss, want_loss)
    tol = _tolerance(name, fp32=False)
    if tol is not None:
        assert _worst(errs)[1] <= tol, (name, _worst(errs))


def test_chunked_cross_entropy_gradients_match_reference():
    """Eight chunks: each casts ``unembed`` to bf16 itself, so its gradient
    is each chunk's bf16 product summed in fp32, as in the reference's scan
    (one shared cast summed the chunks in bf16: 3.5e-3 relative RMS error)."""
    from repro.models import layers as jl

    rng = np.random.default_rng(31)
    h = rng.standard_normal((2, 128, 32)).astype(np.float32)
    w = (rng.standard_normal((32, 64)) * 0.2).astype(np.float32)
    y = rng.integers(0, 64, (2, 128)).astype(np.int32)
    want_h, want_w = jax.grad(
        lambda h, w: jl.chunked_cross_entropy(h, w, jnp.asarray(y), chunk=16),
        argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    ht, wt = torch.from_numpy(h).requires_grad_(), torch.from_numpy(w).requires_grad_()
    pt_layers.chunked_cross_entropy(ht, wt, torch.from_numpy(y), chunk=16).backward()
    errs = _relative_errors({"h": ht.grad.numpy(), "w": wt.grad.numpy()},
                            {"h": np.asarray(want_h), "w": np.asarray(want_w)})
    assert max(errs.values()) <= 1e-4, errs


def test_embedding_gradient_sums_a_repeated_token_in_fp32():
    """``embed_apply`` casts the gathered rows, not the table: the forward
    is the cast table's rows bit for bit, and a token seen 4,096 times gets
    its gradients summed in the table's fp32 (read 6.2e-8 relative; the
    sum in bf16 that a gather from the cast table gives reads 5.5e-2)."""
    gen = torch.Generator().manual_seed(7)
    table = torch.randn((8, 16), generator=gen) * 0.02
    tokens = torch.full((4096,), 3)
    tokens[::7] = 5
    upstream = torch.randn((4096, 16), generator=gen)
    leaf = table.clone().requires_grad_()
    out = pt_layers.embed_apply({"table": leaf}, tokens)
    assert torch.equal(out, table.to(torch.bfloat16)[tokens])
    out.backward(upstream.to(torch.bfloat16))
    want = torch.zeros((8, 16), dtype=torch.float64).index_add_(
        0, tokens, upstream.to(torch.bfloat16).double())
    assert leaf.grad.dtype == torch.float32
    err = (leaf.grad.double() - want).norm() / want.norm()
    assert err <= 1e-5, err


def test_mamba2_gradients_stay_finite_where_the_decays_overflow():
    """A 128-token chunk whose decays sum past exp's range (zamba2-2.7b's
    ``ssm_chunk`` at its default init): above the diagonal ``exp(decay)``
    overflows, and the reference, which masks exp's output, gets NaN
    gradients; the port masks the exponent, so its gradients stay finite
    and its forward is unchanged."""
    from repro.models import mamba2 as jm
    from repro_torch.models import mamba2 as pm

    m2 = dict(d_inner=128, n_heads=4, d_state=16, n_groups=1)
    jp = _reference_params_of(lambda k: jm.mamba2_init(k, 64, **m2), 5)
    jp["dt_bias"] = np.full_like(jp["dt_bias"], 3.0)     # decays of about 3 a token
    x = np.random.default_rng(6).standard_normal((1, 128, 64)).astype(np.float32)
    want_y, vjp = jax.vjp(lambda p: jm.mamba2_apply(p, jnp.asarray(x), **m2, chunk=128), jp)
    want = vjp(jnp.ones_like(want_y))[0]
    assert not all(np.isfinite(np.asarray(g)).all() for g in jax.tree.leaves(want))
    pp = params_from_numpy(jp, device=CPU)
    live = [t.requires_grad_() for t in pt_layers.tree_leaves(pp)]
    got_y = pm.mamba2_apply(pp, torch.from_numpy(x), **m2, chunk=128)
    got = torch.autograd.grad(got_y.float().sum(), live)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    np.testing.assert_allclose(got_y.detach().float().numpy(), np.asarray(want_y, np.float32),
                               rtol=2 ** -7, atol=5e-2 * float(np.abs(want_y).max()))


def _reference_params_of(init, seed: int):
    key = jax.random.PRNGKey(seed)
    return jax.device_get(init(key))
