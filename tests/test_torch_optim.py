"""The port's optimizer, schedules, gradient compression and data pipeline
against the JAX reference, on the CPU.

The same seeded numpy inputs go through ``repro`` and ``repro_torch``:

* ``warmup_cosine`` and ``constant`` at the reference's test points
  (``tests/test_packets_optim.py``) exactly, and over a range of steps
  within 1e-6 relative (``jnp.cos`` and ``torch.cos`` may round apart);
* ``adamw_update`` over ``ADAM_STEPS`` steps on a tree of stacked (L, d)
  and (L, d, f) leaves and unstacked (d,), (d, f) and 0-d ones, the
  gradients drawn per step: params, ``m``, ``v``, ``grad_norm`` and ``lr``
  within ``ADAM_TOL`` (1e-6) of each leaf's largest magnitude, and
  ``step`` exact; the stacked norm scales decay and the unstacked ones do
  not, as in the reference (``p.ndim >= 2``);
* the reference's quadratic and clip tests mirrored;
* ``compress_with_feedback`` over a few steps: the int8 bytes equal, the
  scales and the error state within 1e-6, ``compression_ratio`` equal;
* ``SyntheticSource`` and ``MemmapSource`` batches 0-9 equal to the
  reference's, and ``DataPipeline.seek`` replaying the same batches.

The port's ``adamw_update`` writes params and moments in place; the tests
hand it copies, and one test shows that a checkpoint taken before an
update keeps the state of its own step.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as jx_pipeline
from repro.optim import adamw as jx_adamw
from repro.optim import compression as jx_comp
from repro.optim import schedule as jx_schedule
from repro_torch.checkpoint.manager import CheckpointManager, CheckpointPolicy
from repro_torch.checkpoint.storage import StorageCluster
from repro_torch.data import pipeline as pt_pipeline
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.optim import adamw as pt_adamw
from repro_torch.optim import compression as pt_comp
from repro_torch.optim import schedule as pt_schedule

CPU = "cpu"
ADAM_STEPS = 6
ADAM_TOL = 1e-6


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max |err| {err:.3g} > {tol} x {scale:.3g}"


def _leaves_by_path(tree) -> dict:
    return {jax.tree_util.keystr(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _trees_close(got, want, tol, what):
    got, want = _leaves_by_path(got), _leaves_by_path(want)
    assert list(got) == list(want), (what, list(got), list(want))
    for path in want:
        _close(got[path], want[path], tol, f"{what} {path}")


# -- schedules ------------------------------------------------------------------------------


def test_warmup_cosine_at_the_reference_test_points():
    assert float(pt_schedule.warmup_cosine(0, warmup=10, total=100)) == 0.0
    assert float(pt_schedule.warmup_cosine(10, warmup=10, total=100)) == 1.0
    assert float(pt_schedule.warmup_cosine(100, warmup=10, total=100, floor=0.1)) == \
        float(jnp.asarray(0.1))
    mid = float(pt_schedule.warmup_cosine(55, warmup=10, total=100))
    assert 0.1 < mid < 1.0


@pytest.mark.parametrize("kwargs", [{}, {"warmup": 10, "total": 100},
                                    {"warmup": 0, "total": 50, "floor": 0.0}],
                         ids=["defaults", "short", "no-warmup"])
def test_warmup_cosine_matches_reference_over_steps(kwargs):
    steps = np.arange(0, 12_000, 37, dtype=np.int32)
    want = np.asarray(jax.vmap(lambda s: jx_schedule.warmup_cosine(s, **kwargs))(steps))
    got = np.stack([pt_schedule.warmup_cosine(int(s), **kwargs).numpy() for s in steps])
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    # a 0-d int32 step tensor (the optimizer state's) gives the same
    step = torch.tensor(250, dtype=torch.int32)
    assert pt_schedule.warmup_cosine(step, **kwargs) == pt_schedule.warmup_cosine(250, **kwargs)


def test_constant_schedule():
    for step in (0, 7, torch.tensor(3, dtype=torch.int32)):
        got = pt_schedule.constant(step)
        assert got.dtype == torch.float32 and got.shape == () and float(got) == 1.0
    assert float(jx_schedule.constant(7)) == 1.0


# -- AdamW ----------------------------------------------------------------------------------


def _adam_tree(rng) -> dict:
    """Stacked (L, d) norm scales and (L, d, f) weights beside unstacked
    (d,), (d, f) and 0-d leaves."""
    return {
        "layers": {"ln": {"scale": (1 + 0.1 * rng.standard_normal((3, 8))).astype(np.float32)},
                   "w": rng.standard_normal((3, 8, 5)).astype(np.float32)},
        "ln_f": {"scale": (1 + 0.1 * rng.standard_normal(8)).astype(np.float32)},
        "unembed": {"w": rng.standard_normal((8, 5)).astype(np.float32)},
        "temp": np.asarray(0.5, np.float32),
    }


@pytest.mark.parametrize("lr_scale", [1.0, "schedule"])
def test_adamw_update_matches_reference_over_steps(lr_scale):
    rng = np.random.default_rng(41)
    params = _adam_tree(rng)
    cfg = dict(lr=3e-2, weight_decay=0.1, grad_clip=1.0)
    jp, jo = params, jx_adamw.init_opt_state(params)
    pp = params_from_numpy(params, device=CPU)
    po = pt_adamw.init_opt_state(pp)
    assert po["step"].dtype == torch.int32 and po["step"].shape == ()
    for i in range(ADAM_STEPS):
        # large gradients in the first steps, so the clip acts
        scale = 3.0 if i < 2 else 0.02
        grads = jax.tree.map(lambda p: (scale * rng.standard_normal(p.shape)).astype(np.float32),
                             params)
        if lr_scale == "schedule":
            jx_scale = jx_schedule.warmup_cosine(jo["step"], warmup=2, total=ADAM_STEPS)
            pt_scale = pt_schedule.warmup_cosine(po["step"], warmup=2, total=ADAM_STEPS)
        else:
            jx_scale = pt_scale = lr_scale
        jp, jo, jm = jx_adamw.adamw_update(jp, grads, jo, jx_adamw.AdamWConfig(**cfg), jx_scale)
        pp, po, pm = pt_adamw.adamw_update(pp, params_from_numpy(grads, device=CPU), po,
                                           pt_adamw.AdamWConfig(**cfg), pt_scale)
        assert int(po["step"]) == int(jo["step"]) == i + 1 and po["step"].dtype == torch.int32
        assert (float(jm["grad_norm"]) > cfg["grad_clip"]) == (i < 2)     # the clip acted
        _close(pm["grad_norm"], jm["grad_norm"], ADAM_TOL, f"grad_norm at step {i}")
        _close(pm["lr"], jm["lr"], ADAM_TOL, f"lr at step {i}")
        for what, got, want in [("params", pp, jp), ("m", po["m"], jo["m"]),
                                ("v", po["v"], jo["v"])]:
            _trees_close(params_to_numpy(got), jax.device_get(want), ADAM_TOL,
                         f"{what} at step {i}")


def test_adamw_decays_stacked_norm_scales_and_not_unstacked_ones():
    """With zero gradients only the decay moves a leaf: the stacked (L, d)
    scales and the 2-d weights shrink, the (d,) and 0-d leaves stay."""
    params = _adam_tree(np.random.default_rng(43))
    pp = params_from_numpy(params, device=CPU)
    zeros = params_from_numpy(jax.tree.map(np.zeros_like, params), device=CPU)
    pp, _, _ = pt_adamw.adamw_update(pp, zeros, pt_adamw.init_opt_state(pp),
                                     pt_adamw.AdamWConfig(lr=0.5, weight_decay=0.1))
    got = params_to_numpy(pp)
    np.testing.assert_allclose(got["layers"]["ln"]["scale"], params["layers"]["ln"]["scale"] * 0.95,
                               rtol=1e-6)
    np.testing.assert_allclose(got["unembed"]["w"], params["unembed"]["w"] * 0.95, rtol=1e-6)
    np.testing.assert_array_equal(got["ln_f"]["scale"], params["ln_f"]["scale"])
    np.testing.assert_array_equal(got["temp"], params["temp"])


def test_adamw_reduces_quadratic():
    params = {"w": torch.tensor([3.0, -2.0, 1.0])}
    opt = pt_adamw.init_opt_state(params)
    cfg = pt_adamw.AdamWConfig(lr=0.1, weight_decay=0.0)
    for _ in range(150):
        grads = {"w": 2 * params["w"]}
        params, opt, _ = pt_adamw.adamw_update(params, grads, opt, cfg)
    assert float(params["w"].abs().max()) < 0.05
    assert int(opt["step"]) == 150


def test_adamw_grad_clip_and_metrics():
    params = {"w": torch.ones(4)}
    opt = pt_adamw.init_opt_state(params)
    cfg = pt_adamw.AdamWConfig(lr=0.0, grad_clip=1.0)
    _, _, m = pt_adamw.adamw_update(params, {"w": torch.full((4,), 100.0)}, opt, cfg)
    assert float(m["grad_norm"]) == 200.0


def test_adamw_update_on_cpu_leaves_takes_the_plain_loop(monkeypatch):
    """CPU leaves take the plain loop: no kernel is built or launched, and
    ``kernels.adamw.adamw_step_plain`` updates every value."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import adamw as ka

    def refuse(*args, **kwargs):
        raise AssertionError("the CPU path tried to build a CUDA kernel")

    plain, updated = ka.adamw_step_plain, []

    def counted(params, *args, **kwargs):
        updated.append(sum(p.numel() for p in params))
        plain(params, *args, **kwargs)

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(ka, "adamw_step_plain", counted)
    tree = _adam_tree(np.random.default_rng(45))
    params = params_from_numpy(tree, device=CPU)
    grads = params_from_numpy(jax.tree.map(lambda p: 3.0 * np.ones_like(p), tree), device=CPU)
    launches = (ka.sum_of_squares.launches, ka.adamw_step.launches)
    _, _, metrics = pt_adamw.adamw_update(params, grads, pt_adamw.init_opt_state(params),
                                          pt_adamw.AdamWConfig())
    values = sum(int(np.size(leaf)) for leaf in jax.tree.leaves(tree))
    assert updated == [values]
    assert (ka.sum_of_squares.launches, ka.adamw_step.launches) == launches
    assert float(metrics["grad_norm"]) == pytest.approx(3.0 * values ** 0.5, rel=1e-6)


def test_a_checkpoint_before_an_update_keeps_its_own_step():
    """``adamw_update`` writes in place; the manager's snapshot, taken on
    the caller's thread, still restores the state saved before it."""
    params = params_from_numpy(_adam_tree(np.random.default_rng(47)), device=CPU)
    opt = pt_adamw.init_opt_state(params)
    cluster = StorageCluster(num_nodes=6, node_capacity=1 << 22, device=CPU)
    mgr = CheckpointManager(cluster, CheckpointPolicy(k=3, m=2, stripe_bytes=1 << 12))
    cfg = pt_adamw.AdamWConfig(lr=0.1)
    grads = params_from_numpy(_adam_tree(np.random.default_rng(48)), device=CPU)
    params, opt, _ = pt_adamw.adamw_update(params, grads, opt, cfg)
    state = {"params": params, "opt": opt}
    saved = params_to_numpy(state)
    mgr.save(1, state)                          # the write runs in the background
    for _ in range(3):
        params, opt, _ = pt_adamw.adamw_update(params, grads, opt, cfg)
    mgr.wait()
    restored = params_to_numpy(mgr.restore(treedef=state))
    moved = params_to_numpy({"params": params, "opt": opt})
    for path, want in _leaves_by_path(saved).items():
        np.testing.assert_array_equal(_leaves_by_path(restored)[path], want, err_msg=path)
    assert not np.array_equal(moved["params"]["unembed"]["w"], saved["params"]["unembed"]["w"])


# -- gradient compression -------------------------------------------------------------------


def test_compression_matches_reference_over_steps():
    rng = np.random.default_rng(0)
    grads = {"w": (rng.standard_normal((64, 32)) * 0.01).astype(np.float32),
             "b": (rng.standard_normal(32) * 0.001).astype(np.float32),
             "layers": [(rng.standard_normal((2, 16, 8)) * 0.1).astype(np.float32)]}
    jerr = jx_comp.init_error_state(grads)
    perr = pt_comp.init_error_state(params_from_numpy(grads, device=CPU))
    for step in range(4):
        g = jax.tree.map(lambda x: (x * (1 + 0.5 * step)).astype(np.float32), grads)
        jc, jerr = jx_comp.compress_with_feedback(g, jerr)
        pc, perr = pt_comp.compress_with_feedback(params_from_numpy(g, device=CPU), perr)
        want_q, got_q = _leaves_by_path(jax.device_get(jc.q)), _leaves_by_path(
            params_to_numpy(pc.q))
        for path, want in want_q.items():
            q = pt_comp_leaf(pc.q, path)
            assert q.dtype == torch.int8, path
            np.testing.assert_array_equal(got_q[path], want, err_msg=f"int8 {path} step {step}")
        _trees_close(params_to_numpy(pc.scale), jax.device_get(jc.scale), 1e-6, "scales")
        _trees_close(params_to_numpy(perr), jax.device_get(jerr), 1e-6, "error state")
        _trees_close(params_to_numpy(pt_comp.decompress(pc)), jax.device_get(
            jx_comp.decompress(jc)), 1e-6, "decompressed")
    assert pt_comp.compression_ratio(params_from_numpy(grads, device=CPU)) == \
        jx_comp.compression_ratio(grads)


def pt_comp_leaf(tree, path: str) -> torch.Tensor:
    """The tensor at a ``jax.tree_util.keystr`` path of a port tree."""
    for part in path.strip("[]").split("]["):
        tree = tree[int(part) if part.isdigit() else part.strip("'")]
    return tree


def test_compression_error_feedback_converges():
    """``tests/test_packets_optim.py``'s error-feedback test on the port."""
    rng = np.random.default_rng(0)
    g = {"w": torch.from_numpy(rng.standard_normal((64, 32)) * 0.01),
         "b": torch.from_numpy(rng.standard_normal(32) * 0.001)}
    err = pt_comp.init_error_state(g)
    applied = {k: torch.zeros_like(v, dtype=torch.float32) for k, v in g.items()}
    n = 20
    for _ in range(n):
        comp, err = pt_comp.compress_with_feedback(g, err)
        applied = {k: applied[k] + d for k, d in pt_comp.decompress(comp).items()}
    for k in g:
        rel = float((applied[k] / n - g[k]).abs().max() / g[k].abs().max())
        assert rel < 0.02, (k, rel)
    assert pt_comp.compression_ratio(g) > 3.9


def test_quantization_rounds_half_to_even_as_the_reference():
    x = np.asarray([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 63.5, -126.5], np.float32)
    q, scale = pt_comp._quantize(torch.from_numpy(x))
    jq, jscale = jx_comp._quantize(jnp.asarray(x))
    assert float(scale) == float(jscale) == 1.0
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))


# -- data pipeline --------------------------------------------------------------------------


def test_synthetic_source_batches_equal_the_reference():
    jx_src, pt_src = jx_pipeline.SyntheticSource(300, seed=5), pt_pipeline.SyntheticSource(
        300, seed=5)
    for i in range(10):
        np.testing.assert_array_equal(pt_src.batch(i, 3, 16), jx_src.batch(i, 3, 16))


def test_memmap_source_batches_equal_the_reference(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(7).integers(0, 1000, 5000).astype(np.uint16).tofile(path)
    jx_src = jx_pipeline.MemmapSource(str(path), vocab=600, seed=3)
    pt_src = pt_pipeline.MemmapSource(str(path), vocab=600, seed=3)
    for i in range(10):
        np.testing.assert_array_equal(pt_src.batch(i, 2, 32), jx_src.batch(i, 2, 32))


def test_pipeline_batches_and_seek_replay_the_reference():
    cfg = dict(batch=2, seq=8)
    jx_pipe = jx_pipeline.DataPipeline(jx_pipeline.SyntheticSource(100, seed=9),
                                       jx_pipeline.PipelineConfig(**cfg))
    pt_pipe = pt_pipeline.DataPipeline(pt_pipeline.SyntheticSource(100, seed=9),
                                       pt_pipeline.PipelineConfig(**cfg), device=CPU)
    try:
        want = [next(jx_pipe) for _ in range(10)]
        got = [next(pt_pipe) for _ in range(10)]
        for w, g in zip(want, got):
            for key in ("tokens", "labels"):
                assert g[key].dtype == torch.int32 and g[key].device.type == "cpu"
                np.testing.assert_array_equal(g[key].numpy(), w[key])
        pt_pipe.seek(4)
        again = [next(pt_pipe) for _ in range(6)]
        for w, g in zip(want[4:], again):
            np.testing.assert_array_equal(g["tokens"].numpy(), w["tokens"])
    finally:
        jx_pipe.close()
        pt_pipe.close()
    assert not pt_pipe._thread.is_alive()


def test_pipeline_raises_a_batch_that_failed():
    class Broken:
        def batch(self, index, batch, seq):
            raise ValueError(f"no batch {index}")

    pipe = pt_pipeline.DataPipeline(Broken(), pt_pipeline.PipelineConfig(batch=1, seq=4),
                                    device=CPU)
    try:
        with pytest.raises(ValueError, match="no batch 0"):
            next(pipe)
    finally:
        pipe.close()
