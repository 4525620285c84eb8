"""The port's training runtime on the CPU: remat, the stacked layers'
backward, the fault-tolerant ``Trainer`` against the reference's, and both
training launchers.

* ``cfg.remat`` on against off: every registered architecture's smoke
  config gives the same loss and the same gradients, bit for bit (the CPU
  is deterministic, and a recompute runs the same operations on the same
  inputs); remat leaves a forward under ``no_grad`` as it was.
* A stacked leaf feeds the stack through one ``unbind``: its gradient is
  one stack of the layers' gradients, not one zero-filled tensor of the
  stack's size per layer.
* ``tests/test_runtime.py``'s trainer (its ``rt-tiny`` model, AdamW,
  ``SyntheticSource``, an RS(3,2) checkpoint every 4 steps) on both
  packages from the reference's params: the losses agree within ``LOSS``
  a step, and fall; the failure at step 9 (with storage node 2 lost)
  restores step 8, replays steps 9-12, and every replayed loss equals its
  first run's bit for bit; the restored state is the state saved at step 8.
* ``python -m repro.launch.train`` and ``repro_torch.launch.train.main``
  with ``--device cpu``, for the reference's documented ``--smoke`` command:
  one restart each, finite losses, and the same storage statistics (the
  two checkpoint trees hold the same leaves and bytes).
"""

from __future__ import annotations

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JxManager
from repro.checkpoint.manager import CheckpointPolicy as JxPolicy
from repro.checkpoint.storage import StorageCluster as JxCluster
from repro.data.pipeline import DataPipeline as JxPipeline
from repro.data.pipeline import PipelineConfig as JxPipelineConfig
from repro.data.pipeline import SyntheticSource as JxSource
from repro.models import ModelConfig as JxConfig
from repro.models import init_params as jx_init_params
from repro.models import loss_fn as jx_loss_fn
from repro.optim.adamw import AdamWConfig as JxAdam
from repro.optim.adamw import adamw_update as jx_adamw_update
from repro.optim.adamw import init_opt_state as jx_init_opt_state
from repro.runtime.train_loop import Trainer as JxTrainer
from repro.runtime.train_loop import TrainLoopConfig as JxLoopConfig
from repro_torch.checkpoint.manager import CheckpointManager, CheckpointPolicy
from repro_torch.checkpoint.storage import StorageCluster
from repro_torch.configs import ARCHS
from repro_torch.data.pipeline import DataPipeline, PipelineConfig, SyntheticSource
from repro_torch.launch import train as pt_train
from repro_torch.launch.steps import loss_and_grads
from repro_torch.models import ModelConfig, forward, init_params, loss_fn
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.models.layers import tree_leaves
from repro_torch.optim.adamw import AdamWConfig, adamw_update, init_opt_state
from repro_torch.runtime.train_loop import Trainer, TrainLoopConfig

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
#: a loss a step, the two packages' trainers apart: bf16 products rounded
#: in other orders, carried through a few AdamW steps
LOSS = 2e-2
NAMES = sorted(ARCHS)
#: tests/test_runtime.py's model
TINY = dict(name="rt-tiny", family="dense", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
            d_ff=64, vocab=64, loss_chunk=8, attn_block=8)


def _batch(cfg, seed=29, b=2, s=32):
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (b, s))),
             "labels": torch.from_numpy(rng.integers(0, cfg.vocab, (b, s)))}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(
            rng.standard_normal((b, s, cfg.d_model), dtype=np.float32)).to(torch.bfloat16)
    if cfg.frontend == "vision_stub":
        batch["patch_embeds"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.frontend_tokens, cfg.d_model), dtype=np.float32)).to(torch.bfloat16)
    return batch


# -- remat ----------------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_remat_gives_the_same_gradients(name):
    cfg = ARCHS[name].smoke
    params = init_params(cfg, seed=3, device=CPU)
    batch = _batch(cfg)
    loss_on, grads_on = loss_and_grads(params, dataclasses.replace(cfg, remat=True), batch)
    loss_off, grads_off = loss_and_grads(params, dataclasses.replace(cfg, remat=False), batch)
    assert torch.equal(loss_on, loss_off)
    for on, off in zip(tree_leaves(grads_on), tree_leaves(grads_off), strict=True):
        assert torch.isfinite(on).all() and torch.equal(on, off)
    with torch.no_grad():
        hidden = [forward(params, dataclasses.replace(cfg, remat=r), batch) for r in (True, False)]
    assert torch.equal(*hidden)


def test_remat_recomputes_each_layer_in_the_backward(monkeypatch):
    """With remat, each decoder layer runs twice (forward and recompute);
    without, once; under ``no_grad``, once."""
    from repro_torch.models import transformer as tf

    cfg = ARCHS["yi-9b"].smoke
    params = init_params(cfg, seed=3, device=CPU)
    calls = []
    apply = tf.decoder_layer_apply
    monkeypatch.setattr(tf, "decoder_layer_apply",
                        lambda *a, **k: calls.append(1) or apply(*a, **k))
    for remat, want in ((True, 2 * cfg.n_layers), (False, cfg.n_layers)):
        calls.clear()
        loss_and_grads(params, dataclasses.replace(cfg, remat=remat), _batch(cfg))
        assert len(calls) == want, (remat, len(calls))
    calls.clear()
    with torch.no_grad():
        forward(params, cfg, _batch(cfg))
    assert len(calls) == cfg.n_layers


def _consumers(loss: torch.Tensor, leaf: torch.Tensor) -> list[str]:
    """The autograd nodes that feed ``leaf``'s gradient accumulator."""
    seen, stack, found = set(), [loss.grad_fn], []
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        for child, _ in node.next_functions:
            if child is not None and getattr(child, "variable", None) is leaf:
                found.append(type(node).__name__)
            stack.append(child)
    return found


@pytest.mark.parametrize("name", ["yi-9b", "zamba2-2.7b", "whisper-base"])
def test_a_stacked_leaf_feeds_the_stack_through_one_unbind(name):
    cfg = dataclasses.replace(ARCHS[name].smoke, remat=False)
    params = init_params(cfg, seed=3, device=CPU)
    stacked = {"yi-9b": lambda p: p["layers"]["attn"]["wq"]["w"],
               "zamba2-2.7b": lambda p: p["groups"]["in_proj"]["w"],
               "whisper-base": lambda p: p["dec_layers"]["self"]["wq"]["w"]}[name]
    leaf = stacked(params).requires_grad_()
    loss = loss_fn(params, cfg, _batch(cfg))
    # zamba2's (groups, per_group) stack is flattened (a view) before its unbind
    want = "ViewBackward0" if cfg.family == "hybrid" else "UnbindBackward0"
    assert _consumers(loss, leaf) == [want]


# -- the trainer, against the reference's ---------------------------------------------------


def _jx_trainer(total_steps, ckpt_every=4):
    cfg = JxConfig(**TINY)
    params = jx_init_params(cfg, jax.random.PRNGKey(0))
    adam = JxAdam(lr=1e-3)

    @jax.jit
    def step_fn(p, o, batch):
        loss, grads = jax.value_and_grad(lambda q: jx_loss_fn(q, cfg, batch))(p)
        p2, o2, m = jx_adamw_update(p, grads, o, adam)
        m["loss"] = loss
        return p2, o2, m

    pipe = JxPipeline(JxSource(cfg.vocab, seed=1), JxPipelineConfig(batch=2, seq=16))
    cluster = JxCluster(num_nodes=6, node_capacity=1 << 24)
    mgr = JxManager(cluster, JxPolicy(k=3, m=2, stripe_bytes=1 << 18))
    tr = JxTrainer(step_fn, params, jx_init_opt_state(params), pipe, mgr,
                   JxLoopConfig(total_steps=total_steps, checkpoint_every=ckpt_every))
    return tr, cluster, params


def _pt_trainer(jx_params, total_steps, ckpt_every=4):
    cfg = ModelConfig(**TINY)
    params = params_from_numpy(jax.device_get(jx_params), device=CPU)
    adam = AdamWConfig(lr=1e-3)

    def step_fn(p, o, batch):
        loss, grads = loss_and_grads(p, cfg, batch)
        p2, o2, m = adamw_update(p, grads, o, adam)
        m["loss"] = loss
        return p2, o2, m

    pipe = DataPipeline(SyntheticSource(cfg.vocab, seed=1), PipelineConfig(batch=2, seq=16),
                        device=CPU)
    cluster = StorageCluster(num_nodes=6, node_capacity=1 << 24, device=CPU)
    mgr = CheckpointManager(cluster, CheckpointPolicy(k=3, m=2, stripe_bytes=1 << 18))
    tr = Trainer(step_fn, params, init_opt_state(params), pipe, mgr,
                 TrainLoopConfig(total_steps=total_steps, checkpoint_every=ckpt_every))
    return tr, cluster


def test_training_loss_decreases_as_the_reference_s():
    jx_tr, _, jx_params = _jx_trainer(total_steps=15)
    pt_tr, _ = _pt_trainer(jx_params, total_steps=15)
    try:
        want = [h["loss"] for h in jx_tr.run()]
        got = [h["loss"] for h in pt_tr.run()]
    finally:
        jx_tr.pipeline.close()
        pt_tr.pipeline.close()
    assert len(got) == len(want) == 15
    np.testing.assert_allclose(got, want, rtol=LOSS)
    assert np.isfinite(got).all() and np.mean(got[-3:]) < np.mean(got[:3])
    assert [h["step"] for h in pt_tr.history] == list(range(1, 16))


def test_failure_restore_replays_bit_for_bit():
    """Crash at step 9 -> restore from the step-8 checkpoint -> finish, on
    both packages; the port's replayed steps equal their first run."""
    _, _, jx_params = _jx_trainer(total_steps=12)
    tr, cluster = _pt_trainer(jx_params, total_steps=12)
    saved = {}
    fired = {"done": False}

    def inject(step, trainer):
        if step == 8 and 8 not in saved:
            saved[8] = params_to_numpy({"params": trainer.params, "opt": trainer.opt_state})
        if step == 9 and not fired["done"]:
            fired["done"] = True
            cluster.fail_node(2)           # storage node also dies (EC absorbs)
            return True                     # compute failure
        return False

    real_restore = tr.restore_latest
    restored = {}

    def restore_and_keep():
        real_restore()
        restored["state"] = params_to_numpy({"params": tr.params, "opt": tr.opt_state})
        restored["leaves"] = tree_leaves({"params": tr.params, "opt": tr.opt_state})

    tr.restore_latest = restore_and_keep
    try:
        hist = tr.run(inject_failure=inject)
    finally:
        tr.pipeline.close()
    assert tr.restarts == 1 and tr.step == 12
    steps = [h["step"] for h in hist]
    assert steps == [1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 10, 11, 12]
    first, replay = hist[8], hist[9]
    assert first["loss"] == replay["loss"]                        # step 9, bit for bit
    for path, want in _by_path(saved[8]).items():
        np.testing.assert_array_equal(_by_path(restored["state"])[path], want, err_msg=path)
    assert all(t.device.type == "cpu" and not t.requires_grad and t.grad_fn is None
               for t in restored["leaves"])
    assert restored["leaves"][0].dtype == torch.float32


def test_restore_replays_the_same_losses_as_an_uninterrupted_run():
    _, _, jx_params = _jx_trainer(total_steps=12)
    plain, _ = _pt_trainer(jx_params, total_steps=12)
    failing, cluster = _pt_trainer(jx_params, total_steps=12)

    def inject(step, trainer):
        if step == 10 and trainer.restarts == 0:
            cluster.fail_node(2)
            return True
        return False

    try:
        want = [h["loss"] for h in plain.run()]
        got = failing.run(inject_failure=inject)
    finally:
        plain.pipeline.close()
        failing.pipeline.close()
    # steps 9 and 10 ran twice (the checkpoint is step 8's); all equal
    assert [h["step"] for h in got] == [*range(1, 11), 9, 10, 11, 12]
    assert [h["loss"] for h in got] == want[:10] + want[8:]


def _by_path(tree) -> dict:
    return {jax.tree_util.keystr(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


# -- the launchers ----------------------------------------------------------------------------

SMOKE_COMMAND = ["--arch", "yi-9b", "--smoke", "--steps", "30", "--fail-at", "20"]


def test_both_training_launchers_run_the_documented_smoke_command(capsys):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    ref = subprocess.run([sys.executable, "-m", "repro.launch.train", *SMOKE_COMMAND],
                         cwd=ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert ref.returncode == 0, ref.stdout + ref.stderr
    trainer = pt_train.main([*SMOKE_COMMAND, "--device", "cpu"])
    hist = trainer.history
    out = capsys.readouterr().out
    assert trainer.restarts == 1 and len(hist) == 30 and np.isfinite([h["loss"] for h in hist]).all()
    for text in (ref.stdout, out):
        assert "!! injected failure at step 20; restoring" in text
        assert re.search(r"ran 30 steps in [\d.]+s \(restarts=1\)", text), text
    storage = [re.search(r"storage: (.*)", text).group(1) for text in (ref.stdout, out)]
    assert storage[0] == storage[1]
    losses = re.search(r"loss ([\d.]+) -> ([\d.]+)", out).groups()
    assert float(losses[1]) < float(losses[0])


def test_training_launcher_replicated_policy():
    hist = pt_train.main(["--arch", "qwen1.5-4b", "--smoke", "--steps", "4",
                          "--checkpoint-every", "2", "--policy", "replicate",
                          "--device", "cpu"]).history
    assert len(hist) == 4 and np.isfinite([h["loss"] for h in hist]).all()
