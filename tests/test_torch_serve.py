"""The port's serving path against the JAX reference, on the CPU.

``tests/test_runtime.py::test_serve_loop_auth_and_decode`` on both packages
with the same params (``repro``'s init, carried across), the same
capabilities and the same requests: the rejected requests and the number of
batched steps must be equal, and every step's logits must agree within
``LOGITS`` (the row-RMS form of ``test_torch_models.py``: ``|got - want| <=
rtol |want| + row_atol rms(row)`` and ``||got - want|| <= rel_rms
||want||``; a two-layer bf16 model, whose one-ulp flips compound through
the stack, as ``ATTENTION_STACK`` there).  Where the two argmaxes of a slot
differ, the reference's top-2 gap there must lie within twice the
allowance (so either token is right within the tolerance), and the
comparison of logits stops: from then on the slots feed other tokens.
Then both launchers, ``python -m repro.launch.serve`` and ``python -m
repro_torch.launch.serve --device cpu``, must end alike.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np

from repro.core.auth import CapabilityAuthority as JxAuthority
from repro.core.auth import Rights as JxRights
from repro.models import ModelConfig as JxConfig
from repro.models import decode_step as jx_decode_step
from repro.models import init_cache as jx_init_cache
from repro.models import init_params as jx_init_params
from repro.runtime.serve_loop import Request as JxRequest
from repro.runtime.serve_loop import ServeLoop as JxServeLoop
from repro_torch.core.auth import CapabilityAuthority as PtAuthority
from repro_torch.core.auth import Rights as PtRights
from repro_torch.models import ModelConfig as PtConfig
from repro_torch.models import decode_step as pt_decode_step
from repro_torch.models import init_cache as pt_init_cache
from repro_torch.models.convert import params_from_numpy
from repro_torch.runtime.serve_loop import Request as PtRequest
from repro_torch.runtime.serve_loop import ServeLoop as PtServeLoop

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
LOGITS = {"rtol": 2 ** -7, "row_atol": 0.1, "rel_rms": 2e-2}
#: tests/test_runtime.py's model
CFG = dict(name="rt-tiny", family="dense", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
           d_ff=64, vocab=64, loss_chunk=8, attn_block=8)
KEY = b"0123456789abcdef"


def _compiled(fn, *args):
    """``jax.jit(fn)`` for ``args``' shapes, compiled with the options of
    ``test_torch_models.FAST_COMPILE`` (LLVM's optimisation level changes no
    rounding; it halves the compile time)."""
    return jax.jit(fn).lower(*args).compile(
        {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True})


def _allowance(want: np.ndarray) -> np.ndarray:
    row_rms = np.sqrt(np.square(want).mean(axis=-1, keepdims=True))
    return LOGITS["rtol"] * np.abs(want) + LOGITS["row_atol"] * row_rms


def _serve(loop_cls, request_cls, authority, step, params, init_cache, rights):
    """Run tests/test_runtime.py's requests through one package's loop."""
    expiry = int(time.time()) + 3600
    good = authority.issue(1, 0, 0, 1 << 20, rights.READ, expiry)
    bad = authority.issue(1, 0, 0, 1 << 20, rights.WRITE, expiry)   # no READ right
    reqs = [
        request_cls(rid=0, prompt=[1, 2, 3], max_tokens=4, capability=good),
        request_cls(rid=1, prompt=[4, 5], max_tokens=3, capability=good),
        request_cls(rid=2, prompt=[6], max_tokens=2, capability=bad),
        request_cls(rid=3, prompt=[7, 8, 9, 10], max_tokens=5, capability=good),
        request_cls(rid=4, prompt=[11], max_tokens=6, capability=good),
        request_cls(rid=5, prompt=[12, 13], max_tokens=1, capability=bad),
    ]
    loop = loop_cls(step, params, init_cache, batch_slots=4, authority=authority, eos_id=-1)
    done = loop.run(reqs, max_steps=64)
    return loop, {r.rid: r for r in done}


def test_serve_loop_matches_reference():
    cfg_j, cfg_t = JxConfig(**CFG), PtConfig(**CFG)
    key = jax.random.PRNGKey(1)
    jp = jax.device_get(_compiled(lambda k: jx_init_params(cfg_j, k), key)(key))
    pp = params_from_numpy(jp, device=CPU)
    jx_logits, pt_logits, jx_step = [], [], []

    def jx_recording(p, c, b):
        if not jx_step:
            jx_step.append(_compiled(lambda p, c, b: jx_decode_step(p, cfg_j, c, b), p, c, b))
        logits, c = jx_step[0](p, c, b)
        jx_logits.append(np.asarray(logits, np.float32)[:, 0])
        return logits, c

    def pt_recording(p, c, b):
        assert isinstance(b["cur_len"], int)    # no device sync for the position
        logits, c = pt_decode_step(p, cfg_t, c, b)
        pt_logits.append(logits[:, 0].numpy())
        return logits, c

    jx_loop, jx_done = _serve(JxServeLoop, JxRequest, JxAuthority(KEY), jx_recording, jp,
                              lambda: jx_init_cache(cfg_j, 4, 64), JxRights)
    pt_loop, pt_done = _serve(PtServeLoop, PtRequest, PtAuthority(KEY), pt_recording, pp,
                              lambda: pt_init_cache(cfg_t, 4, 64, device=CPU), PtRights)

    assert sorted(r for r, q in pt_done.items() if q.rejected) == \
        sorted(r for r, q in jx_done.items() if q.rejected) == [2, 5]
    assert all(not pt_done[r].out for r in (2, 5))
    assert pt_loop.steps == jx_loop.steps and len(pt_logits) == len(jx_logits) == jx_loop.steps
    assert {r: len(q.out) for r, q in pt_done.items()} == \
        {r: len(q.out) for r, q in jx_done.items()}
    for step, (got, want) in enumerate(zip(pt_logits, jx_logits)):
        diff = np.abs(got - want)
        assert (diff <= _allowance(want)).all(), f"step {step}: logits beyond {LOGITS}"
        assert np.linalg.norm(diff) <= LOGITS["rel_rms"] * np.linalg.norm(want), step
        split = got.argmax(-1) != want.argmax(-1)
        if split.any():
            top2 = np.sort(want[split], axis=-1)[:, -2:]
            room = 2 * _allowance(want[split]).max(axis=-1)
            assert (top2[:, 1] - top2[:, 0] <= room).all(), f"step {step}: argmax differs"
            return            # the slots now feed other tokens: compare no further
    assert {r: q.out for r, q in pt_done.items()} == {r: q.out for r, q in jx_done.items()}


def _launch(package: str, *extra: str) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-m", f"{package}.launch.serve", "--arch", "qwen1.5-4b", "--smoke",
         *extra], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu"))


def test_serve_launcher_ends_as_the_reference_does():
    """Both launchers at once: the same counts of served and rejected
    requests, tokens and batched steps."""
    procs = [_launch("repro"), _launch("repro_torch", "--device", "cpu")]
    outs = []
    for proc in procs:
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-2000:]
        outs.append(out)
    summary = re.compile(r"served (\d+) requests \((\d+) tokens\) in [\d.]+s over (\d+) "
                         r"batched decode steps; rejected (\d+) bad tickets")
    want, got = (summary.search(out) for out in outs)
    assert want and got, outs
    assert got.groups() == want.groups()
    assert outs[1].splitlines()[0] == outs[0].splitlines()[0]     # arch, family, slots

