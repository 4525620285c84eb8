"""The port's sharded decode (``make_serve_step`` on a mesh) on gloo
process groups (CPU).

A decode step on a mesh keeps each cache where ``cache_specs`` places it
(batch over data; the model axis on the head vector, a state's last dim or
the MLA latent) and never gathers a layer's KV cache: each rank writes its
shard at the clamped slot, its partial scores are summed over model before
the mask, and the attention output is gathered.  Every result is held
against the port's one-device ``decode_step`` from the same params, cache
and tokens, four steps after a seeded prompt the one-device decode wrote
into the cache, the last writing at ``cur_len = Smax``:

* on meshes (2, 2), (4, 1) and (1, 4), 4 gloo ranks, every product in fp32
  and fp32 caches: the logits of each step and every cache leaf after the
  last, gathered whole, within ``FP32`` (1e-5) relative RMS error (the
  sharded step adds the same fp32 terms in another order).  deepseek-v2's
  decode rounds to bf16 whatever the switch (MLA's absorbed attention casts
  its softmax weights and latent output, its MoE experts run bf16, as in
  the reference): a score summed in another order can flip one weight's
  rounding by one bf16 ulp, which moves a row's output by at most that
  fraction, so it is held within ``BF16_ROUNDED`` (2^-8; ``chip_smoke.py``'s
  rehearsal read 2.5e-4 on another seed);
* on a (1, 1) mesh, as shipped (bf16), bit for bit;
* one case (yi on (2, 2), as shipped) against the reference's
  ``decode_step`` on the same numpy params, cache and tokens, within the
  model tests' ``ATTENTION_STACK`` (the packages round bf16 in other
  orders; ``tests/test_torch_models.py``).
"""

import json
import math
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import conftest

TESTS = Path(__file__).resolve().parent
sys.path.insert(0, str(TESTS))
import _torch_sharded_worker as worker  # noqa: E402

FP32 = 1e-5
BF16_ROUNDED = {"deepseek-v2-lite-16b": 2 ** -8}
CASES = [f"{name}/{mesh}" for name in worker.DECODE_FAMILIES for mesh in worker.DECODE_MESHES]


def _run_world(out: Path, world: int, phases: str) -> list[dict]:
    proc = subprocess.run(
        [sys.executable, str(TESTS / "_torch_sharded_worker.py"), str(out), "--world",
         str(world), "--phases", phases],
        env=conftest.multidevice_subprocess_env(), capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return [json.loads((out / f"rank{i}.json").read_text()) for i in range(world)]


@pytest.fixture(scope="module")
def world(tmp_path_factory) -> tuple[list[dict], Path]:
    out = tmp_path_factory.mktemp("torch_sharded_decode")
    return _run_world(out, 4, "decode"), out


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory) -> dict:
    return _run_world(tmp_path_factory.mktemp("torch_decode_one"), 1, "decode_one")[0]


@pytest.mark.parametrize("case", CASES)
def test_sharded_decode_matches_one_device(world, case):
    ranks, _ = world
    name = case.split("/")[0]
    cfg = worker._decode_case(name)[0]
    limit = BF16_ROUNDED.get(name, FP32)
    for rank in ranks:
        result = rank["decode"][case]
        assert result["shape"] == [worker.DECODE_BATCH, 1, cfg.vocab]
        assert len(result["logits"]) == len(worker.DECODE_CUR_LENS)
        assert max(result["logits"]) <= limit, result["logits"]
        worst = max(result["cache"], key=result["cache"].get)
        assert result["cache"][worst] <= limit, (worst, result["cache"][worst])
        assert result["placed"]


def test_caches_stay_split_by_the_rules(world):
    """The model axis splits a head's vector (GQA and whisper's k/v,
    zamba2's shared k/v), the state dim (Mamba2), the latent and rope dims
    (MLA) and the xLSTM states' last dims; the batch lies over data."""
    decode = world[0][0]["decode"]
    for case, leaf, spec in [
            ("yi-9b/2x2", "scan/k", "P(None, 'data', None, None, 'model')"),
            ("deepseek-v2-lite-16b/2x2", "first/0/c", "P('data', None, 'model')"),
            ("deepseek-v2-lite-16b/2x2", "scan/kr", "P(None, 'data', None, 'model')"),
            ("zamba2-2.7b/2x2", "ssm", "P(None, None, 'data', None, None, 'model')"),
            ("zamba2-2.7b/2x2", "shared_k", "P(None, 'data', None, None, 'model')"),
            ("xlstm-125m/2x2", "0/0", "P('data', None, None, 'model')"),
            ("xlstm-125m/2x2", "0/2", "P('data', 'model')"),
            ("whisper-base/2x2", "cross/k", "P(None, 'data', None, None, 'model')")]:
        assert decode[case]["specs"][leaf] == spec, (case, leaf)


def test_no_step_gathers_a_kv_cache(world):
    """Every all-gather of the sharded steps holds weights or a token's
    activations: none has a cache's sequence axis."""
    for rank in world[0]:
        shapes = rank["decode"]["gathered_shapes"]
        assert shapes
        assert not [s for s in shapes if worker.DECODE_MAX_LEN in s]


@pytest.mark.parametrize("name", worker.DECODE_FAMILIES)
def test_one_rank_mesh_decode_is_bitwise_one_device(one_rank, name):
    assert one_rank["decode_one"][name] == {"logits": True, "cache": True}


def test_sharded_decode_matches_reference(world):
    """The reference case's sharded logits against the reference's own
    ``decode_step`` (``jax.jit``, as the model tests run it) on the same
    params, cache and tokens."""
    import jax
    import jax.numpy as jnp

    import test_torch_models as models_test
    from repro import models as jx_models
    from repro.configs import ARCHS as JX_ARCHS

    with open(world[1] / "decode_reference_case.pkl", "rb") as f:
        case = pickle.load(f)
    cfg = JX_ARCHS[case["name"]].smoke
    params = jax.tree.map(jnp.asarray, case["params"])
    like = jx_models.init_cache(cfg, worker.DECODE_BATCH, worker.DECODE_MAX_LEN)
    cache = jax.tree.map(lambda a, ref: jnp.asarray(a).astype(ref.dtype), case["cache"], like)
    step = models_test._fast_jit(lambda p, c, b: jx_models.decode_step(p, cfg, c, b))
    for i, cur_len in enumerate(case["cur_lens"]):
        tok = jnp.asarray(case["tokens"][:, i:i + 1])
        want, cache = step(params, cache, {"tokens": tok,
                                           "cur_len": jnp.asarray(cur_len, jnp.int32)})
        models_test._assert_close(case["logits"][i], want, models_test.ATTENTION_STACK,
                                  f"logits at cur_len {cur_len}")
        assert math.isfinite(float(np.abs(case["logits"][i]).max()))
