"""The port's sharded train and prefill steps, elastic reshard, sharded
data pipeline and expert-parallel MoE on gloo process groups (CPU).

Sharding changes where tensors live, never what the step computes: each
sharded result is held against the port's one-device step on the same
params and batch.  One 4-rank world runs every phase once per module
(``tests/_torch_sharded_worker.py``); each rank reports, per leaf, the
squared error of the shard it holds the counted copy of, and the test adds
the ranks up into each leaf's relative RMS error.  Limits, each with its
reason:

* every product in fp32 (``dense_apply``, ``embed_apply`` and the loss's
  logits switched, as ``tests/test_torch_grads.py`` switches them): the
  loss and every leaf of params, ``m`` and ``v`` within ``FP32`` (1e-5):
  the sharded step only sums the same fp32 terms in another order (read
  at most 6e-6, v of xlstm on (4, 1));
* as shipped (bf16 products), and the MoE family in either mode (its
  experts run bf16 einsums whatever the switch): ``m`` within ``BF16``
  (5e-2, ``test_torch_grads.BF16_GRAD``; read at most 2.2e-2), ``v``, the
  square, within twice that, and the params within ``BF16`` except the
  leaves that start at zero (biases), whose value after one step is
  AdamW's elementwise-normalised direction, a sign wherever the gradient
  is rounding noise (they are held through ``m``, ``v`` and fp32 mode);
  the loss within ``FP32`` in every mode (read at most 1.6e-7).

The deepseek-v2 family runs its MoE layers through ``moe_ep_apply``
(``model_constraints`` sets ``moe_ep`` on both meshes) at a capacity
factor of 8, which drops nothing, so per-rank and per-row routing agree.
``moe_ep_apply`` itself runs on an 8-rank (2, 4) world at the reference
test's sizes (``tests/test_multidevice.py::test_moe_ep_shardmap``) against
the reference's own ``moe_ep_apply`` (a JAX subprocess with 8 host
devices, ``conftest.multidevice_subprocess_env``), within its 3e-2, and
against the port's dense ``moe_apply``, values and gradients.
"""

import collections
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import conftest

TESTS = Path(__file__).resolve().parent
sys.path.insert(0, str(TESTS))
import _torch_sharded_worker as worker  # noqa: E402

WORLD = 4
FP32 = 1e-5
BF16 = 5e-2
MOE_TOL = 3e-2
MOE_GRAD = 2e-2
CASES = [f"{name}/{mesh}/{mode}" for name in worker.FAMILIES for mesh in worker.MESHES
         for mode in worker.MODES]


def _run_world(out: Path, world: int, phases: str) -> list[dict]:
    proc = subprocess.run(
        [sys.executable, str(TESTS / "_torch_sharded_worker.py"), str(out), "--world",
         str(world), "--phases", phases],
        env=conftest.multidevice_subprocess_env(), capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return [json.loads((out / f"rank{i}.json").read_text()) for i in range(world)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory) -> list[dict]:
    return _run_world(tmp_path_factory.mktemp("torch_sharded"), WORLD,
                      "steps,prefill,elastic,pipeline")


def _relative_errors(ranks: list[dict], case: str, kind: str) -> dict[str, float]:
    total = collections.defaultdict(lambda: [0.0, 0.0])
    for rank in ranks:
        for path, (err, norm) in rank["steps"][case][kind].items():
            total[path][0] += err
            total[path][1] += norm
    return {path: math.sqrt(err) / math.sqrt(norm) if norm else math.sqrt(err)
            for path, (err, norm) in total.items()}


@pytest.mark.parametrize("case", CASES)
def test_sharded_train_step_matches_one_device(ranks, case):
    name, mesh, mode = case.split("/")
    first = ranks[0]["steps"][case]
    got, want = first["loss"]
    assert abs(got - want) <= FP32 * abs(want)
    assert first["step"][0] == first["step"][1] == worker.START_STEP + 1
    assert all(rank["steps"][case]["placed"] for rank in ranks)
    exact = mode == "fp32" and name != "deepseek-v2-lite-16b"
    limits = ({"params": FP32, "m": FP32, "v": FP32} if exact else
              {"params": BF16, "m": BF16, "v": 2 * BF16})
    for kind, limit in limits.items():
        errors = _relative_errors(ranks, case, kind)
        assert errors, kind
        if kind == "params" and not exact:
            errors = {p: e for p, e in errors.items() if p not in first["zero_init"]}
        worst = max(errors, key=errors.get)
        assert errors[worst] <= limit, (kind, worst, errors[worst])
    gn, gn_want = first["grad_norm"]
    assert abs(gn - gn_want) <= (FP32 if exact else BF16) * gn_want


@pytest.mark.parametrize("case", CASES)
def test_sharded_train_step_hands_adamw_contiguous_shards(ranks, case):
    """Every param, gradient and moment shard that the sharded step hands
    AdamW is contiguous, as its kernel on the card takes them; a
    reduce-scatter along a dim other than 0 returns a permuted layout."""
    assert all(rank["steps"][case]["adamw_contiguous"] for rank in ranks)


def test_moe_family_takes_the_expert_parallel_path(ranks):
    for mesh in worker.MESHES:
        assert ranks[0]["steps"][f"deepseek-v2-lite-16b/{mesh}/bf16"]["moe_ep"]
        assert not ranks[0]["steps"][f"yi-9b/{mesh}/bf16"]["moe_ep"]


@pytest.mark.parametrize("name", list(worker.FAMILIES))
def test_context_parallel_prefill_matches_one_device(ranks, name):
    """(1, 4): each rank holds a quarter of the sequence, its attention rows
    at their offset against the gathered K/V; the plain flash version and
    the one-device prefill walk the same tiles, so the logits agree to the
    bit on the CPU."""
    for rank in ranks:
        result = rank["prefill"][name]
        assert result["shape"] == [2, 1, worker.smoke_cfg(name).vocab]
        assert result["err"] <= FP32 * result["norm"]


def test_elastic_reshard_shrink_and_grow_keep_every_value(ranks):
    for i, rank in enumerate(ranks):
        elastic = rank["elastic"]
        assert elastic["small_shape"] == {"data": 2, "model": 2}
        assert elastic["reshard_equal"] and elastic["grow_equal"]
        assert elastic["reshard_placed"]
        if i < 2:
            assert elastic["shrink_shape"] == {"data": 1, "model": 2}
            assert elastic["shrink_equal"]
        else:
            assert elastic["shrink_evicted"]


def test_pipeline_places_batches_per_data_batch_specs(ranks):
    for rank in ranks:
        pipeline = rank["pipeline"]
        assert pipeline["placed"] and pipeline["equal"]
        assert pipeline["local_rows"] == [2, 2]


# -- expert parallelism on 8 ranks -------------------------------------------------------

_REFERENCE = r"""
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P, NamedSharding
from repro.models import moe as moe_mod

mesh = jax.make_mesh((2, 4), ("data", "model"))
E, K, d, ff, B, S = 8, 2, 32, 64, 4, 16
p = moe_mod.moe_init(jax.random.PRNGKey(0), d, ff, E)
x = jax.random.normal(jax.random.PRNGKey(1), (B, S, d), jnp.float32)
xs = jax.device_put(x, NamedSharding(mesh, P("data", "model", None)))
ps = dict(p)
ps["w_gate"] = jax.device_put(p["w_gate"], NamedSharding(mesh, P("model", "data", None)))
ps["w_up"] = jax.device_put(p["w_up"], NamedSharding(mesh, P("model", "data", None)))
ps["w_down"] = jax.device_put(p["w_down"], NamedSharding(mesh, P("model", None, "data")))
ps["router"] = {"w": jax.device_put(p["router"]["w"], NamedSharding(mesh, P("data", None)))}
f = lambda pp, xx: moe_mod.moe_ep_apply(pp, xx, E, K, 8.0, mesh, ("data",), "model")
with mesh:
    got = jax.jit(f)(ps, xs)
    g = jax.jit(jax.grad(lambda pp, xx: (f(pp, xx).astype(jnp.float32) ** 2).sum(),
                         argnums=(0, 1)))(ps, xs)
np.savez(sys.argv[1], router=np.asarray(p["router"]["w"]), w_gate=np.asarray(p["w_gate"]),
         w_up=np.asarray(p["w_up"]), w_down=np.asarray(p["w_down"]), x=np.asarray(x),
         out=np.asarray(got, np.float32), grad_router=np.asarray(g[0]["router"]["w"]),
         grad_w_gate=np.asarray(g[0]["w_gate"]), grad_w_up=np.asarray(g[0]["w_up"]),
         grad_w_down=np.asarray(g[0]["w_down"]), grad_x=np.asarray(g[1], np.float32))
print("REFERENCE_OK")
"""

#: how each array of the (2, 4) world is cut: {dim: mesh axis}
_LAYOUT = {"out": {0: "data", 1: "model"}, "grad_x": {0: "data", 1: "model"},
           "grad_router": {0: "data"}, "grad_w_gate": {0: "model", 1: "data"},
           "grad_w_up": {0: "model", 1: "data"}, "grad_w_down": {0: "model", 2: "data"}}


@pytest.fixture(scope="module")
def moe_world(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_moe_ep")
    proc = subprocess.run([sys.executable, "-c", _REFERENCE, str(out / "reference.npz")],
                          env=conftest.multidevice_subprocess_env(), capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    _run_world(out, 8, "moe_ep")
    ranks = [dict(np.load(out / f"moe_rank{i}.npz")) for i in range(8)]
    return dict(np.load(out / "reference.npz")), ranks


def _assemble(ranks: list[dict], key: str) -> np.ndarray:
    """The whole array from the ranks' blocks (a block replicated over an
    axis its layout does not cut is taken from index 0 there)."""
    layout = _LAYOUT[key]
    blocks = {tuple(r["coords"]): r[key] for r in ranks}
    sizes = {"data": 2, "model": 4}

    def join(fixed: dict, axes: list) -> np.ndarray:
        if not axes:
            return blocks[(fixed.get("data", 0), fixed.get("model", 0))]
        dim, axis = axes[0]
        return np.concatenate([join({**fixed, axis: i}, axes[1:]) for i in range(sizes[axis])],
                              axis=dim)

    return join({}, sorted(layout.items()))


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_moe_ep_matches_reference_and_dense_path(moe_world):
    ref, ranks = moe_world
    out = _assemble(ranks, "out")
    np.testing.assert_allclose(out, ref["out"], rtol=MOE_TOL, atol=MOE_TOL)
    np.testing.assert_allclose(out, ranks[0]["dense"], rtol=MOE_TOL, atol=MOE_TOL)


@pytest.mark.parametrize("leaf", ["router", "w_gate", "w_up", "w_down", "x"])
def test_moe_ep_gradients_match_dense_path_and_reference(moe_world, leaf):
    """sum(out ** 2)'s gradients, each shard where its rank holds it, joined:
    against the dense path's (the router's summed over the model ranks
    that all use it whole) and the reference's ``moe_ep_apply``'s."""
    ref, ranks = moe_world
    got = _assemble(ranks, f"grad_{leaf}")
    assert np.isfinite(got).all()
    assert _rel(got, ranks[0][f"dense_grad_{leaf}"]) <= MOE_GRAD
    assert _rel(got, ref[f"grad_{leaf}"]) <= MOE_TOL
