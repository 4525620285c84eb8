"""The port's broadcasts and ring collectives against the reference's, on
the CPU.

One 8-rank gloo world runs every port collective once per module
(``tests/_torch_collectives_worker.py``); one JAX subprocess with 8 forced
host devices (the ``multidevice_env`` of ``tests/conftest.py``) runs the
reference's ``ring_broadcast``, ``pbt_broadcast`` and ring collective
bodies under ``shard_map`` on the same inputs (those of
``tests/test_multidevice.py``).  Every output must be bit-exact.  The
reference's ``replicate()`` fails on the installed JAX, so the port's
``replicate`` is held to the ``pbt_broadcast`` body it wraps.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import conftest
from repro.core import replication as jx_replication
from repro.core.packets import ReplStrategy as JxStrategy
from repro_torch.core import replication as pt_replication
from repro_torch.core.packets import ReplStrategy

TESTS = Path(__file__).resolve().parent
WORLD = 8

_REFERENCE = r"""
import sys
from functools import partial
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P, NamedSharding
from repro.core.replication import ring_broadcast, pbt_broadcast
from repro.parallel.collectives import (ring_all_gather, ring_reduce_scatter,
                                        ring_all_reduce, make_ring_collective)
from repro.parallel.compat import shard_map

mesh = jax.make_mesh((8,), ("r",))
out = {}
rng = np.random.default_rng(0)
data = rng.standard_normal((8, 4, 32)).astype(np.float32)
x = jax.device_put(jnp.asarray(data), NamedSharding(mesh, P("r")))
for fn in (ring_broadcast, pbt_broadcast):
    for nc in (1, 4, 16):
        body = partial(fn, axis_name="r", num_chunks=nc, axis_size=8)
        out[f"{fn.__name__}_{nc}"] = np.asarray(jax.jit(shard_map(
            body, mesh=mesh, in_specs=P("r"), out_specs=P("r")))(x))
rng = np.random.default_rng(0)
x = rng.standard_normal((16, 4)).astype(np.float32)
xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("r")))
xr = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P()))
out["ring_all_gather"] = np.asarray(make_ring_collective(ring_all_gather, mesh, "r")(xs))
out["ring_reduce_scatter"] = np.asarray(make_ring_collective(ring_reduce_scatter, mesh, "r")(xr))
out["ring_all_reduce"] = np.asarray(make_ring_collective(ring_all_reduce, mesh, "r")(xr))
vs = jax.device_put(jnp.asarray(rng.standard_normal((64, 3)).astype(np.float32)),
                    NamedSharding(mesh, P("r")))
out["ring_all_reduce_sharded"] = np.asarray(jax.jit(shard_map(
    lambda v: ring_all_reduce(v, "r", 8), mesh=mesh, in_specs=P("r"), out_specs=P("r"),
    check_vma=False))(vs))
np.savez(sys.argv[1], **out)
print("REFERENCE_OK")
"""


@pytest.fixture(scope="module")
def port_outputs(tmp_path_factory) -> list[dict]:
    """Each rank's outputs of the port's collectives (one gloo world)."""
    out = tmp_path_factory.mktemp("torch_collectives")
    proc = subprocess.run([sys.executable, str(TESTS / "_torch_collectives_worker.py"), str(out)],
                          env=conftest.multidevice_subprocess_env(), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    ranks = []
    for i in range(WORLD):
        with np.load(out / f"rank{i}.npz") as f:
            ranks.append(dict(f))
    return ranks


@pytest.fixture(scope="module")
def reference_outputs(tmp_path_factory) -> dict:
    """The reference's shard_map bodies on 8 forced host devices."""
    if conftest._forced_device_count() < WORLD:
        pytest.skip(f"{conftest.MULTIDEVICE_XLA_FLAGS} does not give 8 devices here")
    path = tmp_path_factory.mktemp("jax_collectives") / "ref.npz"
    proc = subprocess.run([sys.executable, "-c", _REFERENCE, str(path)],
                          env=conftest.multidevice_subprocess_env(), capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(path) as f:
        return dict(f)


def _sharded(ranks, key):
    """The ranks' outputs of ``key`` as one array sharded over ranks."""
    return np.concatenate([r[key] for r in ranks])


def _assert_bit_exact(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("fn", ["ring_broadcast", "pbt_broadcast"])
@pytest.mark.parametrize("num_chunks", [1, 4, 16])
def test_broadcast_matches_reference_shard_map_body(port_outputs, reference_outputs, fn,
                                                    num_chunks):
    key = f"{fn}_{num_chunks}"
    want = reference_outputs[key]
    _assert_bit_exact(_sharded(port_outputs, key), want)
    assert all(np.array_equal(want[i], want[0]) for i in range(WORLD))


def test_replicate_matches_the_pbt_body_it_wraps(port_outputs, reference_outputs):
    _assert_bit_exact(_sharded(port_outputs, "replicate"), reference_outputs["pbt_broadcast_4"])


@pytest.mark.parametrize("key", ["ring_all_gather", "ring_all_reduce"])
def test_replicated_ring_collective_matches_reference(port_outputs, reference_outputs, key):
    for rank in port_outputs:
        _assert_bit_exact(rank[key], reference_outputs[key])


@pytest.mark.parametrize("key", ["ring_reduce_scatter", "ring_all_reduce_sharded"])
def test_sharded_ring_collective_matches_reference(port_outputs, reference_outputs, key):
    _assert_bit_exact(_sharded(port_outputs, key), reference_outputs[key])


def test_collectives_in_a_subgroup_address_global_ranks(port_outputs):
    members = [1, 3, 6, 7]
    small = np.arange(12, dtype=np.float32).reshape(4, 3)
    want_sum = sum(small * (r + 1) for r in members)     # small integers: exact in any order
    for rank, outputs in enumerate(port_outputs):
        if rank not in members:
            assert "group_pbt_broadcast" not in outputs
            continue
        np.testing.assert_array_equal(outputs["group_pbt_broadcast"], small * (members[0] + 1))
        np.testing.assert_array_equal(outputs["group_ring_all_reduce"], want_sum)


# -- the host-side planner, copied line for line --------------------------------------------


@pytest.mark.parametrize("strategy", ["RING", "PBT"])
def test_broadcast_plan_and_chunk_count_match_reference(strategy):
    pt_s, jx_s = ReplStrategy[strategy], JxStrategy[strategy]
    for k in (1, 2, 3, 5, 8, 13):
        for chunks in (1, 4, 16):
            pt = pt_replication.BroadcastPlan(pt_s, k, chunks)
            jx = jx_replication.BroadcastPlan(jx_s, k, chunks)
            assert (pt.arity, pt.depth, pt.num_rounds) == (jx.arity, jx.depth, jx.num_rounds)
            assert [pt.children(r) for r in range(k)] == [jx.children(r) for r in range(k)]
            assert pt.logg_p_latency(4096, 12.5e9, 1e-6, 5e-7) == jx.logg_p_latency(
                4096, 12.5e9, 1e-6, 5e-7)
        for size in (0, 1, 4096, 1 << 20, 1 << 30):
            assert pt_replication.optimal_chunk_count(size, k, pt_s, 12.5e9, 1e-6) == \
                jx_replication.optimal_chunk_count(size, k, jx_s, 12.5e9, 1e-6)
