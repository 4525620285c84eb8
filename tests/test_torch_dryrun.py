"""The port's dry-run (``repro_torch.launch.dryrun``): cells traced on a
fake world of 256 ranks and their memory a card, held against the rules
and against the reference's XLA memory analysis.

A fake world is process-global, so the dry-run runs in a subprocess (the
dry-run isolation rule), and so does the reference's compile, with 8 host
devices (``conftest.multidevice_subprocess_env``).  The smoke cells take
shapes that fit the smoke config and a (2, 4) mesh (``SMOKE_SHAPES``,
added to both packages' ``SHAPES`` in their subprocesses).
"""

import json
import subprocess
import sys
import textwrap

import pytest

import conftest

CELLS = ("train_4k", "prefill_32k", "decode_32k")
#: the smoke cells: name, kind, seq, batch
SMOKE_SHAPES = (("smoke_train", "train", 64, 8), ("smoke_prefill", "prefill", 64, 8),
                ("smoke_decode", "decode", 64, 8))

_PORT = textwrap.dedent(
    """
    import json, math, sys
    from repro_torch.configs import ARCHS, SHAPES
    from repro_torch.configs.base import ArchConfig, ShapeConfig
    from repro_torch.launch import dryrun, steps
    from repro_torch.parallel import sharding as sh

    def rules_bytes(arch, shape, mesh):
        # the rules' local shard bytes, leaf by leaf, from the specs alone
        in_sh, _ = steps.step_shardings(arch, shape, mesh)
        specs = steps.input_specs(arch, shape)
        kind = SHAPES[shape].kind if isinstance(shape, str) else shape.kind
        keys = {"train": ("params", "opt_state", "batch"), "prefill": ("params", "batch"),
                "decode": ("params", "cache", "batch")}[kind]
        sizes = sh.mesh_shape(mesh)
        total = 0
        for key, shard in zip(keys, in_sh):
            def one(leaf, sharding):
                nonlocal total
                split = 1
                for entry in sharding.spec:
                    for a in ((entry,) if isinstance(entry, str) else entry or ()):
                        split *= sizes[a]
                total += leaf.numel() * leaf.element_size() // split
            sh.spec_map(one, specs[key], shard)
        return total

    out = {"cells": {}, "smoke": {}}
    arch = ARCHS["yi-9b"]
    for name in sys.argv[1].split(","):
        row = dryrun.run_cell("yi-9b", name, save=False, verbose=False)
        mesh = dryrun.device_mesh((16, 16), ("data", "model"))
        row["rules_bytes"] = rules_bytes(arch, name, mesh)
        out["cells"][name] = row
    smoke = ArchConfig(model=ARCHS["yi-9b"].smoke, smoke=ARCHS["yi-9b"].smoke)
    for name, kind, seq, batch in json.loads(sys.argv[2]):
        SHAPES[name] = ShapeConfig(name, kind, seq, batch)
        row = dryrun.run_cell(smoke, SHAPES[name], save=False, verbose=False, mesh_shape=(2, 4))
        out["smoke"][name] = row["memory_analysis"]["argument_bytes"]
    print(json.dumps(out))
    """
)

_REFERENCE = textwrap.dedent(
    """
    import json, sys
    import jax
    from repro.configs import ARCHS, SHAPES
    from repro.configs.base import ArchConfig, ShapeConfig
    from repro.launch.steps import input_specs, make_step, step_shardings

    # Auto axes: the steps' sharding constraints need them (this JAX's
    # make_mesh defaults to Explicit)
    mesh = jax.make_mesh((2, 4), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    arch = ArchConfig(model=ARCHS["yi-9b"].smoke, smoke=ARCHS["yi-9b"].smoke)
    out = {}
    for name, kind, seq, batch in json.loads(sys.argv[1]):
        SHAPES[name] = ShapeConfig(name, kind, seq, batch)
        with mesh:
            step = make_step(arch, name, mesh)
            in_sh, out_sh = step_shardings(arch, name, mesh)
            specs = input_specs(arch, name)
            keys = {"train": ("params", "opt_state", "batch"), "prefill": ("params", "batch"),
                    "decode": ("params", "cache", "batch")}[kind]
            compiled = jax.jit(step, in_shardings=in_sh, out_shardings=out_sh).lower(
                *(specs[k] for k in keys)).compile()
        out[name] = compiled.memory_analysis().argument_size_in_bytes
    print(json.dumps(out))
    """
)


def _run(script: str, *argv: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", script, *argv],
                          env=conftest.multidevice_subprocess_env(), capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def port() -> dict:
    return _run(_PORT, ",".join(CELLS), json.dumps(SMOKE_SHAPES))


@pytest.fixture(scope="module")
def reference() -> dict:
    return _run(_REFERENCE, json.dumps(SMOKE_SHAPES))


@pytest.mark.parametrize("shape", CELLS)
def test_production_cells_complete(port, shape):
    row = port["cells"][shape]
    assert row["chips"] == 256 and row["mesh"] == "pod16x16"
    roof = row["roofline"]
    assert roof["flops_per_chip"] > 0 and roof["hbm_bytes_per_chip"] > 0
    assert roof["collective_bytes_per_chip"] > 0 and row["collective_counts"]["all-gather"] > 0
    ma = row["memory_analysis"]
    assert ma["peak_bytes"] >= ma["argument_bytes"] > 0
    assert ma["bytes_per_device"] == ma["peak_bytes"] - ma["argument_bytes"]
    # a card's share of the step: the model FLOPs over 256 cards, within
    # what eager adds (attention's products, the vocabulary's); a decode's
    # 16 model ranks each step their data rank's rows whole (the weights
    # gathered whole, as the sharded prefill gathers them)
    replicas = 16 if shape.startswith("decode") else 1
    assert 0.2 < roof["useful_flop_ratio"] * replicas <= 1.05


@pytest.mark.parametrize("shape", CELLS)
def test_argument_bytes_are_the_rules_local_shards(port, shape):
    row = port["cells"][shape]
    assert row["memory_analysis"]["argument_bytes"] == row["rules_bytes"]


def test_decode_cell_keeps_the_cache_on_its_shards(port):
    """yi-9b decode_32k: the cache (48 x 128 x 32768 x 4 x 128 bf16 for k and
    v) is 1/256 of it a card, and no collective moves a card's cache."""
    row = port["cells"]["decode_32k"]
    cache = 2 * 48 * 128 * 32768 * 4 * 128 * 2
    assert row["memory_analysis"]["argument_bytes"] > cache // 256
    coll = row["roofline"]["collectives"]
    assert coll.get("all-gather", 0) < 40 * 2**30      # the weights' gathers, 38 GiB
    assert row["roofline"]["flops_per_chip"] < 2 * 8.83e9 * 8 * 1.2


@pytest.mark.parametrize("name", [s[0] for s in SMOKE_SHAPES])
def test_argument_bytes_equal_the_reference_memory_analysis(port, reference, name):
    assert port["smoke"][name] == reference[name]
