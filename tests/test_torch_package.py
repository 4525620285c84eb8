"""Hygiene guards of the PyTorch port (``src/repro_torch``).

(a) no module of the port, and not ``chip_smoke.py``, imports ``jax`` or
    ``repro``; (b) importing the port leaves both out of ``sys.modules``;
(c) every module the port copies verbatim still equals its ``repro``
    source once ``repro.`` reads ``repro_torch.``, so drift shows, and the
    reference's anchor tests of the simulator and the policy presets pass
    on the copies;
(d) without a GPU, the entry points (the data plane's, ``ops.rs_encode_mxu``,
    the layers' tensor makers ``rope_freqs``,
    ``rmsnorm_init``, ``layernorm_init``, the model's ``init_params`` and
    ``init_cache``, serving through ``launch.serve``, the training data
    pipeline and ``launch.train``) raise unless asked for the CPU, and never
    quietly compute there; the CPU path never builds a
    kernel.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
PORT = SRC / "repro_torch"

#: modules the port copies from ``repro`` without change
VERBATIM = [
    "core/gf256.py",
    "core/auth.py",
    "core/packets.py",
    "core/state.py",
    "core/handlers.py",
    "membership/detector.py",
    "membership/retry.py",
    "membership/view.py",
    "policy/spec.py",
    "policy/functional.py",
    "namenode/placement.py",
    "sim/__init__.py",
    "sim/engine.py",
    "sim/network.py",
    "sim/pspin.py",
    "sim/protocols.py",
    "sim/workload.py",
    "sim/legacy.py",
    "policy/timed.py",
    "policy/flight.py",
    "control/__init__.py",
    "control/autoscaler.py",
    "control/governor.py",
    "control/sweep.py",
    "control/telemetry.py",
    "trace/__init__.py",
    "trace/attr.py",
    "trace/counters.py",
    "trace/perfetto.py",
    "trace/tracer.py",
    "verify/__init__.py",
    "verify/linearize.py",
    "namenode/namespace.py",
    "namenode/namenode.py",
    "namenode/replicator.py",
    "membership/heartbeat.py",
    "runtime/straggler.py",
    "bench.py",
    "policy/__init__.py",
    "membership/__init__.py",
    "namenode/__init__.py",
    "configs/__init__.py",
    "configs/base.py",
    "configs/registry.py",
]

#: the model stack and the serving path (ported, not copied), which the AST
#: scan must cover
MODEL_AND_SERVING = [
    "models/transformer.py",
    "models/moe.py",
    "models/mamba2.py",
    "models/xlstm.py",
    "models/model.py",
    "models/__init__.py",
    "runtime/serve_loop.py",
    "launch/__init__.py",
    "launch/serve.py",
]

#: the training runtime (ported), which the AST scan must cover too
TRAINING = [
    "optim/__init__.py",
    "optim/adamw.py",
    "optim/schedule.py",
    "optim/compression.py",
    "data/__init__.py",
    "data/pipeline.py",
    "runtime/__init__.py",
    "runtime/train_loop.py",
    "launch/steps.py",
    "launch/train.py",
]

#: the sharding plane (ported), which the AST scan must cover too
SHARDING = [
    "parallel/__init__.py",
    "parallel/sharding.py",
    "parallel/spmd.py",
    "launch/mesh.py",
    "runtime/elastic.py",
    "launch/dryrun.py",
    "launch/roofline.py",
]

#: what each package's ``__init__`` exports of the sharding plane
SHARDING_EXPORTS = {
    "repro_torch.parallel": ["AbstractMesh", "MeshAxes", "NamedSharding", "PartitionSpec",
                             "batch_dim_spec", "cache_specs", "data_batch_specs",
                             "distribute_tree", "moe_buffer_spec", "param_shardings",
                             "param_specs", "placements", "residual_spec"],
    "repro_torch.launch": ["batch_shardings", "cache_struct", "input_specs",
                           "make_debug_mesh", "make_production_mesh", "model_constraints",
                           "opt_state_struct", "params_struct", "sharded_loss_and_grads",
                           "step_shardings", "Roofline", "analyze_step",
                           "model_flops_for_cell", "run_cell"],
    "repro_torch.runtime": ["build_mesh", "grow", "reshard_state", "shrink"],
}

FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    bad = [name for name in _imported_modules(path) if name.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_ast_scan_covers_the_model_stack_and_the_serving_path():
    scanned = {path.relative_to(PORT).as_posix() for path in _port_files()[:-1]}
    assert set(MODEL_AND_SERVING) | set(TRAINING) | set(SHARDING) | {
        "configs/base.py", "configs/registry.py"} <= scanned


@pytest.mark.parametrize("path", sorted((PORT / "kernels").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_kernels_import_no_layer_above_them(path):
    """The kernels package sits under the models: a module of it that
    imported ``repro_torch.models``, even inside a function, would make
    the two a cycle."""
    tree = ast.parse(path.read_text(), filename=str(path))
    above = [f"{node.module}.{alias.name}" for node in ast.walk(tree)
             if isinstance(node, ast.ImportFrom) and node.module == "repro_torch"
             for alias in node.names]
    bad = [name for name in [*_imported_modules(path), *above]
           if name.split(".")[:2] == ["repro_torch", "models"]]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("package", sorted(SHARDING_EXPORTS))
def test_init_exports_the_sharding_plane(package):
    import importlib

    module = importlib.import_module(package)
    assert set(SHARDING_EXPORTS[package]) <= set(module.__all__)
    assert all(getattr(module, name) is not None for name in module.__all__)


def test_ast_scan_tells_repro_torch_from_repro(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import repro_torch.core\nfrom repro_torch import kernels\n"
                     "from repro.core import gf256\nimport jax.numpy as jnp\n")
    found = [n for n in _imported_modules(probe) if n.split(".")[0] in FORBIDDEN]
    assert found == ["repro.core", "jax.numpy"]


def test_importing_the_port_loads_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.core, repro_torch.kernels.ops\n"
        "import repro_torch.checkpoint.storage, repro_torch.policy\n"
        "import repro_torch.membership, repro_torch.namenode\n"
        "import repro_torch.models, repro_torch.models.attention\n"
        "import repro_torch.checkpoint, repro_torch.checkpoint.manager\n"
        "import repro_torch.parallel, repro_torch.parallel.collectives\n"
        "import repro_torch.sim, repro_torch.sim.legacy, repro_torch.policy.timed\n"
        "import repro_torch.policy.flight, repro_torch.control, repro_torch.trace\n"
        "import repro_torch.verify, repro_torch.runtime.straggler, repro_torch.bench\n"
        "import repro_torch.configs, repro_torch.models.model, repro_torch.models.moe\n"
        "import repro_torch.models.mamba2, repro_torch.models.xlstm\n"
        "import repro_torch.runtime.serve_loop, repro_torch.launch.serve\n"
        "import repro_torch.optim, repro_torch.optim.adamw, repro_torch.optim.schedule\n"
        "import repro_torch.optim.compression, repro_torch.data, repro_torch.data.pipeline\n"
        "import repro_torch.runtime, repro_torch.runtime.train_loop\n"
        "import repro_torch.launch.steps, repro_torch.launch.train\n"
        "import repro_torch.parallel.sharding, repro_torch.parallel.spmd\n"
        "import repro_torch.launch.mesh, repro_torch.runtime.elastic\n"
        "import repro_torch.launch.dryrun, repro_torch.launch.roofline\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120, env=dict(os.environ, PYTHONPATH=str(SRC)))
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("rel", VERBATIM)
def test_verbatim_copy_has_not_drifted(rel):
    want = (SRC / "repro" / rel).read_text().replace("repro.", "repro_torch.")
    assert (PORT / rel).read_text() == want


@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a GPU")


@pytest.fixture
def plain_forbidden(monkeypatch):
    """Make every plain version raise, so an entry point that quietly ran on
    the CPU instead of raising would show."""
    from repro_torch.kernels import flash_attention, gf256_encode, ref, xor_reduce
    from repro_torch.models import attention

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran")

    for module, name in [(gf256_encode, "gf_matmul_bytes_batched_plain"),
                         (gf256_encode, "gf_scale_bytes_plain"),
                         (gf256_encode, "gf_matmul_mxu_plain"),
                         (xor_reduce, "xor_reduce_bytes_batched_plain"),
                         (flash_attention, "flash_attention_fwd_plain"),
                         (attention, "blockwise_attention"),
                         (ref, "gf_matmul_batched_ref")]:
        monkeypatch.setattr(module, name, refuse)


def test_entry_points_without_gpu_raise_unless_asked_for_cpu(no_gpu, plain_forbidden):
    from repro_torch.checkpoint.storage import StorageCluster
    from repro_torch.core.erasure import RSCode, stream_encode
    from repro_torch.kernels import ops
    from repro_torch.models import layers

    data = np.zeros((2, 3, 64), np.uint8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.rs_encode_stripes(data, 3, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.rs_encode_stripes(torch.from_numpy(data), 3, 2, backend="ref")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.xor_reduce_bytes_batched(data)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RSCode(3, 2).encode_stripes(data)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stream_encode(RSCode(3, 2), data[0], 32, backend="torch")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StorageCluster(8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StorageCluster(8, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.rs_encode_mxu(data[0], 3, 2)
    for make in (layers.rope_freqs, layers.rmsnorm_init, layers.layernorm_init):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(64)
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    from repro_torch.models import init_cache, init_params

    cfg = get_arch("qwen1.5-4b").smoke
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_cache(cfg, 2, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "qwen1.5-4b", "--smoke", "--requests", "2"])
    from repro_torch.data import DataPipeline, PipelineConfig, SyntheticSource
    from repro_torch.launch import train

    with pytest.raises(RuntimeError, match="no CUDA device"):
        DataPipeline(SyntheticSource(64), PipelineConfig(batch=1, seq=4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "qwen1.5-4b", "--smoke", "--steps", "1"])


def test_bulk_verifier_without_gpu_raises_unless_asked_for_cpu(no_gpu):
    from repro_torch.core.auth import CAP_WORDS
    from repro_torch.kernels import ops

    words = np.zeros((2, CAP_WORDS), np.uint32)
    key = np.arange(4, dtype=np.uint32)
    tags = np.zeros((2, 2), np.uint32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.bulk_verify_tags(words, key)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.bulk_verify(words, tags, key)
    assert ops.bulk_verify_tags(words, key, device="cpu").shape == (2, 2)


def test_numpy_backend_stays_selectable_without_gpu(no_gpu):
    from repro_torch.core.erasure import RSCode

    data = np.arange(3 * 64, dtype=np.uint8).reshape(1, 3, 64)
    code = RSCode(3, 2)
    parity = code.encode_stripes(data, backend="numpy")
    assert np.array_equal(parity, code.encode_stripes(data, device="cpu"))


def test_cpu_path_never_builds_a_kernel(monkeypatch):
    from repro_torch.core.erasure import RSCode, stream_encode
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention

    def refuse(*args, **kwargs):
        raise AssertionError("the CPU path tried to build a CUDA kernel")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build", refuse)
    data = np.random.default_rng(0).integers(0, 256, (2, 3, 99), dtype=np.uint8)
    code = RSCode(3, 2)
    parity = code.encode_stripes(data, device="cpu")
    assert np.array_equal(parity, code.encode_stripes(data, backend="numpy"))
    assert np.array_equal(stream_encode(code, data[0], 32, backend="torch", device="cpu"),
                          parity[0])
    assert ops.xor_reduce_bytes(data[0], device="cpu").shape == (99,)
    assert np.array_equal(ops.rs_encode_mxu(data[0], 3, 2, device="cpu").numpy(), parity[0])
    qkv = [torch.from_numpy(np.random.default_rng(i).standard_normal((1, 8, 2, 64))).float()
           for i in range(3)]
    assert attention.attention(*qkv).shape == (1, 8, 2, 64)
    assert fa.flash_attention_fwd(*qkv).shape == (1, 8, 2, 64)


# -- the reference's anchor tests, on the copies ------------------------------------------

ANCHORS = json.loads((ROOT / "tests" / "data" / "policy_anchors.json").read_text())
KiB = 1024


@pytest.mark.parametrize("name", sorted(ANCHORS["latency_ns"]))
def test_copied_preset_latency_matches_anchor(name):
    """tests/test_policy.py's anchor guard, on ``repro_torch.sim``."""
    from repro_torch.policy.spec import EC_GEOMETRY_PRESETS
    from repro_torch.sim import protocols as P

    cfgd = ANCHORS["config"]
    k = cfgd["ec_k"] if name in EC_GEOMETRY_PRESETS else cfgd["k"]
    for size_s, want in ANCHORS["latency_ns"][name].items():
        got = P.run_single_shot(name, int(size_s), k=k, m=2).latency_ns
        assert got == pytest.approx(want, rel=1e-12), (name, size_s)


def _fig6_spin_overhead_small_and_large():
    """tests/test_sim.py: sPIN <= ~30% over raw for small writes; converges
    for large."""
    from repro_torch.sim import protocols as P

    r1 = P.run_raw_write(1 * KiB).latency_ns
    s1 = P.run_spin_auth_write(1 * KiB).latency_ns
    assert 1.0 < s1 / r1 < 1.35, s1 / r1
    r512 = P.run_raw_write(512 * KiB).latency_ns
    s512 = P.run_spin_auth_write(512 * KiB).latency_ns
    assert s512 / r512 < 1.05


def _fig15_ec_latency_and_bandwidth():
    """tests/test_sim.py: TriEC on sPIN against INEC, latency and bandwidth."""
    from repro_torch.sim import protocols as P
    from repro_torch.sim.network import NetConfig

    cfg = NetConfig(bandwidth_gbps=100.0)
    spin = P.run_spin_triec(512 * KiB, 3, 2, cfg=cfg).latency_ns
    inec = P.run_inec_triec(512 * KiB, 3, 2, cfg=cfg).latency_ns
    assert inec / spin > 1.8
    bw_s = P.run_spin_triec(512 * KiB, 6, 3, cfg=cfg, num_blocks=12).extra["bandwidth_GBps"]
    bw_i = P.run_inec_triec(512 * KiB, 6, 3, cfg=cfg, num_blocks=12).extra["bandwidth_GBps"]
    assert 2.0 < bw_s / bw_i < 5.5
    bw_s1 = P.run_spin_triec(1 * KiB, 6, 3, cfg=cfg, num_blocks=96).extra["bandwidth_GBps"]
    bw_i1 = P.run_inec_triec(1 * KiB, 6, 3, cfg=cfg, num_blocks=24).extra["bandwidth_GBps"]
    assert bw_s1 / bw_i1 > 15


@pytest.mark.parametrize("check", [_fig6_spin_overhead_small_and_large,
                                   _fig15_ec_latency_and_bandwidth],
                         ids=lambda f: f.__name__.strip("_"))
def test_copied_simulator_holds_the_paper_figures(check):
    check()
