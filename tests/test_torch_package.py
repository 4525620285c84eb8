"""Hygiene guards of the PyTorch port (``src/repro_torch``).

(a) no module of the port, and not ``chip_smoke.py``, imports ``jax`` or
    ``repro``; (b) importing the port leaves both out of ``sys.modules``;
(c) every module the port copies verbatim still equals its ``repro``
    source once ``repro.`` reads ``repro_torch.``, so drift shows;
(d) without a GPU, the entry points raise unless asked for the CPU, and
    never quietly compute there; the CPU path never builds a kernel.
"""

import ast
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
]

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
    from repro_torch.kernels import gf256_encode, ref, xor_reduce

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran")

    for module, name in [(gf256_encode, "gf_matmul_bytes_batched_plain"),
                         (gf256_encode, "gf_scale_bytes_plain"),
                         (xor_reduce, "xor_reduce_bytes_batched_plain"),
                         (ref, "gf_matmul_batched_ref")]:
        monkeypatch.setattr(module, name, refuse)


def test_entry_points_without_gpu_raise_unless_asked_for_cpu(no_gpu, plain_forbidden):
    from repro_torch.checkpoint.storage import StorageCluster
    from repro_torch.core.erasure import RSCode, stream_encode
    from repro_torch.kernels import ops

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


def test_numpy_backend_stays_selectable_without_gpu(no_gpu):
    from repro_torch.core.erasure import RSCode

    data = np.arange(3 * 64, dtype=np.uint8).reshape(1, 3, 64)
    code = RSCode(3, 2)
    parity = code.encode_stripes(data, backend="numpy")
    assert np.array_equal(parity, code.encode_stripes(data, device="cpu"))


def test_cpu_path_never_builds_a_kernel(monkeypatch):
    from repro_torch.core.erasure import RSCode, stream_encode
    from repro_torch.kernels import _build, ops

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
