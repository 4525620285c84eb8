"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and bind them with ctypes.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C
interface, ``build/repro_torch_kernels/<name>-<digest>.so`` under the
repository root.  The digest covers the source, the shared headers and
the flags, so an edited kernel is rebuilt and an unchanged one is loaded
as it is.  Nothing is compiled until a kernel is first launched (or
:func:`build` is called), so importing the package never needs ``nvcc``.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("gf256_encode", "xor_reduce", "flash_attention", "flash_attention_bwd", "gf_mxu",
           "adamw")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",                       # registers, spills and shared memory per kernel
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: the compiler's output of each library built by this process
LOGS: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA kernels "
                           "cannot be built")
    return str(path)


def library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names: tuple[str, ...] = SOURCES) -> dict[str, float]:
    """Compile every missing library of ``names``, one ``nvcc`` each, all at
    once.  Returns the wall seconds of each compile (0.0 when it was built
    already); raises with the compiler's output when one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, target, time.perf_counter())
    seconds = {name: 0.0 for name in names}
    errors = []
    for name, (proc, tmp, target, t0) in started.items():
        output, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        LOGS[name] = output
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{output}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, target)
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def load(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu`` (built on first use), with
    ``argtypes`` set from ``signatures`` and an ``int`` CUDA error code as
    every function's return value."""
    lib = _libs.get(name)      # a loaded library is never replaced: no lock
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.cuda_error_string.argtypes = [ctypes.c_int]
            lib.cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def on_device(device: torch.device) -> contextlib.AbstractContextManager:
    """``torch.cuda.device(device)`` when ``device`` is not the current CUDA
    device, else a context that does nothing.  A kernel launches on the
    current device; entering and leaving the device costs host time on
    every launch, so it is done only where it is needed."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise on a non-zero CUDA error code returned by a launch."""
    if rc != 0:
        msg = lib.cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
