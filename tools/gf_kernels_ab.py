#!/usr/bin/env python3
"""Time this tree's data-plane kernels against an earlier tree's, in turns, on one card.

    git archive <commit> | tar -x -C build/parent     # build/ is gitignored
    python3 tools/gf_kernels_ab.py --parent build/parent

The earlier tree must have the C interfaces of d806ff0: the GF(2^8) matmul
and the GF(2) product take the tables and masks their wrappers build, the
stream scaling takes coefficient bytes (this tree's takes the tables).
Builds that tree's ``gf256_encode.cu``, ``gf_mxu.cu`` and ``xor_reduce.cu``
with this tree's nvcc flags, binds both trees' C functions with ctypes
and calls them the same way (so the host's share of a launch is the same
on both sides), and times both versions at chip_smoke.py's shapes in the
order parent, change, change, parent: each a median of CUDA-event-timed
launches after a warm-up, once with one launch between two events (as
chip_smoke.py times) and once with ten queued back to back.  The outputs
of the two must be equal bit for bit.
Then the host time of one call of each data-plane wrapper, in a process
of each tree's own (the same order): a host clock over 100 calls queued
without a synchronise, median of 11 rounds.  Prints the card's name and
power limit, one line per shape and, last, one JSON object with every
time.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import inspect
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

K, M, CELL, STRIPES, STREAM = 6, 3, 1 << 20, 256, 16 << 20
LOST = (0, 1, 2)
HBM_BYTES_PER_S = 3.35e12
HOST_CALLS, HOST_ROUNDS = 100, 11
_PTR, _I64 = ctypes.c_void_p, ctypes.c_int64
#: the parent's C functions: (source, function, argtypes)
PARENT_FUNCTIONS = (
    ("gf256_encode", "gf_matmul_bytes_batched", [_PTR, _PTR, _PTR, _I64, _I64, _I64, _I64, _PTR]),
    ("gf256_encode", "gf_scale_bytes", [_PTR, _PTR, _PTR, _I64, _I64, _I64, _PTR]),
    ("gf_mxu", "gf_matmul_mxu", [_PTR, _PTR, _PTR, _I64, _I64, _I64, _PTR]),
    ("xor_reduce", "xor_reduce_bytes_batched", [_PTR, _PTR, _I64, _I64, _I64, _PTR]),
)


def build_parent(parent: Path) -> dict[str, ctypes.CDLL]:
    from repro_torch.kernels import _build

    out_dir = ROOT / "build" / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in sorted({source for source, _, _ in PARENT_FUNCTIONS}):
        target = out_dir / f"parent-{name}.so"
        src = parent / "src" / "repro_torch" / "kernels" / "csrc" / f"{name}.cu"
        procs[name] = (subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(target),
                                         str(src)], stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), target)
    libs = {}
    for name, (proc, target) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the parent's {name}.cu:\n{log}")
        libs[name] = ctypes.CDLL(str(target))
    for source, fn, argtypes in PARENT_FUNCTIONS:
        getattr(libs[source], fn).argtypes = argtypes
        getattr(libs[source], fn).restype = ctypes.c_int
    return libs


def median_ms(fn, runs: int, per_event: int = 1) -> float:
    """Median over ``runs`` CUDA-event pairs of the time per call, with
    ``per_event`` calls back to back between the two events of a pair (one,
    as chip_smoke.py times: the host's launch overhead shows in a short
    kernel's time; ten: the card's queue hides it)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_event):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_event)
    return statistics.median(times)


def host_us(tree: Path) -> dict[str, float]:
    """The host time of one call of each data-plane wrapper of ``tree``, in
    µs: a host clock over HOST_CALLS calls queued without a synchronise
    (the card runs behind), median of HOST_ROUNDS rounds.  Runs in a
    process of its own, with ``tree``'s package first on the path."""
    sys.path.insert(0, str(tree / "src"))
    import torch

    from repro_torch.core import gf256
    from repro_torch.kernels import _build
    from repro_torch.kernels import gf256_encode as ge
    from repro_torch.kernels import xor_reduce as xr

    _build.build(("gf256_encode", "xor_reduce"))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    parity = torch.from_numpy(gf256.generator_matrix(K, M)[K:].copy()).to(dev)
    tables = ge.field_tables(parity)
    stripe = torch.randint(0, 256, (K, STREAM), dtype=torch.uint8, device=dev, generator=gen)
    streams = torch.randint(0, 256, (M, K, STREAM), dtype=torch.uint8, device=dev, generator=gen)
    # the stream scaling as the ops layer calls it: with the cached tables
    # where the wrapper takes them
    takes_tables = "tables" in inspect.signature(ge.gf_scale_bytes).parameters
    calls = {
        "gf_scale_bytes": (lambda: ge.gf_scale_bytes(parity, stripe, tables)) if takes_tables
        else (lambda: ge.gf_scale_bytes(parity, stripe)),
        "xor_reduce_bytes_batched": lambda: xr.xor_reduce_bytes_batched(streams),
        "xor_reduce_bytes": lambda: xr.xor_reduce_bytes(streams[0]),
        "gf_matmul_bytes": lambda: ge.gf_matmul_bytes(parity, stripe, tables),
    }
    out = {}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        rounds = []
        for _ in range(HOST_ROUNDS):
            t0 = time.perf_counter()
            for _ in range(HOST_CALLS):
                fn()
            rounds.append((time.perf_counter() - t0) / HOST_CALLS * 1e6)
            torch.cuda.synchronize()
        out[name] = statistics.median(rounds)
    return out


def launchers(libs: dict[str, ctypes.CDLL], scale_takes_tables: bool, dev):
    """The matmul, scaling, fold and GF(2) product of one tree, each a call of
    its C function into a fresh output on the current stream."""
    import torch

    stream = torch.cuda.current_stream().cuda_stream
    lib_ge, lib_mxu, lib_xr = (libs[n] for n in ("gf256_encode", "gf_mxu", "xor_reduce"))

    def matmul(tables, data):
        s, k, length = data.shape
        out = torch.empty((s, tables.shape[0], length), dtype=torch.uint8, device=dev)
        rc = lib_ge.gf_matmul_bytes_batched(tables.data_ptr(), data.data_ptr(), out.data_ptr(),
                                            s, tables.shape[0], k, length, stream)
        assert rc == 0, rc
        return out

    def scale(coeffs, tables, data):
        (m, k), length = coeffs.shape, data.shape[1]
        out = torch.empty((m, k, length), dtype=torch.uint8, device=dev)
        first = tables if scale_takes_tables else coeffs
        rc = lib_ge.gf_scale_bytes(first.data_ptr(), data.data_ptr(), out.data_ptr(), m, k,
                                   length, stream)
        assert rc == 0, rc
        return out

    def fold(x):
        s, n, length = x.shape
        out = torch.empty((s, length), dtype=torch.uint8, device=dev)
        rc = lib_xr.xor_reduce_bytes_batched(x.data_ptr(), out.data_ptr(), s, n, length, stream)
        assert rc == 0, rc
        return out

    def mxu(masks, bigmat, bits):
        out = torch.empty((bigmat.shape[0], bits.shape[1]), dtype=torch.int8, device=dev)
        rc = lib_mxu.gf_matmul_mxu(masks.data_ptr(), bits.data_ptr(), out.data_ptr(),
                                   bigmat.shape[0], bigmat.shape[1], bits.shape[1], stream)
        assert rc == 0, rc
        return out

    return matmul, scale, fold, mxu


def device_cases(parent_libs, dev):
    """(name, parent call, change call, bytes moved) at chip_smoke.py's shapes."""
    import torch

    from repro_torch.core import gf256
    from repro_torch.kernels import gf256_encode as ge
    from repro_torch.kernels import ops
    from repro_torch.kernels import xor_reduce as xr

    old = launchers(parent_libs, False, dev)
    new = launchers({"gf256_encode": ge._lib(), "gf_mxu": ge._mxu_lib(),
                     "xor_reduce": xr._lib()}, True, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    g = gf256.generator_matrix(K, M)
    parity = torch.from_numpy(g[K:].copy()).to(dev)
    inv = torch.from_numpy(gf256.gf_mat_inv(g[[i for i in range(K + M) if i not in LOST]])).to(dev)
    t_par, t_inv = ge.field_tables(parity), ge.field_tables(inv)
    data = torch.randint(0, 256, (STRIPES, K, CELL), dtype=torch.uint8, device=dev, generator=gen)
    cells = torch.cat([data, ge.gf_matmul_bytes_batched(parity, data, t_par)], 1)[
        :, [i for i in range(K + M) if i not in LOST]]
    stripe = torch.randint(0, 256, (1, K, STREAM), dtype=torch.uint8, device=dev, generator=gen)
    streams = ge.gf_scale_bytes(parity, stripe[0], t_par)
    bigmat = ops.rs_block_bitmatrix(K, M, "cauchy", dev)
    bits = torch.randint(0, 2, (8 * K, STREAM), dtype=torch.int8, device=dev, generator=gen)
    masks = ge.row_masks(bigmat)
    operands = {
        "encode (3,6) x (256,6,1 MiB)": (0, (t_par, data), STRIPES * (K + M) * CELL),
        "decode lost (0,1,2) (6,6) x (256,6,1 MiB)": (0, (t_inv, cells), STRIPES * 2 * K * CELL),
        "S=1 encode (3,6) x (6,16 MiB)": (0, (t_par, stripe), (K + M) * STREAM),
        "mxu (24,48) x (48,16 Mi)": (3, (masks, bigmat, bits),
                                     8 * (K + M) * STREAM + bigmat.numel()),
        "scale (3,6) x (6,16 MiB)": (1, (parity, t_par, stripe[0]), (K + M * K) * STREAM),
        "fold (3,6,16 MiB)": (2, (streams,), M * (K + 1) * STREAM),
        "S=1 fold (6,16 MiB)": (2, (streams[:1],), (K + 1) * STREAM),
    }
    return [(name, functools.partial(old[i], *args), functools.partial(new[i], *args), nbytes)
            for name, (i, args, nbytes) in operands.items()]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="a checkout of the earlier tree")
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--host-of", type=Path,
                    help="print the host time of each wrapper of this tree as JSON, and exit")
    args = ap.parse_args()
    if args.host_of is not None:
        print(json.dumps(host_us(args.host_of.resolve())))
        return 0
    if args.parent is None:
        ap.error("--parent is required")
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("gf_kernels_ab: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    parent = build_parent(args.parent.resolve())
    _build.build(("gf256_encode", "gf_mxu", "xor_reduce"))
    results = {}
    for name, old, new, nbytes in device_cases(parent, torch.device("cuda")):
        if not torch.equal(old(), new()):
            raise AssertionError(f"{name}: the two trees' outputs differ")
        turns = [median_ms(fn, args.runs) for fn in (old, new, new, old)]
        queued = [median_ms(fn, args.runs, 10) for fn in (old, new, new, old)]
        results[name] = {"parent_ms": [turns[0], turns[3]], "change_ms": [turns[1], turns[2]],
                         "parent_ms_queued": [queued[0], queued[3]],
                         "change_ms_queued": [queued[1], queued[2]],
                         "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
        print(f"  {name}: parent {turns[0]:.4f} / {turns[3]:.4f} ms, change {turns[1]:.4f} / "
              f"{turns[2]:.4f} ms (10 queued a pair: parent {queued[0]:.4f} / {queued[3]:.4f}, "
              f"change {queued[1]:.4f} / {queued[2]:.4f}), bound "
              f"{results[name]['bound_ms']:.4f} ms, outputs equal", flush=True)
    torch.cuda.empty_cache()

    host = {}
    for label, tree in (("parent", args.parent), ("change", ROOT), ("change", ROOT),
                        ("parent", args.parent)):
        proc = subprocess.run([sys.executable, __file__, "--host-of", str(tree.resolve())],
                              capture_output=True, text=True, check=True)
        for fn, us in json.loads(proc.stdout.strip().splitlines()[-1]).items():
            host.setdefault(fn, {"parent_us": [], "change_us": []})[f"{label}_us"].append(us)
    for fn, times in host.items():
        print(f"  host time of one {fn} call: parent {times['parent_us'][0]:.2f} / "
              f"{times['parent_us'][1]:.2f} us, change {times['change_us'][0]:.2f} / "
              f"{times['change_us'][1]:.2f} us", flush=True)
    print(json.dumps({"card": card, "runs": args.runs, "cases": results, "host_us": host}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
