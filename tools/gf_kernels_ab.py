#!/usr/bin/env python3
"""Time this tree's GF kernels against an earlier tree's, in turns, on one card.

    git archive <commit> | tar -x -C build/parent     # build/ is gitignored
    python3 tools/gf_kernels_ab.py --parent build/parent

Builds the earlier tree's ``gf256_encode.cu`` and ``gf_mxu.cu`` with this
tree's nvcc flags, binds their C functions with ctypes (the signatures of
their own wrappers: coefficient bytes for the matmul, the int8 bit-matrix
for the GF(2) product), and times both versions at chip_smoke.py's shapes
in the order parent, change, change, parent: each a median of CUDA-event
timed launches after a warm-up, once with one launch between two events
(as chip_smoke.py times) and once with ten queued back to back.  The
outputs of the two must be equal bit for bit.  Prints the card's name and
power limit, one line per shape and, last, one JSON object with every
time.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

K, M, CELL, STRIPES, STREAM = 6, 3, 1 << 20, 256, 16 << 20
LOST = (0, 1, 2)
HBM_BYTES_PER_S = 3.35e12


def build_parent(parent: Path) -> dict[str, ctypes.CDLL]:
    from repro_torch.kernels import _build

    out_dir = ROOT / "build" / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in ("gf256_encode", "gf_mxu"):
        target = out_dir / f"parent-{name}.so"
        src = parent / "src" / "repro_torch" / "kernels" / "csrc" / f"{name}.cu"
        procs[name] = (subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(target),
                                         str(src)], stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), target)
    libs = {}
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    for name, (proc, target) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the parent's {name}.cu:\n{log}")
        lib = ctypes.CDLL(str(target))
        fn = lib.gf_matmul_bytes_batched if name == "gf256_encode" else lib.gf_matmul_mxu
        fn.argtypes = ([ptr, ptr, ptr, i64, i64, i64, i64, ptr] if name == "gf256_encode"
                       else [ptr, ptr, ptr, i64, i64, i64, ptr])
        fn.restype = ctypes.c_int
        libs[name] = lib
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


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True, help="a checkout of the earlier tree")
    ap.add_argument("--runs", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gf_kernels_ab: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.core import gf256
    from repro_torch.kernels import _build
    from repro_torch.kernels import gf256_encode as ge
    from repro_torch.kernels import ops

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    parent = build_parent(args.parent)
    _build.build(("gf256_encode", "gf_mxu"))
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def parent_matmul(coeffs, data):
        s, k, length = data.shape
        out = torch.empty((s, coeffs.shape[0], length), dtype=torch.uint8, device=dev)
        rc = parent["gf256_encode"].gf_matmul_bytes_batched(
            coeffs.data_ptr(), data.data_ptr(), out.data_ptr(), s, coeffs.shape[0], k, length,
            stream)
        assert rc == 0, rc
        return out

    def parent_mxu(bigmat, bits):
        out = torch.empty((bigmat.shape[0], bits.shape[1]), dtype=torch.int8, device=dev)
        rc = parent["gf_mxu"].gf_matmul_mxu(bigmat.data_ptr(), bits.data_ptr(), out.data_ptr(),
                                            bigmat.shape[0], bigmat.shape[1], bits.shape[1],
                                            stream)
        assert rc == 0, rc
        return out

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    g = gf256.generator_matrix(K, M)
    parity = torch.from_numpy(g[K:].copy()).to(dev)
    inv = torch.from_numpy(gf256.gf_mat_inv(g[[i for i in range(K + M) if i not in LOST]])).to(dev)
    data = torch.randint(0, 256, (STRIPES, K, CELL), dtype=torch.uint8, device=dev, generator=gen)
    cells = torch.cat([data, parent_matmul(parity, data)], 1)[:, [i for i in range(K + M)
                                                                  if i not in LOST]]
    stripe = torch.randint(0, 256, (1, K, STREAM), dtype=torch.uint8, device=dev, generator=gen)
    bigmat = ops.rs_block_bitmatrix(K, M, "cauchy", dev)
    bits = torch.randint(0, 2, (8 * K, STREAM), dtype=torch.int8, device=dev, generator=gen)
    masks = ge.row_masks(bigmat)
    cases = {
        "encode (3,6) x (256,6,1 MiB)": (
            lambda: parent_matmul(parity, data),
            lambda t=ge.field_tables(parity): ge.gf_matmul_bytes_batched(parity, data, t),
            STRIPES * (K + M) * CELL),
        "decode lost (0,1,2) (6,6) x (256,6,1 MiB)": (
            lambda: parent_matmul(inv, cells),
            lambda t=ge.field_tables(inv): ge.gf_matmul_bytes_batched(inv, cells, t),
            STRIPES * 2 * K * CELL),
        "S=1 encode (3,6) x (6,16 MiB)": (
            lambda: parent_matmul(parity, stripe),
            lambda t=ge.field_tables(parity): ge.gf_matmul_bytes(parity, stripe[0], t)[None],
            (K + M) * STREAM),
        "mxu (24,48) x (48,16 Mi)": (
            lambda: parent_mxu(bigmat, bits),
            lambda: ge.gf_matmul_mxu(bigmat, bits, masks),
            8 * (K + M) * STREAM + bigmat.numel()),
    }
    results = {}
    for name, (old, new, nbytes) in cases.items():
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
    print(json.dumps({"card": card, "runs": args.runs, "cases": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
