#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port's erasure-coded data plane.

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py

It needs ``nvcc`` (on PATH or under ``CUDA_HOME``, default
``/usr/local/cuda``) and builds every kernel from ``src/repro_torch/kernels/csrc``.
The geometry is Apache Hadoop's default HDFS erasure-coding policy
RS-6-3-1024k (6 data + 3 parity cells of 1 MiB; ``hdfs ec -listPolicies``).

1. Prints the card's name and power limit, builds the kernels (one
   ``nvcc`` per source, all at once) and prints the build time.
2. Holds every kernel against its plain PyTorch version on the card,
   bit-exact (integer work, tolerance 0): RS(6,3) encode of 256 stripes
   of 1 MiB cells, their decode after losing cells (0, 1, 2), the TriEC
   stream scaling and XOR aggregation of one 6 x 16 MiB stripe, and the
   S = 1 launches; plus ragged, unaligned operands.  Each kernel's median
   time over CUDA-event-timed runs, its byte bound at 3.35 TB/s and its
   plain version's time.
3. The main path, with every launch counter set to 0 first: the entry
   points (``RSCode`` encode/decode, batched and single-stripe,
   ``stream_encode`` and the parity-node ``xor_reduce_bytes``) against
   the numpy backend, then a 10-node ``StorageCluster`` on the card that
   writes 17 objects with ``write_object_bulk``, loses 3 nodes holding
   data cells of object 0 and reads everything back verified.
4. Prints ``{"kernels": [...]}`` (launches on the main path, error,
   times, bound) and, last, ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero without the last
line.  It exits non-zero at once when no CUDA device is available.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
K, M = 6, 3                 # RS-6-3-1024k
CELL = 1 << 20              # bytes per cell
STRIPES = 256               # encode/decode batch: 1.5 GiB of data cells
STREAM = 16 << 20           # bytes per chunk of the TriEC stripe
LOST = (0, 1, 2)            # cells lost before the decode
KERNEL_RUNS = 20
PLAIN_RUNS = 5
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
CLUSTER_NODES = 10
CLUSTER_OBJECTS = 16
CLUSTER_OBJECT_BYTES = 6 << 20
ODD_OBJECT_BYTES = 3_141_593


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def max_abs_err(a, b, step: int = 1 << 28) -> int:
    """Largest |a - b| over uint8 tensors, ``step`` elements at a time."""
    import torch

    check(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    a, b = a.reshape(-1), b.reshape(-1)
    err = 0
    for i in range(0, a.numel(), step):
        d = a[i:i + step].to(torch.int16) - b[i:i + step].to(torch.int16)
        err = max(err, int(d.abs().max()))
    return err


def median_ms(fn, runs: int) -> float:
    """Median of ``runs`` CUDA-event-timed calls of ``fn``, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def measure(name, source, replaces, kernel, plain, args, nbytes, shape, extra_check=None):
    """Hold ``kernel(*args)`` against ``plain(*args)`` bit-exact and time both."""
    got = kernel(*args)
    want = plain(*args)
    err = max_abs_err(got, want)
    check(err == 0, f"{name}: kernel differs from its plain version (max |err| {err})")
    if extra_check is not None:
        extra_check(got)
    del got, want
    row = {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": None,
        "max_abs_err": err,
        "tolerance": 0,
        "ms": median_ms(lambda: kernel(*args), KERNEL_RUNS),
        "plain_ms": median_ms(lambda: plain(*args), PLAIN_RUNS),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        # no single PyTorch call computes a GF(2^8) matmul or a bitwise XOR fold
        "library_ms": None,
        "shape": shape,
        "bytes": nbytes,
    }
    print(f"  {name} {shape}: {row['ms']:.4f} ms (plain {row['plain_ms']:.3f} ms, "
          f"bound {row['bound_ms']:.4f} ms), max |err| {err}", flush=True)
    return row


def check_kernels(dev) -> tuple[list[dict], dict]:
    """Phase 2: every kernel against its plain version at the main path's shapes."""
    import torch

    from repro_torch.core import gf256
    from repro_torch.kernels import gf256_encode as ge
    from repro_torch.kernels import xor_reduce as xr

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    parity = torch.from_numpy(gf256.generator_matrix(K, M)[K:].copy()).to(dev)
    survivors = [i for i in range(K + M) if i not in LOST]
    inv = gf256.gf_mat_inv(gf256.generator_matrix(K, M)[survivors])
    inv = torch.from_numpy(inv).to(dev)
    src_ge = "src/repro_torch/kernels/csrc/gf256_encode.cu"
    src_xr = "src/repro_torch/kernels/csrc/xor_reduce.cu"
    rows = {}

    data = torch.randint(0, 256, (STRIPES, K, CELL), dtype=torch.uint8, device=dev,
                         generator=gen)
    rows["gf_matmul_bytes_batched"] = measure(
        "gf_matmul_bytes_batched", src_ge, "src/repro/kernels/gf256_encode.py:124",
        ge.gf_matmul_bytes_batched, ge.gf_matmul_bytes_batched_plain, (parity, data),
        STRIPES * (K + M) * CELL, f"encode ({M},{K}) x ({STRIPES},{K},{CELL})")
    enc = ge.gf_matmul_bytes_batched(parity, data)
    cells = torch.cat([data, enc], dim=1)[:, survivors]    # (S, k, L) surviving cells
    del enc
    dec = measure(
        "gf_matmul_bytes_batched[decode]", src_ge, "src/repro/kernels/gf256_encode.py:124",
        ge.gf_matmul_bytes_batched, ge.gf_matmul_bytes_batched_plain, (inv, cells),
        STRIPES * (K + K) * CELL, f"decode lost {LOST}: ({K},{K}) x ({STRIPES},{K},{CELL})",
        extra_check=lambda out: check(torch.equal(out, data), "decode did not recover data"))
    rows["gf_matmul_bytes_batched"].update(
        {f"decode_{key}": dec[key] for key in ("ms", "plain_ms", "bound_ms", "max_abs_err")})
    del data, cells

    stripe = torch.randint(0, 256, (K, STREAM), dtype=torch.uint8, device=dev, generator=gen)
    want_parity = ge.gf_matmul_bytes_batched_plain(parity, stripe[None])[0]
    rows["gf_scale_bytes"] = measure(
        "gf_scale_bytes", src_ge, "src/repro/kernels/gf256_encode.py:184",
        ge.gf_scale_bytes, ge.gf_scale_bytes_plain, (parity, stripe),
        K * STREAM + M * K * STREAM, f"scale ({M},{K}) x ({K},{STREAM})")
    streams = ge.gf_scale_bytes(parity, stripe)             # (m, k, L)
    rows["xor_reduce_bytes_batched"] = measure(
        "xor_reduce_bytes_batched", src_xr, "src/repro/kernels/xor_reduce.py:57",
        xr.xor_reduce_bytes_batched, xr.xor_reduce_bytes_batched_plain, (streams,),
        M * (K + 1) * STREAM, f"fold ({M},{K},{STREAM})",
        extra_check=lambda out: check(torch.equal(out, want_parity),
                                      "scale + fold differs from the encode"))
    rows["xor_reduce_bytes"] = measure(
        "xor_reduce_bytes", src_xr, "src/repro/kernels/xor_reduce.py:39",
        xr.xor_reduce_bytes, lambda x: xr.xor_reduce_bytes_batched_plain(x[None])[0],
        (streams[0],), (K + 1) * STREAM, f"fold ({K},{STREAM})")
    rows["gf_matmul_bytes"] = measure(
        "gf_matmul_bytes", src_ge, "src/repro/kernels/gf256_encode.py:82",
        ge.gf_matmul_bytes, lambda c, x: ge.gf_matmul_bytes_batched_plain(c, x[None])[0],
        (parity, stripe), (K + M) * STREAM, f"encode ({M},{K}) x ({K},{STREAM})",
        extra_check=lambda out: check(torch.equal(out, want_parity), "S=1 encode differs"))
    del stripe, streams, want_parity

    # ragged lengths and unaligned, non-contiguous operands (the byte path)
    ragged = {}
    for length in (1, 31, 33, 100, 1000, 1_000_003):
        base = torch.randint(0, 256, (3, K + 1, length + 3), dtype=torch.uint8, device=dev,
                             generator=gen)
        x = base[:, 1:, 3:]
        pairs = [
            (ge.gf_matmul_bytes_batched(parity, x), ge.gf_matmul_bytes_batched_plain(parity, x)),
            (ge.gf_matmul_bytes_batched(inv, x), ge.gf_matmul_bytes_batched_plain(inv, x)),
            (ge.gf_matmul_bytes(parity, x[1]), ge.gf_matmul_bytes_batched_plain(parity, x[1:2])[0]),
            (ge.gf_scale_bytes(parity, x[2]), ge.gf_scale_bytes_plain(parity, x[2])),
            (xr.xor_reduce_bytes_batched(x), xr.xor_reduce_bytes_batched_plain(x)),
            (xr.xor_reduce_bytes(x[0]), xr.xor_reduce_bytes_batched_plain(x[:1])[0]),
        ]
        for i, (got, want) in enumerate(pairs):
            check(torch.equal(got, want), f"ragged L={length}: operand set {i} differs")
        ragged[length] = "bit-exact"
    print(f"  ragged / unaligned lengths {sorted(ragged)}: bit-exact", flush=True)
    return list(rows.values()), ragged


def drive_entry_points(dev) -> None:
    """Phase 3a: the public entry points against the numpy backend."""
    from repro_torch.core.erasure import RSCode, stream_encode
    from repro_torch.kernels import ops

    rng = np.random.default_rng(SEED)
    code = RSCode(K, M)
    batch = rng.integers(0, 256, (16, K, 64 << 10), dtype=np.uint8)
    parity = code.encode_stripes(batch, device=dev)
    check(np.array_equal(parity, code.encode_stripes(batch, backend="numpy")),
          "encode_stripes differs from the numpy backend")
    shards = [batch[:, i] for i in range(K)] + [parity[:, i] for i in range(M)]
    for slot in LOST:
        shards[slot] = None
    check(np.array_equal(code.decode_stripes(shards, device=dev), batch),
          "decode_stripes did not recover the data")

    stripe = rng.integers(0, 256, (K, 1 << 20), dtype=np.uint8)
    want = code.encode(stripe)
    check(np.array_equal(code.encode(stripe, backend="torch", device=dev), want),
          "encode(torch) differs from the numpy backend")
    cells = list(stripe) + list(want)
    for slot in LOST:
        cells[slot] = None
    check(np.array_equal(code.decode(cells, backend="torch", device=dev), stripe),
          "decode(torch) did not recover the data")
    check(np.array_equal(stream_encode(code, stripe, 2048, backend="torch", device=dev), want),
          "stream_encode(torch) differs from RSCode.encode")
    streams = ops.gf_scale_streams(code.parity_matrix, stripe, device=dev)
    for i in range(M):
        agg = ops.xor_reduce_bytes(streams[i], device=dev).cpu().numpy()
        check(np.array_equal(agg, want[i]), f"parity-node aggregation {i} differs")
    print("  entry points: encode_stripes, decode_stripes, encode, decode, stream_encode, "
          "xor_reduce_bytes agree with the numpy backend", flush=True)


@contextlib.contextmanager
def ec_wall_time(totals: dict):
    """Add the wall time spent inside ``RSCode.encode_stripes`` and
    ``decode_stripes`` (host-device copies included) to ``totals["ec_s"]``."""
    from repro_torch.core.erasure import RSCode

    originals = {name: getattr(RSCode, name) for name in ("encode_stripes", "decode_stripes")}

    def timed(fn):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                totals["ec_s"] += time.perf_counter() - t0
        return wrapper

    for name, fn in originals.items():
        setattr(RSCode, name, timed(fn))
    try:
        yield totals
    finally:
        for name, fn in originals.items():
            setattr(RSCode, name, fn)


def drive_cluster(dev, counters) -> dict:
    """Phase 3b: write -> 3-node failure -> verified degraded read, on the card."""
    from repro_torch.checkpoint.storage import StorageCluster

    rng = np.random.default_rng(SEED + 1)
    sizes = [CLUSTER_OBJECT_BYTES] * CLUSTER_OBJECTS + [ODD_OBJECT_BYTES]
    blobs = [rng.bytes(n) for n in sizes]
    cluster = StorageCluster(num_nodes=CLUSTER_NODES, device=dev)
    matmul = counters["gf_matmul_bytes_batched"]

    before = matmul.launches
    t0 = time.perf_counter()
    with ec_wall_time({"ec_s": 0.0}) as write_ec:
        layouts = cluster.write_object_bulk(blobs, k=K, m=M)
    write_s = time.perf_counter() - t0
    check(matmul.launches > before, "write_object_bulk launched no encode kernel")

    failed = sorted({layouts[0].data_coords[i].node for i in range(3)})
    check(len(failed) == 3, f"data cells of object 0 share nodes: {failed}")
    for node in failed:
        cluster.fail_node(node)
    before = matmul.launches
    t0 = time.perf_counter()
    with ec_wall_time({"ec_s": 0.0}) as read_ec:
        got = cluster.read_objects(layouts, verify=True)
    read_s = time.perf_counter() - t0
    check(matmul.launches > before, "read_objects launched no decode kernel")
    check(got == blobs, "degraded read did not return every blob")
    degraded = sum(any(c.node in failed for c in lay.data_coords) for lay in layouts)
    print(f"  cluster: {len(blobs)} objects ({sum(sizes)} B) written in {write_s:.3f} s "
          f"({write_ec['ec_s']:.3f} s in EC); nodes {failed} failed; {degraded} degraded "
          f"objects read back verified in {read_s:.3f} s ({read_ec['ec_s']:.3f} s in EC)",
          flush=True)
    return {"objects": len(blobs), "bytes": sum(sizes), "failed_nodes": failed,
            "degraded_objects": degraded, "write_s": write_s, "write_ec_s": write_ec["ec_s"],
            "read_s": read_s, "read_ec_s": read_ec["ec_s"]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels import gf256_encode as ge
    from repro_torch.kernels import xor_reduce as xr

    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    per_source = _build.build()
    print(f"phase 1: built {sorted(per_source)} in {time.perf_counter() - t0:.2f} s "
          f"({', '.join(f'{k} {v:.2f} s' for k, v in per_source.items())})", flush=True)

    print("phase 2: kernels against their plain versions", flush=True)
    rows, _ = check_kernels(dev)
    torch.cuda.empty_cache()

    counters = {fn.__name__: fn for fn in (*ge.KERNELS, *xr.KERNELS)}
    print("phase 3: main path", flush=True)
    for fn in counters.values():
        fn.launches = 0
    drive_entry_points(dev)
    cluster = drive_cluster(dev, counters)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    for row in rows:
        row["launches"] = launches[row["name"]]
        check(row["launches"] > 0, f"{row['name']} was not launched on the main path")
    print(f"  launches on the main path: {launches}", flush=True)

    print(json.dumps({"cluster": cluster}))
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
