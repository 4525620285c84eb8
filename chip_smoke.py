#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port: the erasure-coded data plane and
the attention layer.

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py

It needs ``nvcc`` (on PATH or under ``CUDA_HOME``, default
``/usr/local/cuda``) and builds every kernel from ``src/repro_torch/kernels/csrc``.
The storage geometry is Apache Hadoop's default HDFS erasure-coding policy
RS-6-3-1024k (6 data + 3 parity cells of 1 MiB; ``hdfs ec -listPolicies``);
the attention widths are those of yi-9b (arXiv:2403.04652),
deepseek-v2-lite (arXiv:2405.04434) and whisper-base (arXiv:2212.04356) in
``src/repro/configs/registry.py``.

1. Prints the card's name and power limit, builds the four kernel sources
   (one ``nvcc`` per source, all at once) and prints each build time; for
   the flash library, ptxas's registers and spills per tensor-core
   instantiation and its HGMMA (wgmma) instructions from ``cuobjdump
   -sass``, failing if a bf16 tensor-core instantiation has none; for the
   GF kernels, ptxas's registers and spills, and the PRMT, LOP3 and LDS
   instructions of each instantiation of the GF(2^8) matmul and the stream
   scaling, failing if a scaling instantiation has no PRMT or still reads
   bytes from shared memory (LDS.U8); for the XOR fold's instantiations,
   ptxas's registers and spills and their global loads, failing if the
   wide path has no 16-byte load (LDG.E.128).  The scaling and XOR
   kernels must not spill.
2. Holds every kernel against its plain PyTorch version on the card.
   Data plane, bit-exact (integer work, tolerance 0): RS(6,3) encode of
   256 stripes of 1 MiB cells, their decode after losing cells (0, 1, 2),
   the TriEC stream scaling and XOR aggregation of one 6 x 16 MiB stripe,
   the S = 1 launches, and the GF(2) bit-matrix product of that stripe
   (bits (48, 16 Mi)); plus ragged, unaligned operands, identity and
   all-zero coefficients, and an all-zero bit-matrix.  Flash attention
   at the widths above, within one bf16 ulp plus 1e-3 of a row's RMS, and
   within 5e-4 relative RMS error (fp32: rtol = atol = 3e-4, the
   reference's own; see SAME_ARITHMETIC); at whisper's and prefill_32k's
   shapes, planted faults (the mask of keys past S dropped, one KV tile
   skipped) must fail that tolerance.  Each
   kernel's median time over CUDA-event-timed runs, its bound, its plain
   version's time and, where one PyTorch call computes the same function,
   that call's time (``library_ms``; the port never calls it).  A
   data-plane kernel is timed with one launch between two events (``ms``,
   the wrapper's host time shows in a short kernel) and with ten queued
   (``ms_queued``), beside a device-to-device copy's rate (the practical
   rate of a byte-bound kernel; the port never calls it).
3. The data-plane main path, with every launch counter set to 0 first:
   the entry points (``RSCode`` encode/decode, batched and single-stripe,
   ``stream_encode`` and the parity-node ``xor_reduce_bytes``) against
   the numpy backend, then a 10-node ``StorageCluster`` on the card that
   writes 17 objects with ``write_object_bulk``, loses 3 nodes holding
   data cells of object 0 and reads everything back verified.
4. The attention main path, with every launch counter set to 0 again:
   ``ops.rs_encode_mxu`` against ``ops.rs_encode``; one yi-9b GQA layer and
   one deepseek-v2-lite MLA layer at full width from seeded params, whose
   q/k/v go through ``ops.flash_attention`` and are held against the
   kernel's plain version and against ``blockwise_attention`` (which
   rounds elsewhere; see OTHER_ROUNDING); decode of the last position
   against the layer's last row.
5. The checkpoint path, with every launch counter set to 0 again: the
   training state of one yi-9b GQA layer at full width (bf16 weights from
   seeded params, two fp32 AdamW-moment stand-ins of the same shapes, an
   int64 step: 0.38 GB) saved by ``CheckpointManager`` under RS-6-3-1024k
   (6 MiB stripe objects, client-side encode) into a 10-node cluster on the
   card; restored bitwise after 3 nodes holding data cells fail, and
   refused after a fourth; then ``ops.bulk_verify`` on the card over 2^16
   capabilities against the host MAC, with 3 tags corrupted.
6. Prints ``{"kernels": [...]}`` (launches on each main path, error,
   times, bound) and, last, ``{"ok": true, "device": {...}}``.

Float32 matrix products run in full fp32 (TF32 off).  Any failed check
raises, so the script exits non-zero without the last line.  It exits
non-zero at once when no CUDA device is available.
"""

from __future__ import annotations

import contextlib
import json
import math
import re
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
QUEUED = 10                 # launches between two events for ms_queued
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
# H100 SXM peak for the inputs' type: bf16 dense on the tensor cores; fp32
# outside them (an exact fp32 product has no faster unit)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# Each check asks |got - want| <= rtol |want| + row_atol rms(want's row) + atol
# everywhere (a row is the last axis: one head of one position), and
# ||got - want|| <= rel_rms ||want|| overall.
# The kernel against its plain version: the same roundings, since the plain
# version walks the kernel's KV tiles, so in bf16 the two outputs differ by
# at most one ulp (2^-7 of the value) where their fp32 sums round apart; the
# row term is slack of 1e-3 of a row's RMS.  fp32: the reference's own
# tolerance (tests/test_kernels.py).
SAME_ARITHMETIC = {
    "bfloat16": {"rtol": 2 ** -7, "row_atol": 1e-3, "atol": 0.0, "rel_rms": 5e-4},
    "float32": {"rtol": 3e-4, "row_atol": 0.0, "atol": 3e-4, "rel_rms": 1e-5},
}
# Two routes through bf16 that round at other places: blockwise_attention
# rounds q * scale to bf16 (2^-9 of each element) and p against a 512-key
# running max, decode rounds the normalized weights; each moves a row by a
# few 1e-3 of its RMS.
OTHER_ROUNDING = {"rtol": 2 ** -7, "row_atol": 5e-2, "atol": 0.0, "rel_rms": 1e-2}
# flash-attention cases in which faults are planted, to show the tolerance
# rejects them: whisper's ragged S (1500 keys, 92 past the last full 128-key
# tile) and prefill_32k's long rows, where one tile is 128 of up to 32768 keys
PLANTED_FAULT_CASES = ("whisper-base encoder", "yi-9b prefill_32k")
# flash attention at supported models' widths (src/repro/configs/registry.py):
# (case, B, S, H, Hkv, D, Dv, dtype, causal, kernel runs, plain runs).  The
# first is the attention main path's shape (phase 4).
FLASH_CASES = [
    ("yi-9b train_4k", 8, 4096, 32, 4, 128, 128, "bfloat16", True, 20, 3),
    ("yi-9b prefill_32k", 1, 32768, 32, 4, 128, 128, "bfloat16", True, 3, 3),
    ("deepseek-v2-lite MLA", 2, 4096, 16, 16, 192, 128, "bfloat16", True, 20, 3),
    ("whisper-base encoder", 8, 1500, 8, 8, 64, 64, "bfloat16", False, 20, 3),
    ("yi-9b fp32", 1, 4096, 32, 4, 128, 128, "float32", True, 10, 3),
]
RAGGED = (1, 31, 33, 100, 1000, 4108, 1_000_003)   # 4108 % 16 == 12
MXU_RAGGED = (1, 127, 1000)
YI = dict(d_model=4096, n_heads=32, n_kv_heads=4, head_dim=128)          # arXiv:2403.04652
YI_BATCH, ATTN_SEQ = 8, 4096
DSV2 = dict(d_model=2048, n_heads=16, kv_lora=512, qk_nope=128, qk_rope=64,
            v_head=128)                                                 # arXiv:2405.04434
DSV2_BATCH = 2
CLUSTER_NODES = 10
CLUSTER_OBJECTS = 16
CLUSTER_OBJECT_BYTES = 6 << 20
ODD_OBJECT_BYTES = 3_141_593
CKPT_NODE_CAPACITY = 1 << 27
CKPT_STRIPE_BYTES = K * CELL    # one RS-6-3-1024k stripe per object
CKPT_STEP = 1000
CAPABILITIES = 1 << 16
CORRUPTED_TAGS = (5, 4097, 60001)


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


def median_ms(fn, runs: int, per_event: int = 1) -> float:
    """Median over ``runs`` CUDA-event pairs, after one warm-up, of the time
    per call of ``fn``, with ``per_event`` calls back to back between the
    two events of a pair."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_event):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_event)
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
        "ms_queued": median_ms(lambda: kernel(*args), KERNEL_RUNS, QUEUED),
        "plain_ms": median_ms(lambda: plain(*args), PLAIN_RUNS),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        # no single PyTorch call computes a GF(2^8) matmul or a bitwise XOR fold
        "library_ms": None,
        "shape": shape,
        "bytes": nbytes,
    }
    print(f"  {name} {shape}: {row['ms']:.4f} ms ({QUEUED} queued: {row['ms_queued']:.4f} ms a "
          f"launch; plain {row['plain_ms']:.3f} ms, bound {row['bound_ms']:.4f} ms), max |err| "
          f"{err}", flush=True)
    return row


def ptxas_usage(source: str) -> dict[str, list[str]]:
    """ptxas's registers and spills for each kernel of ``csrc/<source>.cu``,
    from the build log of this run (``-Xptxas=-v``)."""
    from repro_torch.kernels import _build

    usage, current = {}, None
    for line in _build.LOGS.get(source, "").splitlines():
        if "Compiling entry function" in line:
            current = line.split("'")[1]
        elif current and ("registers" in line or "spill" in line):
            usage.setdefault(current, []).append(line.split(":", 1)[-1].strip())
    return usage


def sass_ops(source: str) -> dict[str, list[list[str]]]:
    """The instructions of each function of the built ``csrc/<source>.cu``
    in program order (``cuobjdump -sass``), each as its mnemonic and
    operands, predicate dropped: ``["LOP3.LUT", "R4,", "R4,", "R8,", "RZ,",
    "0x96,", "!PT"]``."""
    from repro_torch.kernels import _build

    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(_build.library_path(source))],
                          capture_output=True, text=True, check=True).stdout
    instruction = re.compile(r"^\s*/\*[0-9a-f]+\*/\s*(.*)$")
    ops, current = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            current = line.split("Function :", 1)[1].strip()
            ops[current] = []
            continue
        found = instruction.match(line.split(";")[0])
        if current and found:
            tokens = [t for t in found.group(1).split() if not t.startswith("@")]
            if tokens:
                ops[current].append(tokens)
    return ops


def is_op(mnemonic: str, opcode: str) -> bool:
    """``mnemonic`` is ``opcode`` or one of its forms (``LDS`` matches
    ``LDS.U8``, ``LDG.E.128`` matches ``LDG.E.128.CONSTANT``)."""
    return mnemonic == opcode or mnemonic.startswith(opcode + ".")


def sass_counts(source: str, opcodes: tuple[str, ...]) -> dict[str, dict[str, int]]:
    """The instructions of each opcode (and its forms) in each function of
    the built ``csrc/<source>.cu``: static counts, not runs."""
    return {name: {op: sum(is_op(ins[0], op) for ins in ops) for op in opcodes}
            for name, ops in sass_ops(source).items()}


def spills(lines: list[str]) -> int:
    """Bytes of spill stores in ptxas's lines for one kernel."""
    return sum(int(n) for line in lines for n in re.findall(r"(\d+) bytes spill stores", line))


def inspect_flash_build() -> dict:
    """What the compiler made of the flash library: ptxas's registers and
    spills for each tensor-core instantiation, and the HGMMA (wgmma)
    instructions in each one's SASS.  Fails if a tensor-core instantiation
    has none: its products would not run on the tensor cores."""
    from repro_torch.kernels.flash_attention import SUPPORTED_D, SUPPORTED_DV

    usage = ptxas_usage("flash_attention")
    hgmma = {name: c["HGMMA"] for name, c in sass_counts("flash_attention", ("HGMMA",)).items()}
    tc = {name: n for name, n in hgmma.items() if "flash_fwd_tc" in name}
    pairs = len(SUPPORTED_D) * len(SUPPORTED_DV)
    check(len(tc) == pairs, f"expected {pairs} tensor-core instantiations in the flash "
          f"library, found {sorted(tc)}")
    check(all(n > 0 for n in tc.values()), f"a tensor-core flash body has no HGMMA: {tc}")
    simt = {name: n for name, n in hgmma.items() if "flash_fwd_kernel" in name}
    print(f"  flash library: HGMMA per tensor-core instantiation {sorted(set(tc.values()))} "
          f"({sum(tc.values())} in {len(tc)}), in the fp32 SIMT body {sum(simt.values())}",
          flush=True)
    for name, lines in usage.items():
        if "flash_fwd_tc" in name:
            print(f"    ptxas {name[-60:]}: {'; '.join(lines)}", flush=True)
    return {"hgmma": tc, "hgmma_simt": simt,
            "ptxas": {name: lines for name, lines in usage.items() if "flash" in name}}


def inspect_gf_build() -> dict:
    """What the compiler made of the data-plane kernels: ptxas's registers
    and spills for each instantiation of ``gf_matmul_kernel`` (tile heights
    1-8, wide and byte paths), ``gf_scale_kernel`` (wide and byte paths),
    ``xor_reduce_kernel`` (the same) and ``gf_mxu_kernel``; the PRMT, LOP3
    and LDS instructions (LDS.U8: byte reads from shared memory) in each
    matmul and scaling instantiation (the bit-field lookups, their XORs and
    the table reads); the global loads of each XOR instantiation and the
    16-byte loads issued from the first of them to the first XOR (a LOP3
    of truth table 0x96 or 0x3c): the loads of one column in flight
    together.  Fails if an instantiation
    is missing, if a matmul or scaling one has no PRMT, if a scaling one
    reads bytes from shared memory, if the XOR fold's wide path has no
    16-byte load, or if a scaling or XOR kernel spills."""
    ptxas = {name: lines for source in ("gf256_encode", "gf_mxu", "xor_reduce")
             for name, lines in ptxas_usage(source).items()}

    def ptxas_of(name):
        return "; ".join(ptxas.get(name, ["not built in this run"]))

    counts, scale = {}, {}
    for name, c in sass_counts("gf256_encode", ("PRMT", "LOP3", "LDS", "LDS.U8")).items():
        found = re.search(r"gf_matmul_kernelILi(\d+)ELb([01])E", name)
        if found:
            counts[(int(found.group(1)), found.group(2) == "1")] = (name, c)
        found = re.search(r"gf_scale_kernelILb([01])E", name)
        if found:
            scale[found.group(1) == "1"] = (name, c)
    want = [(rows, wide) for rows in range(1, 9) for wide in (False, True)]
    check(sorted(counts) == want, f"expected gf_matmul_kernel<1..8, byte/wide>, found "
          f"{sorted(counts)}")
    check(all(c["PRMT"] > 0 for _, c in counts.values()), f"an instantiation has no PRMT: {counts}")
    check(sorted(scale) == [False, True], f"expected gf_scale_kernel<byte/wide>, found "
          f"{sorted(scale)}")
    check(all(c["PRMT"] > 0 and c["LDS.U8"] == 0 for _, c in scale.values()),
          f"a gf_scale_kernel instantiation has no PRMT or reads bytes from shared memory: "
          f"{scale}")
    for (rows, wide), (name, c) in sorted(counts.items()):
        print(f"  gf_matmul_kernel<{rows}, {'wide' if wide else 'bytes'}>: PRMT {c['PRMT']}, "
              f"LOP3 {c['LOP3']}, LDS {c['LDS']}; ptxas {ptxas_of(name)}", flush=True)
    for wide, (name, c) in sorted(scale.items()):
        print(f"  gf_scale_kernel<{'wide' if wide else 'bytes'}>: PRMT {c['PRMT']}, LOP3 "
              f"{c['LOP3']}, LDS {c['LDS']} (LDS.U8 {c['LDS.U8']}); ptxas {ptxas_of(name)}",
              flush=True)

    fold = {}
    for name, ops in sass_ops("xor_reduce").items():
        found = re.search(r"xor_reduce_kernelILb([01])E", name)
        if not found:
            continue
        mnemonics = [ins[0] for ins in ops]
        first_load = next((i for i, m in enumerate(mnemonics) if is_op(m, "LDG")), 0)
        first_xor = next((i for i, ins in enumerate(ops) if i > first_load
                          and is_op(ins[0], "LOP3") and {"0x96,", "0x3c,"} & set(ins)),
                         len(ops))
        fold[found.group(1) == "1"] = (name, {
            "LDG.E.128": sum(is_op(m, "LDG.E.128") for m in mnemonics),
            "LDG": sum(is_op(m, "LDG") for m in mnemonics),
            "LDG.E.128 before the first XOR": sum(is_op(m, "LDG.E.128")
                                                  for m in mnemonics[first_load:first_xor]),
            "LOP3": sum(is_op(m, "LOP3") for m in mnemonics)})
    check(sorted(fold) == [False, True], f"expected xor_reduce_kernel<byte/wide>, found "
          f"{sorted(fold)}")
    check(fold[True][1]["LDG.E.128"] > 0, f"the XOR fold's wide path has no LDG.E.128: {fold}")
    for wide, (name, c) in sorted(fold.items()):
        print(f"  xor_reduce_kernel<{'wide' if wide else 'bytes'}>: {c}; ptxas {ptxas_of(name)}",
              flush=True)
    spilled = {name: spills(lines) for name, lines in ptxas.items()
               if ("gf_scale_kernel" in name or "xor_reduce_kernel" in name) and spills(lines)}
    check(not spilled, f"the scaling or XOR kernel spills: {spilled}")
    for name, lines in ptxas.items():
        if "gf_mxu_kernel" in name:
            print(f"  gf_mxu_kernel: ptxas {'; '.join(lines)}", flush=True)
    return {"sass": {**{f"gf_matmul_kernel<{r}, {'wide' if w else 'bytes'}>": c
                        for (r, w), (_, c) in sorted(counts.items())},
                     **{f"gf_scale_kernel<{'wide' if w else 'bytes'}>": c
                        for w, (_, c) in sorted(scale.items())},
                     **{f"xor_reduce_kernel<{'wide' if w else 'bytes'}>": c
                        for w, (_, c) in sorted(fold.items())}},
            "ptxas": {name: lines for name, lines in ptxas.items()
                      if "flash" not in name}}


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

    # the matmul's bit-field tables, made once per matrix as the ops layer does
    # (the plain version ignores them)
    tables = {id(c): ge.field_tables(c) for c in (parity, inv)}

    def matmul(c, x):
        return ge.gf_matmul_bytes_batched(c, x, tables[id(c)])

    data = torch.randint(0, 256, (STRIPES, K, CELL), dtype=torch.uint8, device=dev,
                         generator=gen)
    rows["gf_matmul_bytes_batched"] = measure(
        "gf_matmul_bytes_batched", src_ge, "src/repro/kernels/gf256_encode.py:124",
        matmul, ge.gf_matmul_bytes_batched_plain, (parity, data),
        STRIPES * (K + M) * CELL, f"encode ({M},{K}) x ({STRIPES},{K},{CELL})")
    enc = matmul(parity, data)
    cells = torch.cat([data, enc], dim=1)[:, survivors]    # (S, k, L) surviving cells
    del enc
    dec = measure(
        "gf_matmul_bytes_batched[decode]", src_ge, "src/repro/kernels/gf256_encode.py:124",
        matmul, ge.gf_matmul_bytes_batched_plain, (inv, cells),
        STRIPES * (K + K) * CELL, f"decode lost {LOST}: ({K},{K}) x ({STRIPES},{K},{CELL})",
        extra_check=lambda out: check(torch.equal(out, data), "decode did not recover data"))
    dec["counter"] = "gf_matmul_bytes_batched"
    rows[dec["name"]] = dec
    del data, cells

    stripe = torch.randint(0, 256, (K, STREAM), dtype=torch.uint8, device=dev, generator=gen)
    want_parity = ge.gf_matmul_bytes_batched_plain(parity, stripe[None])[0]
    rows["gf_scale_bytes"] = measure(
        "gf_scale_bytes", src_ge, "src/repro/kernels/gf256_encode.py:184",
        lambda c, x: ge.gf_scale_bytes(c, x, tables[id(c)]), ge.gf_scale_bytes_plain,
        (parity, stripe), K * STREAM + M * K * STREAM, f"scale ({M},{K}) x ({K},{STREAM})")
    streams = ge.gf_scale_bytes(parity, stripe, tables[id(parity)])   # (m, k, L)
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
        lambda c, x: ge.gf_matmul_bytes(c, x, tables[id(c)]),
        lambda c, x: ge.gf_matmul_bytes_batched_plain(c, x[None])[0],
        (parity, stripe), (K + M) * STREAM, f"encode ({M},{K}) x ({K},{STREAM})",
        extra_check=lambda out: check(torch.equal(out, want_parity), "S=1 encode differs"))
    del stripe, streams, want_parity

    # ragged lengths and unaligned, non-contiguous operands (the byte and
    # 4-byte paths), and coefficient matrices the matmul skips (zeros) or
    # XORs (ones) through, and the stream scaling stores as zeros or copies
    eye = torch.eye(K, dtype=torch.uint8, device=dev)
    zeros = torch.zeros((M, K), dtype=torch.uint8, device=dev)
    ragged = {}
    for length in RAGGED:
        base = torch.randint(0, 256, (3, K + 1, length + 3), dtype=torch.uint8, device=dev,
                             generator=gen)
        x = base[:, 1:, 3:]
        pairs = [
            (ge.gf_matmul_bytes_batched(parity, x), ge.gf_matmul_bytes_batched_plain(parity, x)),
            (ge.gf_matmul_bytes_batched(inv, x), ge.gf_matmul_bytes_batched_plain(inv, x)),
            (ge.gf_matmul_bytes_batched(eye, x), x),
            (ge.gf_matmul_bytes_batched(zeros, x), torch.zeros_like(x[:, :M])),
            (ge.gf_matmul_bytes(parity, x[1]), ge.gf_matmul_bytes_batched_plain(parity, x[1:2])[0]),
            (ge.gf_scale_bytes(parity, x[2]), ge.gf_scale_bytes_plain(parity, x[2])),
            (ge.gf_scale_bytes(eye, x[2]), ge.gf_scale_bytes_plain(eye, x[2])),
            (ge.gf_scale_bytes(zeros, x[2]), torch.zeros((M, K, length), dtype=torch.uint8,
                                                         device=dev)),
            (xr.xor_reduce_bytes_batched(x), xr.xor_reduce_bytes_batched_plain(x)),
            (xr.xor_reduce_bytes(x[0]), xr.xor_reduce_bytes_batched_plain(x[:1])[0]),
        ]
        for i, (got, want) in enumerate(pairs):
            check(torch.equal(got, want), f"ragged L={length}: operand set {i} differs")
        ragged[length] = "bit-exact"
    print(f"  ragged / unaligned lengths {sorted(ragged)}, identity and zero coefficients: "
          "bit-exact", flush=True)
    return list(rows.values()), ragged


def copy_rate(dev) -> dict:
    """The card's practical rate for a byte-bound kernel: a device-to-device
    ``copy_`` of the TriEC streams' bytes (m * k * 16 MiB read, as many
    written), ten queued between two events.  A yardstick for the data-plane
    kernels' ``ms`` beside their bound; the port never calls it."""
    import torch

    src = torch.empty(M * K * STREAM, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    ms = median_ms(lambda: dst.copy_(src), KERNEL_RUNS, QUEUED)
    moved = 2 * src.numel()
    res = {"bytes": moved, "ms": ms, "tb_per_s": moved / ms / 1e9,
           "share_of_peak": moved / ms / 1e9 / (HBM_BYTES_PER_S / 1e12)}
    print(f"  device copy of {src.numel()} B: {ms:.4f} ms a copy ({QUEUED} queued), "
          f"{res['tb_per_s']:.3f} TB/s moved, {res['share_of_peak']:.3f} of 3.35 TB/s", flush=True)
    del src, dst
    return res


def closeness(got, want, tol: dict) -> tuple[float, float, float]:
    """(largest |got - want|, largest share of its allowance that any element
    uses, ||got - want|| / ||want||) under ``tol`` (see SAME_ARITHMETIC)."""
    import torch

    got, want = got.float(), want.float()
    diff = (got - want).abs()
    row_rms = want.square().mean(dim=-1, keepdim=True).sqrt()
    allowed = tol["rtol"] * want.abs() + tol["row_atol"] * row_rms + tol["atol"]
    share = torch.where(diff == 0, 0.0, diff / allowed).max()
    return float(diff.max()), float(share), float(diff.norm() / want.norm())


def assert_close(got, want, tol: dict, what: str) -> dict:
    """Check that ``got`` is finite and within ``tol`` of ``want``; return the
    largest |got - want|, the largest share of its allowance any element
    used and the relative RMS error."""
    import torch

    check(got.shape == want.shape, f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    check(bool(torch.isfinite(got.float()).all()), f"{what}: non-finite values")
    err, share, rel = closeness(got, want, tol)
    check(share <= 1.0 and rel <= tol["rel_rms"],
          f"{what}: differs beyond {tol} (max |err| {err}, {share:.3g} of the allowance, "
          f"relative RMS error {rel:.3g})")
    return {"max_abs_err": err, "tolerance_share": share, "rel_rms_err": rel}


def planted_faults(q, k, v, causal: bool, got, tol: dict) -> dict:
    """What a kernel with a planted fault would return, computed by the plain
    arithmetic, held against the kernel's output ``got``: each must fail the
    tolerance the kernel passed.  Returns each fault's closeness."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    s = q.shape[1]
    tile = fa.kv_tile(q.dtype)
    faults = {}
    if not causal and s % tile:
        # the kv >= S mask dropped: the last tile's zero-filled keys score 0
        pad = torch.zeros_like(k[:, :tile - s % tile])
        padv = torch.zeros_like(v[:, :pad.shape[1]])
        faults["mask of keys >= S dropped"] = fa.flash_attention_fwd_plain(
            q, torch.cat([k, pad], 1), torch.cat([v, padv], 1), False)
    if causal:
        def skip(skipped: int, first_row: int):
            """q rows from first_row on skip KV tile ``skipped``."""
            lo, hi = skipped * tile, (skipped + 1) * tile
            k2, v2 = torch.cat([k[:, :lo], k[:, hi:]], 1), torch.cat([v[:, :lo], v[:, hi:]], 1)
            rest = fa.flash_attention_fwd_plain(q[:, first_row:], k2, v2, True,
                                                q_offset=first_row - tile)
            return torch.cat([got[:, :first_row], rest], 1)

        mid = s // 2 // tile
        faults["last q tile skips KV tile 0"] = skip(0, s - tile)
        faults[f"q tiles past {mid} skip KV tile {mid}"] = skip(mid, (mid + 1) * tile)
    out = {}
    for name, wrong in faults.items():
        err, share, rel = closeness(wrong, got, tol)
        check(share > 1.0 or rel > tol["rel_rms"], f"planted fault passed: {name}")
        out[name] = {"max_abs_err": err, "tolerance_share": share, "rel_rms_err": rel}
    return out


def flash_case(dev, gen, case) -> dict:
    """One flash-attention shape: kernel against plain version, then times."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    name, b, s, h, hkv, d, dv, dtype, causal, runs, plain_runs = case
    dt = getattr(torch, dtype)

    def draw(shape):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    q, k, v = draw((b, s, h, d)), draw((b, s, hkv, d)), draw((b, s, hkv, dv))
    got = fa.flash_attention_fwd(q, k, v, causal)
    tol = SAME_ARITHMETIC[dtype]
    close = assert_close(got, fa.flash_attention_fwd_plain(q, k, v, causal), tol,
                         f"flash_attention_fwd {name}")
    faults = planted_faults(q, k, v, causal, got, tol) if name in PLANTED_FAULT_CASES else {}
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    flops = 2 * pairs * (d + dv)
    nbytes = q.element_size() * b * s * (h * d + hkv * (d + dv) + h * dv)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
    res = {
        "case": name, "shape": f"q {(b, s, h, d)} k {(b, s, hkv, d)} v {(b, s, hkv, dv)}",
        "dtype": dtype, "causal": causal, **close, "tolerance": tol,
        "ms": median_ms(lambda: fa.flash_attention_fwd(q, k, v, causal), runs),
        "plain_ms": median_ms(lambda: fa.flash_attention_fwd_plain(q, k, v, causal), plain_runs),
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "flops": flops, "bytes": nbytes,
    }
    res["tflops"] = flops / res["ms"] / 1e9
    if dtype == "bfloat16":
        res["smem_per_block"] = fa.tc_smem_bytes(d, dv)
    if faults:
        res["planted_faults"] = faults
    # the yardstick: one PyTorch call computing the same function on (B,H,S,D)
    # views.  Only its refusal of a shape is caught, and reported; the port
    # never calls it.
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=True)

    try:
        lib_out = library()
    except RuntimeError as exc:
        res["library_ms"] = None
        res["library_note"] = f"scaled_dot_product_attention refused: {str(exc)[:160]}"
    else:
        res["library_max_abs_err"] = float((lib_out.transpose(1, 2).float() - got.float())
                                           .abs().max())
        del lib_out
        res["library_ms"] = median_ms(library, runs)
    del got
    torch.cuda.empty_cache()
    lib = "refused" if res["library_ms"] is None else f"{res['library_ms']:.3f} ms"
    print(f"  flash_attention_fwd {name} {dtype} {'causal' if causal else 'full'} "
          f"{res['shape']}: {res['ms']:.3f} ms = {res['tflops']:.1f} TFLOP/s (plain "
          f"{res['plain_ms']:.3f} ms, bound "
          f"{res['bound_ms']:.3f} ms by {res['bound_by']}, library {lib}), max |err| "
          f"{close['max_abs_err']:.3g} ({close['tolerance_share']:.3g} of the allowance), "
          f"relative RMS error {close['rel_rms_err']:.3g}", flush=True)
    for fault, c in faults.items():
        print(f"    planted fault '{fault}': rejected, {c['tolerance_share']:.3g} of the "
              f"allowance, relative RMS error {c['rel_rms_err']:.3g}", flush=True)
    return res


def check_attention_kernels(dev) -> list[dict]:
    """Phase 2, second slice: flash attention and the GF(2) bit-matrix
    product against their plain versions."""
    import torch

    from repro_torch.kernels import gf256_encode as ge
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 3)
    cases = [flash_case(dev, gen, case) for case in FLASH_CASES]
    main = cases[0]
    flash = {
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:82", "launches": None,
        **{key: main[key] for key in ("max_abs_err", "tolerance", "tolerance_share",
                                      "rel_rms_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                      "library_ms", "shape")},
        "cases": cases,
    }

    bigmat = ops.rs_block_bitmatrix(K, M, "cauchy", dev)
    masks = ge.row_masks(bigmat)          # made once per matrix, as the ops layer does
    bits = torch.randint(0, 2, (8 * K, STREAM), dtype=torch.int8, device=dev, generator=gen)
    mxu = measure(
        "gf_matmul_mxu", "src/repro_torch/kernels/csrc/gf_mxu.cu",
        "src/repro/kernels/gf256_encode.py:240",
        lambda a, b: ge.gf_matmul_mxu(a, b, masks), ge.gf_matmul_mxu_plain,
        (bigmat, bits), 8 * K * STREAM + 8 * M * STREAM + bigmat.numel(),
        f"({8 * M},{8 * K}) x ({8 * K},{STREAM}) bits")
    want = ge.gf_matmul_mxu(bigmat, bits, masks)
    # the yardstick, on the same tensors: cuBLASLt takes int8 products only in
    # some layouts, so the transposed views are tried when the direct form is
    # refused.  Only a refusal is caught, and reported.
    forms = {
        "torch._int_mm(bigmat, bits) & 1": lambda: torch._int_mm(bigmat, bits) & 1,
        "torch._int_mm(bits.T, bigmat.T).T & 1":
            lambda: torch._int_mm(bits.t(), bigmat.t()).t() & 1,
    }
    notes = []
    for form, library in forms.items():
        try:
            lib_out = library()
        except RuntimeError as exc:
            notes.append(f"{form} refused: {str(exc)[:120]}")
            continue
        mxu["library_form"] = form
        mxu["library_matches"] = bool(torch.equal(lib_out.to(torch.int8), want))
        del lib_out
        mxu["library_ms"] = median_ms(library, KERNEL_RUNS)
        print(f"  gf_matmul_mxu library ({form}): {mxu['library_ms']:.4f} ms, "
              f"equal to the kernel: {mxu['library_matches']}", flush=True)
        break
    if notes:
        mxu["library_note"] = "; ".join(notes)
        print(f"  gf_matmul_mxu library: {mxu['library_note']}", flush=True)
    del bits, want
    for n in MXU_RAGGED:
        bits = torch.randint(0, 2, (8 * K, n), dtype=torch.int8, device=dev, generator=gen)
        check(torch.equal(ge.gf_matmul_mxu(bigmat, bits), ge.gf_matmul_mxu_plain(bigmat, bits)),
              f"gf_matmul_mxu ragged n={n} differs")
        check(not bool(ge.gf_matmul_mxu(torch.zeros_like(bigmat), bits).any()),
              f"gf_matmul_mxu of a zero bit-matrix is not zero (n={n})")
    print(f"  gf_matmul_mxu ragged n {list(MXU_RAGGED)} and a zero bit-matrix: bit-exact",
          flush=True)
    torch.cuda.empty_cache()
    return [flash, mxu]


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


def drive_attention_path(dev) -> dict:
    """Phase 4: the bit-matrix RS encode, then one yi-9b GQA layer and one
    deepseek-v2-lite MLA layer at full width, their q/k/v through
    ``ops.flash_attention`` against ``blockwise_attention``, and decode of
    the last position against the layer's last row."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_fwd_plain
    from repro_torch.models.attention import (
        blockwise_attention, gqa_apply, gqa_decode, gqa_init, mla_apply, mla_decode, mla_init)
    from repro_torch.models.layers import apply_rope, dense_apply

    tol, same = OTHER_ROUNDING, SAME_ARITHMETIC["bfloat16"]
    bf16 = torch.bfloat16
    errors = {}
    stripe = np.random.default_rng(SEED + 2).integers(0, 256, (K, CELL), dtype=np.uint8)
    check(torch.equal(ops.rs_encode_mxu(stripe, K, M, device=dev),
                      ops.rs_encode(stripe, K, M, device=dev)),
          "rs_encode_mxu differs from rs_encode")

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    b, s = YI_BATCH, ATTN_SEQ
    d_model, h, hkv, hd = YI["d_model"], YI["n_heads"], YI["n_kv_heads"], YI["head_dim"]
    p = gqa_init(gen, d_model, h, hkv, hd)
    x = torch.randn((b, s, d_model), generator=gen, device=dev).to(bf16)
    out = gqa_apply(p, x, h, hkv, hd)
    pos = torch.arange(s, device=dev)[None, :]
    q = apply_rope(dense_apply(p["wq"], x).reshape(b, s, h, hd), pos)
    k = apply_rope(dense_apply(p["wk"], x).reshape(b, s, hkv, hd), pos)
    v = dense_apply(p["wv"], x).reshape(b, s, hkv, hd)
    flash = ops.flash_attention(q, k, v, causal=True, device=dev)
    errors["gqa_flash_vs_plain"] = assert_close(
        flash, flash_attention_fwd_plain(q, k, v, True), same, "yi-9b flash vs plain")
    errors["gqa_flash_vs_blockwise"] = assert_close(
        flash, blockwise_attention(q, k, v, True, 512, 0), tol, "yi-9b flash vs blockwise")
    errors["gqa_layer_with_flash_vs_apply"] = assert_close(
        dense_apply(p["wo"], flash.reshape(b, s, h * hd)), out, tol, "yi-9b layer via flash")
    cache_k = torch.zeros((b, s, hkv, hd), dtype=bf16, device=dev)
    cache_v = torch.zeros_like(cache_k)
    cache_k[:, :s - 1] = k[:, :s - 1]
    cache_v[:, :s - 1] = v[:, :s - 1]
    dec, _, _ = gqa_decode(p, x[:, s - 1:], cache_k, cache_v, s - 1, h, hkv, hd)
    errors["gqa_decode_vs_apply"] = assert_close(dec[:, 0], out[:, -1], tol,
                                                 "yi-9b decode vs last row")
    del p, x, out, q, k, v, flash, cache_k, cache_v
    torch.cuda.empty_cache()

    b = DSV2_BATCH
    d_model, h, lora = DSV2["d_model"], DSV2["n_heads"], DSV2["kv_lora"]
    nope, rope, vh = DSV2["qk_nope"], DSV2["qk_rope"], DSV2["v_head"]
    p = mla_init(gen, d_model, h, lora, nope, rope, vh)
    x = torch.randn((b, s, d_model), generator=gen, device=dev).to(bf16)
    out = mla_apply(p, x, h, lora, nope, rope, vh)
    q = dense_apply(p["wq"], x).reshape(b, s, h, nope + rope)
    q = torch.cat([q[..., :nope], apply_rope(q[..., nope:], pos)], dim=-1)
    dkv = dense_apply(p["w_dkv"], x)
    c_kv, k_rope = dkv[..., :lora], apply_rope(dkv[..., None, lora:], pos)[..., 0, :]
    k = torch.cat([dense_apply(p["w_uk"], c_kv).reshape(b, s, h, nope),
                   k_rope[:, :, None, :].expand(b, s, h, rope)], dim=-1)
    v = dense_apply(p["w_uv"], c_kv).reshape(b, s, h, vh)
    flash = ops.flash_attention(q, k, v, causal=True, device=dev)
    errors["mla_flash_vs_plain"] = assert_close(
        flash, flash_attention_fwd_plain(q, k, v, True), same, "deepseek-v2-lite flash vs plain")
    errors["mla_flash_vs_blockwise"] = assert_close(
        flash, blockwise_attention(q, k, v, True, 512, 0), tol,
        "deepseek-v2-lite flash vs blockwise")
    errors["mla_layer_with_flash_vs_apply"] = assert_close(
        dense_apply(p["wo"], flash.reshape(b, s, h * vh)), out, tol,
        "deepseek-v2-lite layer via flash")
    cache_c = torch.zeros((b, s, lora), dtype=bf16, device=dev)
    cache_kr = torch.zeros((b, s, rope), dtype=bf16, device=dev)
    cache_c[:, :s - 1] = c_kv[:, :s - 1]
    cache_kr[:, :s - 1] = k_rope[:, :s - 1]
    dec, _, _ = mla_decode(p, x[:, s - 1:], cache_c, cache_kr, s - 1, h, lora, nope, rope, vh)
    errors["mla_decode_vs_apply"] = assert_close(dec[:, 0], out[:, -1], tol,
                                                 "deepseek-v2-lite decode vs last row")
    print("  attention path: rs_encode_mxu == rs_encode; flash against its plain version at "
          f"{same}, against blockwise attention, the layer and decode at {tol}:", flush=True)
    for what, close in errors.items():
        print(f"    {what}: max |err| {close['max_abs_err']:.3g}, {close['tolerance_share']:.3g} "
              f"of the allowance, relative RMS error {close['rel_rms_err']:.3g}", flush=True)
    return errors


def yi_layer_state(dev) -> dict:
    """The training state of one yi-9b attention layer at full width: the
    seeded params' weights in bf16, two fp32 stand-ins for AdamW's moments
    of the same shapes, and the step."""
    import torch

    from repro_torch.models.attention import gqa_init

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 4)
    params = {name: {"w": p["w"].to(torch.bfloat16)} for name, p in gqa_init(
        gen, YI["d_model"], YI["n_heads"], YI["n_kv_heads"], YI["head_dim"]).items()}

    def moment():
        return {name: 1e-3 * torch.randn(p["w"].shape, generator=gen, device=dev)
                for name, p in params.items()}

    nu = {name: x.square() for name, x in moment().items()}
    return {"params": params, "opt": {"mu": moment(), "nu": nu},
            "step": torch.tensor(CKPT_STEP, dtype=torch.int64, device=dev)}


def drive_checkpoint(dev, counters) -> dict:
    """Phase 5: save the layer state, restore it after 3 node failures,
    refuse it after 4, and verify capabilities in bulk on the card."""
    import torch

    from repro_torch.checkpoint import CheckpointManager, CheckpointPolicy, StorageCluster
    from repro_torch.checkpoint.manager import flatten, path_str
    from repro_torch.core.auth import CAP_WORDS, sponge_mac
    from repro_torch.kernels import ops

    state = yi_layer_state(dev)
    leaves = {path_str(p): x for p, x in flatten(state)}
    nbytes = sum(x.numel() * x.element_size() for x in leaves.values())
    cluster = StorageCluster(num_nodes=CLUSTER_NODES, node_capacity=CKPT_NODE_CAPACITY,
                             device=dev)
    mgr = CheckpointManager(cluster, CheckpointPolicy(k=K, m=M, stripe_bytes=CKPT_STRIPE_BYTES,
                                                      encode="client"))
    matmul = counters["gf_matmul_bytes_batched"]

    before = matmul.launches
    t0 = time.perf_counter()
    with ec_wall_time({"ec_s": 0.0}) as save_ec:
        mgr.save(CKPT_STEP, state, blocking=True)
    save_s = time.perf_counter() - t0
    save_launches = matmul.launches - before
    check(save_launches > 0, "save launched no encode kernel")
    manifest = mgr._manifests[CKPT_STEP]
    check([leaf["path"] for leaf in manifest["leaves"]] == sorted(leaves),
          f"manifest leaves {[leaf['path'] for leaf in manifest['leaves']]} != {sorted(leaves)}")
    objects = sum(len(leaf["stripes"]) for leaf in manifest["leaves"])

    first = cluster.meta.lookup(manifest["leaves"][0]["stripes"][0]["oid"])
    failed = sorted({first.data_coords[i].node for i in range(M)})
    check(len(failed) == M, f"data cells of the first object share nodes: {failed}")
    for node in failed:
        cluster.fail_node(node)
    before = matmul.launches
    t0 = time.perf_counter()
    with ec_wall_time({"ec_s": 0.0}) as restore_ec:
        got = mgr.restore(treedef=state)
    restore_s = time.perf_counter() - t0
    restore_launches = matmul.launches - before
    check(restore_launches > 0, "restore launched no decode kernel")
    restored = {path_str(p): x for p, x in flatten(got)}
    check(sorted(restored) == sorted(leaves), f"restored leaves {sorted(restored)}")
    for path, want in leaves.items():
        x = restored[path]
        check(x.device.type == "cpu" and x.dtype == want.dtype and x.shape == want.shape
              and torch.equal(x, want.cpu()), f"leaf {path} not restored bitwise")
    degraded = sum(any(cluster.meta.lookup(s["oid"]).data_coords[i].node in failed
                       for i in range(K))
                   for leaf in manifest["leaves"] for s in leaf["stripes"])

    fourth = first.data_coords[M].node
    cluster.fail_node(fourth)
    try:
        mgr.restore(treedef=state)
        refused = None
    except (IOError, ValueError) as exc:      # the expected refusal, and only it
        refused = f"{type(exc).__name__}: {str(exc)[:120]}"
    check(refused is not None, f"restore after {M + 1} failed nodes did not raise")

    rng = np.random.default_rng(SEED + 5)
    key = rng.integers(0, 1 << 32, 4, dtype=np.uint32)
    words = rng.integers(0, 1 << 32, (CAPABILITIES, CAP_WORDS), dtype=np.uint32)
    tags = sponge_mac(words, key)
    words_d, tags_d, key_d = (torch.from_numpy(a.astype(np.int64)).to(dev)
                              for a in (words, tags, key))
    got_tags = ops.bulk_verify_tags(words_d, key_d, device=dev)
    check(torch.equal(got_tags.to(torch.int64).cpu(), torch.from_numpy(tags.astype(np.int64))),
          "bulk_verify_tags differs from the host MAC")
    check(bool(ops.bulk_verify(words_d, tags_d, key_d, device=dev).all()),
          "bulk_verify rejected a valid capability")
    bad = tags.copy()
    for i, row in enumerate(CORRUPTED_TAGS):
        bad[row, i % 2] ^= np.uint32(1 << (7 * i))
    verdict = ops.bulk_verify(words_d, torch.from_numpy(bad.astype(np.int64)).to(dev), key_d,
                              device=dev).cpu()
    rejected = sorted(int(i) for i in torch.nonzero(~verdict).flatten())
    check(rejected == sorted(CORRUPTED_TAGS), f"bulk_verify rejected {rejected}, "
          f"not exactly the corrupted {sorted(CORRUPTED_TAGS)}")
    verify_ms = median_ms(lambda: ops.bulk_verify(words_d, tags_d, key_d, device=dev), 5)

    res = {"bytes": nbytes, "leaves": len(leaves), "objects": objects,
           "failed_nodes": failed, "degraded_objects": degraded,
           "save_s": save_s, "save_ec_s": save_ec["ec_s"], "save_launches": save_launches,
           "restore_s": restore_s, "restore_ec_s": restore_ec["ec_s"],
           "restore_launches": restore_launches, "fourth_failed_node": fourth,
           "refused": refused, "capabilities": CAPABILITIES,
           "rejected": rejected, "bulk_verify_ms": verify_ms}
    print(f"  checkpoint: {len(leaves)} leaves ({nbytes} B, {objects} stripe objects) saved in "
          f"{save_s:.3f} s ({save_ec['ec_s']:.3f} s in EC, {save_launches} encode launches); "
          f"nodes {failed} failed, {degraded} degraded objects; restored bitwise in "
          f"{restore_s:.3f} s ({restore_ec['ec_s']:.3f} s in EC, {restore_launches} launches); "
          f"node {fourth} failed too: refused ({refused})", flush=True)
    print(f"  checkpoint save_s {save_s:.6f} restore_s {restore_s:.6f} EC share "
          f"{save_ec['ec_s'] / save_s:.4f} / {restore_ec['ec_s'] / restore_s:.4f}", flush=True)
    print(f"  bulk_verify: {CAPABILITIES} capabilities equal to the host MAC, rows "
          f"{rejected} rejected after their tags were corrupted; {verify_ms:.3f} ms a batch",
          flush=True)
    return res


def count_launches(rows: list[dict], counters: dict, path: str) -> None:
    """Set each row's launches from its counter and fail on a kernel the
    path did not launch."""
    for row in rows:
        row["launches"] = counters[row.get("counter", row["name"])].launches
        check(row["launches"] > 0, f"{row['name']} was not launched on the {path} main path")
    print(f"  launches on the {path} main path: "
          f"{ {row['name']: row['launches'] for row in rows} }", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gf256_encode as ge
    from repro_torch.kernels import xor_reduce as xr

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    per_source = _build.build()
    print(f"phase 1: built {sorted(per_source)} in {time.perf_counter() - t0:.2f} s "
          f"({', '.join(f'{k} {v:.2f} s' for k, v in per_source.items())})", flush=True)
    flash_build = inspect_flash_build()
    gf_build = inspect_gf_build()

    print("phase 2: kernels against their plain versions", flush=True)
    dataplane_rows, _ = check_kernels(dev)
    copy = copy_rate(dev)
    torch.cuda.empty_cache()
    attention_rows = check_attention_kernels(dev)
    attention_rows[0]["hgmma"] = sum(flash_build["hgmma"].values())
    attention_rows[0]["nvcc_s"] = per_source.get("flash_attention")

    counters = {fn.__name__: fn for fn in (*ge.KERNELS, *xr.KERNELS, *fa.KERNELS)}
    print("phase 3: data-plane main path", flush=True)
    for fn in counters.values():
        fn.launches = 0
    drive_entry_points(dev)
    cluster = drive_cluster(dev, counters)
    torch.cuda.synchronize()
    count_launches(dataplane_rows, counters, "data-plane")
    torch.cuda.empty_cache()

    print("phase 4: attention main path", flush=True)
    for fn in counters.values():
        fn.launches = 0
    attention = drive_attention_path(dev)
    torch.cuda.synchronize()
    count_launches(attention_rows, counters, "attention")
    torch.cuda.empty_cache()

    print("phase 5: checkpoint path", flush=True)
    for fn in counters.values():
        fn.launches = 0
    checkpoint = drive_checkpoint(dev, counters)
    torch.cuda.synchronize()
    matmul_row = dataplane_rows[0]
    matmul_row["checkpoint_launches"] = counters[matmul_row["name"]].launches
    check(matmul_row["checkpoint_launches"] > 0,
          f"{matmul_row['name']} was not launched on the checkpoint main path")
    print(f"  launches on the checkpoint main path: "
          f"{ {matmul_row['name']: matmul_row['checkpoint_launches']} }", flush=True)

    print(json.dumps({"cluster": cluster, "attention": attention, "checkpoint": checkpoint,
                      "flash_build": flash_build, "gf_build": gf_build, "copy": copy}))
    print(card)
    print(json.dumps({"kernels": dataplane_rows + attention_rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
