#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port: the erasure-coded data plane, the
attention layer, the checkpoint plane, the model serving path, the
training runtime, the sharded steps on a device mesh, and the sharded
decode with the dry-run.

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py

It needs ``nvcc`` (on PATH or under ``CUDA_HOME``, default
``/usr/local/cuda``) and builds every kernel from ``src/repro_torch/kernels/csrc``.
The storage geometry is Apache Hadoop's default HDFS erasure-coding policy
RS-6-3-1024k (6 data + 3 parity cells of 1 MiB; ``hdfs ec -listPolicies``);
the attention widths are those of yi-9b (arXiv:2403.04652),
deepseek-v2-lite (arXiv:2405.04434), whisper-base (arXiv:2212.04356) and
zamba2-2.7b's shared block (arXiv:2411.15242) in the registry
(``src/repro_torch/configs/registry.py``, a copy of the reference's).

1. Prints the card's name and power limit, builds every kernel source
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
   skipped) must fail that tolerance.  The training pair at yi-9b's
   train_4k attention (``PAIR_CASE``, D = Dv = 128) and at
   deepseek-v2-lite's train4k MLA layer (``MLA_PAIR_CASE``, D = 192,
   Dv = 128): the forward writing lse against its
   plain version, and the backward's dq, dk and dv against the plain
   training backward under ``PAIR_GRADS``, twice bit for bit; a backward
   with P or dS rounded once to bf16 (``pair_bwd_rounded_once``) must fail
   that tolerance; the backward's kernels timed by name.  AdamW's fused
   pair (``csrc/adamw.cu``) on yi-9b's tree cut to the benchmark's
   16-layer stage (``ADAMW_DEPTH``, 3.29 B values, the leaves the train
   step hands it): the fused norm within ``ADAMW_TOL`` of float64 and the
   same bits twice; one update of the whole tree equal to the plain loop
   bit for bit at the same norm on a sample of every leaf
   (``adamw_against_plain``); the whole ``adamw_update`` timed against its
   bound (32 bytes a value) and the plain loop.  Each
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
   q/k/v go through the flash kernel (the layers' route on the card) and
   are held against the kernel's plain version and against
   ``blockwise_attention``'s plain loops (which round elsewhere; see
   OTHER_ROUNDING); decode of the last position against the layer's last
   row.
5. The checkpoint path, with every launch counter set to 0 again: the
   training state of one yi-9b GQA layer at full width (bf16 weights from
   seeded params, two fp32 AdamW-moment stand-ins of the same shapes, an
   int64 step: 0.38 GB) saved by ``CheckpointManager`` under RS-6-3-1024k
   (6 MiB stripe objects, client-side encode) into a 10-node cluster on the
   card; restored bitwise after 3 nodes holding data cells fail, and
   refused after a fourth; then ``ops.bulk_verify`` on the card over 2^16
   capabilities against the host MAC, with 3 tags corrupted.
6. The model serving path, with every launch counter set to 0 again:
   yi-9b at its published size (48 layers, 8.83 B seeded fp32 params) and
   every other registered architecture at its published widths with its
   depth cut to its smallest repeating unit (``DEPTH_CUTS``), one after the
   other.  Each runs a prefill through ``forward`` (yi-9b: B=1, S=4096; the
   others S=512, llava with its 2880 patch tokens, whisper over 1500
   frames and 448 tokens) plus the last row's bf16 logits; it must launch
   the flash kernel once per self-attention layer, and its hidden states
   and logits are held against the same prefill with ``blockwise_attention``
   in the kernel's place (``WHOLE_MODEL``; the second prefill's MoE layers
   route as the first's did, ``pinned_routing``).  yi-9b's prefill with
   layer 0's causal mask dropped must fail that tolerance.  An MoE layer's
   capacity dispatch is held against its plain version (a dense combine of
   the choices capacity keeps).  Decode steps are held against forward's
   rows (yi-9b: a 64-token prompt, B=4; the others 8 steps; whisper with
   its cross-attention cache filled from the encoder); a Mamba2 or xLSTM
   model's under ``RECURRENT_MODEL``, and again with every product in fp32
   under ``FP32_MODEL``, which a fault in decode's wiring fails.  yi-9b
   then serves 12 requests through ``ServeLoop`` over 4 slots, a quarter
   with capabilities lacking READ: every good request gets 8 tokens, every
   bad one is rejected before it takes a slot.  Prints the prefill ms, the ms
   a decode step, the steps and the tokens per second.
7. The training runtime, with every launch counter set to 0 again
   (``launch.steps.make_train_step``: ``loss_fn``'s gradients by autograd,
   remat under ``torch.utils.checkpoint``, AdamW in place).  (a) yi-9b at
   its published widths, its depth cut to 8 of 48 layers (``TRAIN_DEPTH``:
   1.91 B params, 30.5 GB of training state), B=1, S=4096, remat on: finite
   losses; step 0's loss equal, bit for bit, to the training forward's
   function under no_grad (on the card, where the kernel pair trains, the
   prefill on the flash kernel, one launch a layer; else ``loss_fn`` with
   blockwise attention's plain forward), and the two within a limit
   derived from ``WHOLE_MODEL``; the train steps launch the forward-only
   kernel never, and the pair 3 forwards and 2 backwards a layer a step
   (remat on, then off; their launches are the pair's rows'); the
   median step ms over 3 steps after a warm one, tokens/s, model FLOPs and
   their share of the bf16 peak, and the peak memory, with remat and
   without; with deterministic algorithms, the gradients with remat equal
   to those without; one AdamW update, through its fused kernel, against a
   float64 update on the host (``ADAMW_LEAVES``); and, on a 2-layer cut
   with every product in fp32, a directional derivative of the whole
   backward against a central difference of the loss
   (``DIRECTIONAL_TOL``).  (b) whisper-base whole through
   ``launch.train``'s objects (``DataPipeline``, ``Trainer``,
   ``CheckpointManager`` under RS(4,2) on an 8-node cluster): a compute
   failure and a lost storage node at step 6 restore step 4's checkpoint,
   bitwise, through the GF(2^8) kernel's decode, and replay steps 5 and 6
   with the same losses, bit for bit; every save launches the encode.  (c)
   every other architecture at its phase 6 cut, one step at B=1, S=512:
   finite, its gradients with remat equal to those without (dbrx is left
   out: ``TRAIN_LEFT_OUT``).  (d) ``launch.train.main`` with the reference's
   documented ``--smoke`` command: one restart, finite losses.
8. Training and prefill on a device mesh, with every launch counter set
   to 0 again.  (c) First, on the host's CPU, a 4-rank gloo world
   (spawned, one thread a rank) at smoke widths with every product in fp32:
   the sharded train step of yi, deepseek-v2 (expert-parallel MoE) and
   zamba2 on meshes (2, 2) and (4, 1) against the one-device step (loss,
   grad norm, every leaf of params and both moments; ``MESH_FP32``, the
   MoE family ``MESH_MOE``), every leaf left on its rule's placements; the
   prefill on (1, 4), a context-parallel split of the sequence, against
   the one-device prefill; and ``elastic.shrink`` from 4 ranks to 2 after
   a step: every value kept, bit for bit, and the next step equal to a
   2-rank step from the same state.  (a) Then a one-rank NCCL world on the
   card and a (1, 1) mesh: phase 7a's yi-9b cut (8 layers, B=1, S=4096)
   from the same params and moments, the sharded train step against the
   one-device step under deterministic algorithms, bit for bit (loss,
   grad norm, every leaf), AdamW's update of the local shards through its
   fused kernel, its ms beside the one-device step's; and the
   sharded prefill (one flash launch a layer) against the one-device
   prefill, bit for bit.  (b) The flash kernel as a 4-rank
   context-parallel prefill launches it: yi-9b's B=1 S=32768 attention
   (bf16, the tensor-core body) and a 4096-row fp32 case (the SIMT body),
   q cut in 4 row blocks, each launched against the whole K/V at its
   offset; the blocks joined equal the unsplit launch bit for bit, and
   each block its plain version with ``q_offset`` (``SAME_ARITHMETIC``).
9. Decode on a device mesh, the dry-run and the roofline, with every
   launch counter set to 0 again (the path runs none of the kernels:
   decode attends in einsum in both packages, and the dry-run traces on
   ``meta`` tensors).  (c) First two processes start, one a cell, that
   dry-run yi-9b's decode_32k and train_4k on the production (16, 16) mesh
   (``python -m repro_torch.launch.dryrun``, a fake world of 256 ranks):
   each prints its roofline line, and a failed cell fails the phase.  (a)
   While they run, a 4-rank gloo world on the host decodes every cache
   layout (yi, deepseek-v2's MLA and MoE, zamba2's Mamba2 and shared
   block, xLSTM, whisper's self and cross caches) at smoke widths, every
   product in fp32, on meshes (2, 2) and (1, 4): four steps after a
   seeded prompt, the last at ``cur_len = Smax``, each cache kept on its
   ``cache_specs`` shards; the logits of every step and every cache leaf
   within ``MESH_FP32`` of the one-device decode (deepseek-v2, which rounds
   to bf16 whatever the switch, ``MESH_DECODE_BF16``).  (b) Then a one-rank NCCL
   world on the card and a (1, 1) mesh: yi-9b whole at phase 6's decode
   (B=4 over 128 rows), ``SHARDED_DECODE_STEPS`` steps of the sharded serve
   step against the one-device step from the same params and cache, bit
   for bit (every step's logits, every cache leaf), and both ms a step;
   then, numbers only, the bf16 floor of ``tools/sharding_on_cards.py``
   part (f)'s witness (``WITNESS_*``) on one device: how far its logits
   move from the whole-batch decode when the batch is split as each of
   part (f)'s meshes splits it, and on (2, 2) also each head's scores as
   two halves of the head vector (``witness_floor``).
10. Prints each phase's seconds, ``{"kernels": [...]}`` (launches on each
   main path, error, times, bound) and, last, ``{"ok": true, "device":
   {...}}``.

Float32 matrix products run in full fp32 (TF32 off).  Any failed check
raises, so the script exits non-zero without the last line.  It exits
non-zero at once when no CUDA device is available.
"""

from __future__ import annotations

import contextlib
import json
import math
import operator
import os
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
    ("zamba2-2.7b shared block", 2, 4096, 32, 32, 160, 160, "bfloat16", True, 20, 3),
    ("yi-9b fp32", 1, 4096, 32, 4, 128, 128, "float32", True, 10, 3),
]
# the training pair at yi-9b's train_4k attention, which a yi-9b-16l train
# step runs 32 forwards and 16 backwards of: (case, B, S, H, Hkv, D, Dv)
PAIR_CASE = ("yi-9b train_4k", 1, 4096, 32, 4, 128, 128)
# and at a deepseek-v2-lite-5l train4k layer's MLA attention (B = 4 x S =
# 4096, 16 heads each with its own K and V, q and k 128 + 64 rotary dims
# wide), which a step of that cell runs 10 forwards and 5 backwards of
MLA_PAIR_CASE = ("deepseek-v2-lite train4k", 4, 4096, 16, 16, 192, 128)
# The backward kernel against its plain version, both keeping P and dS at
# fp32 precision: they differ in the order of fp32 sums, then round once to
# bf16 each.  Elementwise, one bf16 ulp plus 1e-3 of the row's RMS, and
# ``zero_atol`` only where the function is 0 in exact arithmetic
# (``pair_exact_zeros``: a query row that sees one key has dP = delta, so
# its dS is 0, and both sides' fp32 sums of dP and delta leave residues
# of about 1e-7 there, each its own).  In RMS over the other elements, the
# kernel's result is no further from the plain backward's unrounded fp32
# result than that result's own rounding to bf16 is, times ``rms_factor``
# (a sum on a bf16 tie rounds either way).  P or dS rounded once to bf16
# adds an error about as large as that rounding, ~1.4 times it in RMS:
# ``pair_bwd_rounded_once`` plants it, and the check must reject it.
PAIR_GRADS = {"rtol": 2 ** -7, "row_atol": 1e-3, "zero_atol": 1e-4, "rms_factor": 1.05}
# products of depth 1 per visible (row, key) pair, (a, b) for a D + b Dv:
# the model's S, dK and dQ (D each) and dP and dV (Dv each); the kernel's,
# with P and dS in three bf16 terms, S and dP in each of its dK/dV and dQ
# kernels and 3 each of dK, dQ and dV: 5 and 13 of depth 128 at D = Dv
PAIR_BWD_PRODUCTS = {"model": (3, 2), "with_splits": (8, 5)}
# spill stores ptxas reports for a backward kernel: none, but the 128/128
# dK/dV kernel's 44 bytes, which its code has had from the start (dK, dV,
# S^T, dP^T and the 16 rows' lse and delta take about all of a consumer
# thread's 240 registers); any other spill, or a larger one, fails phase 2
PAIR_SPILL_BYTES = {"flash_bwd_dkdv<128, 128>": 44}
#: AdamW's fused pair: checked and timed at yi-9b cut to the benchmark's
#: 16-layer stage (yi9b-train4k: 3.29 B fp32 values, 52.6 GB of params,
#: gradients and moments, too large for a second copy to compare with)
ADAMW_DEPTH = 16
#: the values of each leaf the update is checked at: its first and last
#: ``ADAMW_EDGE`` (two of the kernel's 4,096-value tiles, so its ragged end
#: and the tile walk across it) and its share of ``ADAMW_SAMPLES`` drawn
#: uniformly over the tree
ADAMW_EDGE, ADAMW_SAMPLES = 8192, 1 << 22
#: bytes a value the pair moves: the norm reads g; the update reads g, p, m
#: and v and writes p, m and v
ADAMW_BYTES_PER_VALUE = 32
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


def event_ms(fn):
    """``fn()`` and the ms between two CUDA events around it."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


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
    from repro_torch.kernels.flash_attention import HEAD_DIMS

    usage = ptxas_usage("flash_attention")
    hgmma = {name: c["HGMMA"] for name, c in sass_counts("flash_attention", ("HGMMA",)).items()}
    tc = {name: n for name, n in hgmma.items() if "flash_fwd_tc" in name}
    pairs = len(HEAD_DIMS)
    check(len(tc) == pairs, f"expected {pairs} tensor-core instantiations in the flash "
          f"library, found {sorted(tc)}")
    check(all(n > 0 for n in tc.values()), f"a tensor-core flash body has no HGMMA: {tc}")
    simt = {name: n for name, n in hgmma.items() if "flash_fwd_kernel" in name}
    print(f"  flash library: HGMMA per tensor-core instantiation {sorted(set(tc.values()))} "
          f"({sum(tc.values())} in {len(tc)}), in the fp32 SIMT body {sum(simt.values())}",
          flush=True)
    for name, lines in usage.items():
        dims = re.search(r"flash_fwd_tcILi(\d+)ELi(\d+)E", name)
        if dims:
            print(f"    flash_fwd_tc<{dims.group(1)}, {dims.group(2)}>: HGMMA "
                  f"{hgmma.get(name, 'not found')}; ptxas {'; '.join(lines)}", flush=True)
    return {"hgmma": tc, "hgmma_simt": simt,
            "ptxas": {name: lines for name, lines in usage.items() if "flash" in name}}


def inspect_pair_build() -> dict:
    """ptxas's registers and spills for each instantiation of the training
    backward's two main kernels (``flash_bwd_dkdv`` and ``flash_bwd_dq`` at
    each (D, Dv) of ``BWD_HEAD_DIMS``), from this run's build log.  Fails if
    one is missing, or spills more than ``PAIR_SPILL_BYTES`` allows it: their
    accumulators fill the 240 registers a consumer thread has, and a spill
    puts values through local memory."""
    from repro_torch.kernels.flash_attention import BWD_HEAD_DIMS

    usage = {}
    for name, lines in ptxas_usage("flash_attention_bwd").items():
        found = re.search(r"(flash_bwd_dkdv|flash_bwd_dq)ILi(\d+)ELi(\d+)E", name)
        if found:
            usage[f"{found.group(1)}<{found.group(2)}, {found.group(3)}>"] = lines
    check(len(usage) == 2 * len(BWD_HEAD_DIMS),
          f"expected the dK/dV and dQ kernels at each of {BWD_HEAD_DIMS}, found {sorted(usage)}")
    spilled = {name: lines for name, lines in usage.items()
               if spills(lines) > PAIR_SPILL_BYTES.get(name, 0)}
    check(not spilled, f"a backward kernel spills more than {PAIR_SPILL_BYTES}: {spilled}")
    for name, lines in sorted(usage.items()):
        print(f"    {name}: ptxas {'; '.join(lines)}", flush=True)
    return usage


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
            q, torch.cat([k, pad], 1), torch.cat([v, padv], 1), False)[0]
    if causal:
        def skip(skipped: int, first_row: int):
            """q rows from first_row on skip KV tile ``skipped``."""
            lo, hi = skipped * tile, (skipped + 1) * tile
            k2, v2 = torch.cat([k[:, :lo], k[:, hi:]], 1), torch.cat([v[:, :lo], v[:, hi:]], 1)
            rest = fa.flash_attention_fwd_plain(q[:, first_row:], k2, v2, True,
                                                q_offset=first_row - tile)[0]
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
    close = assert_close(got, fa.flash_attention_fwd_plain(q, k, v, causal)[0], tol,
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
        "plain_ms": median_ms(lambda: fa.flash_attention_fwd_plain(q, k, v, causal)[0],
                              plain_runs),
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


def pair_bwd_rounded_once(q, k, v, out, dout, lse, causal, q_offset, rounded: str):
    """What a backward kernel that rounded ``rounded`` ("P" or "dS") once to
    bf16 before its products would return: the plain training backward
    (``fa.flash_attention_bwd_plain``'s arithmetic, the kernels' lse
    layout) with that one rounding planted."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.flash_attention import _causal_mask, _group_q, _row_dot

    b, sq, h, d = q.shape
    hkv = k.shape[2]
    lse = lse[..., :sq].permute(0, 2, 1).reshape(b, sq, hkv, h // hkv)
    scale = 1.0 / math.sqrt(d)
    qg = _group_q(q, hkv).float() * scale
    dog = _group_q(dout, hkv).float()
    delta = _row_dot(_group_q(out, hkv).float(), dog)
    dq = torch.zeros_like(qg)
    dks, dvs = [], []
    for start in range(0, k.shape[1], fa.KV_TILE):
        kc32 = k[:, start:start + fa.KV_TILE].float()
        vc32 = v[:, start:start + fa.KV_TILE].float()
        p = torch.exp(torch.einsum("bqgrd,bkgd->bqgrk", qg, kc32) - lse[..., None])
        if causal:
            mask = _causal_mask(start, kc32.shape[1], sq, q_offset, q.device)
            p = p.masked_fill(~mask[None, :, None, None, :], 0.0)
        ds = p * (torch.einsum("bqgrd,bkgd->bqgrk", dog, vc32) - delta[..., None])
        if rounded == "P":
            p = p.bfloat16().float()
        else:
            ds = ds.bfloat16().float()
        dvs.append(torch.einsum("bqgrk,bqgrd->bkgd", p, dog))
        dq += torch.einsum("bqgrk,bkgd->bqgrd", ds, kc32) * scale
        dks.append(torch.einsum("bqgrk,bqgrd->bkgd", ds, qg))
    return (dq.reshape(b, sq, h, d).to(q.dtype), torch.cat(dks, dim=1).to(k.dtype),
            torch.cat(dvs, dim=1).to(v.dtype))


def pair_exact_zeros(sq: int, skv: int, causal: bool, q_offset: int, device) -> tuple:
    """Where dq, dk and dv are 0 in exact arithmetic, as (1, S, 1, 1) masks:
    dq on the query rows that see exactly one key (their dS is 0), dk on
    the keys that no row seeing more than one key sees, dv on the keys no
    row sees."""
    import torch

    rows = q_offset + torch.arange(sq, device=device)[:, None]
    keys = torch.arange(skv, device=device)[None, :]
    seen = keys <= rows if causal else torch.ones((sq, skv), dtype=torch.bool, device=device)
    single = seen.sum(dim=1) == 1
    return (single.reshape(1, sq, 1, 1),
            ~(seen & ~single[:, None]).any(dim=0).reshape(1, skv, 1, 1),
            ~seen.any(dim=0).reshape(1, skv, 1, 1))


def pair_closeness(got, want, want32, exact_zero, tol: dict = PAIR_GRADS) -> dict:
    """A gradient of the backward kernel, ``got`` (bf16), against its plain
    version's ``want`` (bf16) and unrounded ``want32`` under ``tol`` (see
    PAIR_GRADS), ``exact_zero`` its mask from :func:`pair_exact_zeros`: the
    largest |got - want|, the largest share of its allowance any element
    uses, the RMS distance from ``want32`` over the other elements as a
    multiple of the plain result's own rounding there, and whether both are
    within ``tol``."""
    import torch

    got, want, want32 = got.float(), want.float(), want32.float()
    zero = exact_zero.expand_as(want)
    diff = (got - want).abs()
    row_rms = want.square().mean(dim=-1, keepdim=True).sqrt()
    allowed = (tol["rtol"] * want.abs() + tol["row_atol"] * row_rms
               + torch.where(zero, tol["zero_atol"], 0.0))
    share = float(torch.where(diff == 0, 0.0, diff / allowed).max())
    off = float(torch.where(zero, 0.0, got - want32).norm())
    rounding = float(torch.where(zero, 0.0, want - want32).norm())
    ratio = off / rounding if rounding else (0.0 if off == 0 else math.inf)
    return {"max_abs_err": float(diff.max()), "tolerance_share": share, "rms_ratio": ratio,
            "ok": bool(torch.isfinite(got).all()) and share <= 1.0
            and ratio <= tol["rms_factor"]}


def check_pair_kernels(dev, case: tuple | None = None) -> list[dict]:
    """Phase 2, third slice: the training pair at ``case`` (``PAIR_CASE``
    by default; ``MLA_PAIR_CASE``), each kernel against its plain version on
    the same seeded inputs; a backward with P or dS rounded once to bf16
    must fail the backward's tolerance.  Times, bounds (operations: the
    backward's counted with its splits and as the model's 5 products), the
    backward's kernels by name, and SDPA's forward and backward on the same
    tensors as the yardstick."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    name, b, s, h, hkv, d, dv = PAIR_CASE if case is None else case
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 28)

    def draw(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    q, k, v, dout = draw(b, s, h, d), draw(b, s, hkv, d), draw(b, s, hkv, dv), draw(b, s, h, dv)
    shape = f"q {(b, s, h, d)} k {(b, s, hkv, d)} v {(b, s, hkv, dv)} bf16, causal"
    out, lse = fa.flash_attention_fwd_lse(q, k, v, True)
    check(torch.equal(out, fa.flash_attention_fwd(q, k, v, True)),
          "flash_attention_fwd_lse's out is not flash_attention_fwd's")
    want_out, want_lse = fa.flash_attention_fwd_plain(q, k, v, True)
    fwd_close = assert_close(out, want_out, SAME_ARITHMETIC["bfloat16"],
                             f"flash_attention_fwd_lse {name}")
    lse_err = float((lse - want_lse).abs().max())
    check(lse_err <= 1e-5, f"flash_attention_fwd_lse {name}: lse off by {lse_err}")

    grads = fa.flash_attention_bwd(q, k, v, out, dout, lse, True)
    again = fa.flash_attention_bwd(q, k, v, out, dout, lse, True)
    check(all(torch.equal(x, y) for x, y in zip(grads, again, strict=True)),
          f"flash_attention_bwd {name}: two calls differ")
    del again
    want = fa.flash_attention_bwd_plain(q, k, v, out, dout, lse, True)
    want32 = fa.flash_attention_bwd_plain(*(t.float() for t in (q, k, v, out, dout)), lse, True)
    zeros = pair_exact_zeros(s, s, True, 0, dev)
    grad_names = ("dq", "dk", "dv")
    close = {g: pair_closeness(*args) for g, *args
             in zip(grad_names, grads, want, want32, zeros, strict=True)}
    for g, c in close.items():
        check(c["ok"], f"flash_attention_bwd {name}: {g} differs beyond {PAIR_GRADS}: {c}")
    planted = {}
    for rounded in ("P", "dS"):
        wrong = pair_bwd_rounded_once(q, k, v, out, dout, lse, True, 0, rounded)
        planted[rounded] = {g: pair_closeness(*args) for g, *args
                            in zip(grad_names, wrong, want, want32, zeros, strict=True)}
        check(not all(c["ok"] for c in planted[rounded].values()),
              f"planted fault passed: {rounded} rounded once to bf16")
        del wrong

    pairs = b * h * s * (s + 1) // 2
    fwd_flops = 2 * pairs * (d + dv)
    bwd_flops = {key: 2 * pairs * (nd * d + ndv * dv)
                 for key, (nd, ndv) in PAIR_BWD_PRODUCTS.items()}
    elem = q.element_size()
    fwd_bytes = elem * (q.numel() + k.numel() + v.numel() + out.numel()) + 4 * lse.numel()
    # q, k, v, out, dout read, dq, dk, dv written, lse read, and each query
    # head's fp32 dK and dV share written and read back
    bwd_bytes = (elem * (2 * (q.numel() + k.numel() + v.numel()) + out.numel() + dout.numel())
                 + 4 * lse.numel() + 2 * 4 * b * s * h * (d + dv))
    peak = PEAK_FLOPS["bfloat16"]
    fwd_row = {
        "name": "flash_attention_fwd_lse", "case": name, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:82, writing lse", "launches": None,
        **fwd_close, "tolerance": SAME_ARITHMETIC["bfloat16"], "lse_max_abs_err": lse_err,
        "ms": median_ms(lambda: fa.flash_attention_fwd_lse(q, k, v, True), KERNEL_RUNS),
        "plain_ms": median_ms(lambda: fa.flash_attention_fwd_plain(q, k, v, True),
                              PLAIN_RUNS),
        "bound_ms": max(fwd_flops / peak, fwd_bytes / HBM_BYTES_PER_S) * 1e3,
        "bound_by": "operations" if fwd_flops / peak >= fwd_bytes / HBM_BYTES_PER_S else "bytes",
        "shape": shape, "flops": fwd_flops, "bytes": fwd_bytes,
    }
    bwd_row = {
        "name": "flash_attention_bwd", "case": name, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "none: the TPU kernel is forward only (src/repro/models/attention.py:150)",
        "launches": None, "max_abs_err": max(c["max_abs_err"] for c in close.values()),
        "tolerance": PAIR_GRADS, "tolerance_share": max(c["tolerance_share"]
                                                        for c in close.values()),
        "rms_ratio": max(c["rms_ratio"] for c in close.values()), "grads": close,
        "planted_faults": planted, "repeat_bitwise": True,
        "ms": median_ms(lambda: fa.flash_attention_bwd(q, k, v, out, dout, lse, True),
                        KERNEL_RUNS),
        "plain_ms": median_ms(lambda: fa.flash_attention_bwd_plain(q, k, v, out, dout, lse, True),
                              PLAIN_RUNS),
        "bound_ms": max(bwd_flops["with_splits"] / peak, bwd_bytes / HBM_BYTES_PER_S) * 1e3,
        "bound_ms_model_products": max(bwd_flops["model"] / peak,
                                       bwd_bytes / HBM_BYTES_PER_S) * 1e3,
        "bound_by": ("operations" if bwd_flops["model"] / peak >= bwd_bytes / HBM_BYTES_PER_S
                     else "bytes"),
        "shape": shape, "flops": bwd_flops, "bytes": bwd_bytes,
    }
    fwd_row["tflops"] = fwd_flops / fwd_row["ms"] / 1e9
    bwd_row["tflops"] = {key: f / bwd_row["ms"] / 1e9 for key, f in bwd_flops.items()}
    if dev.type == "cuda":
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fa.flash_attention_bwd(q, k, v, out, dout, lse, True)
            torch.cuda.synchronize()
        bwd_row["kernels_ms"] = {e.key[:60]: e.device_time_total / 1e3 / 5
                                 for e in prof.key_averages()
                                 if e.device_time_total > 0 and "flash_bwd" in e.key}

    # the yardstick: SDPA on (B,H,S,D) views, forward and backward (its
    # backward rounds P and dS to bf16 before their products, so it is held
    # against nothing; its closeness is reported).  The port never calls it.
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    try:
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
        lib_grads = torch.autograd.grad(lib_out, (qt, kt, vt), dout.transpose(1, 2),
                                        retain_graph=True)
    except RuntimeError as exc:
        for row in (fwd_row, bwd_row):
            row["library_ms"] = None
            row["library_note"] = f"scaled_dot_product_attention refused: {str(exc)[:160]}"
    else:
        bwd_row["library_closeness"] = {
            g: pair_closeness(x.transpose(1, 2), *args)
            for g, x, *args in zip(grad_names, lib_grads, want, want32, zeros, strict=True)}
        with torch.no_grad():
            fwd_row["library_ms"] = median_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), KERNEL_RUNS)
        bwd_row["library_ms"] = median_ms(lambda: torch.autograd.grad(
            lib_out, (qt, kt, vt), dout.transpose(1, 2), retain_graph=True), KERNEL_RUNS)
        del lib_out, lib_grads
    del want, want32, grads, qt, kt, vt
    torch.cuda.empty_cache()
    lib = {key: "refused" if row["library_ms"] is None else f"{row['library_ms']:.3f} ms"
           for key, row in (("fwd", fwd_row), ("bwd", bwd_row))}
    print(f"  flash_attention_fwd_lse {name} {shape}: {fwd_row['ms']:.3f} ms = "
          f"{fwd_row['tflops']:.1f} TFLOP/s (plain {fwd_row['plain_ms']:.3f} ms, bound "
          f"{fwd_row['bound_ms']:.3f} ms, library {lib['fwd']}), max |err| "
          f"{fwd_close['max_abs_err']:.3g} ({fwd_close['tolerance_share']:.3g} of the "
          f"allowance), lse max |err| {lse_err:.3g}", flush=True)
    print(f"  flash_attention_bwd {name}: {bwd_row['ms']:.3f} ms = "
          f"{bwd_row['tflops']['with_splits']:.1f} TFLOP/s with its splits, "
          f"{bwd_row['tflops']['model']:.1f} of the model's (plain {bwd_row['plain_ms']:.3f} ms, "
          f"bound {bwd_row['bound_ms']:.3f} ms with the splits, "
          f"{bwd_row['bound_ms_model_products']:.3f} ms for 5 products, library {lib['bwd']}); "
          f"kernels {bwd_row.get('kernels_ms')}; two calls bit for bit", flush=True)
    for g, c in close.items():
        print(f"    {g}: max |err| {c['max_abs_err']:.3g}, {c['tolerance_share']:.3g} of the "
              f"allowance, {c['rms_ratio']:.4f} x the plain result's own rounding in RMS",
              flush=True)
    for rounded, grads_close in planted.items():
        print(f"    planted fault '{rounded} rounded once to bf16': rejected, RMS "
              f"{ {g: round(c['rms_ratio'], 4) for g, c in grads_close.items()} } x the "
              f"rounding", flush=True)
    if "library_closeness" in bwd_row:
        ratios = {g: round(c["rms_ratio"], 4) for g, c in bwd_row["library_closeness"].items()}
        print(f"    library backward: RMS {ratios} x the rounding", flush=True)
    return [fwd_row, bwd_row]


@contextlib.contextmanager
def plain_adamw():
    """``optim.adamw.adamw_update`` on the plain versions of both of AdamW's
    kernels (``kernels.adamw``)."""
    from repro_torch.kernels import adamw as ka

    kernels = ka.sum_of_squares, ka.adamw_step
    ka.sum_of_squares, ka.adamw_step = ka.sum_of_squares_plain, ka.adamw_step_plain
    try:
        yield
    finally:
        ka.sum_of_squares, ka.adamw_step = kernels


def adamw_tree(depth: int, dev, gen) -> tuple:
    """yi-9b's param tree at its published widths cut to ``depth`` layers,
    fp32 on ``dev`` from ``gen``: (params, grads, opt), the gradients large
    enough that the clip acts, the moments as a few steps leave them."""
    import dataclasses

    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.launch import steps
    from repro_torch.models.layers import tree_map

    arch = ARCHS[TRAIN_ARCH]
    struct = steps.params_struct(
        dataclasses.replace(arch, model=dataclasses.replace(arch.model, n_layers=depth)))

    def draw(scale):
        return lambda t: torch.randn(t.shape, generator=gen, device=dev).mul_(scale)

    params, grads, m = (tree_map(draw(scale), struct) for scale in (0.02, 1e-3, 1e-4))
    v = tree_map(lambda t: draw(1e-4)(t).square_(), struct)
    return params, grads, {"m": m, "v": v,
                           "step": torch.tensor(10, dtype=torch.int32, device=dev)}


def adamw_against_plain(params, grads, opt, adam, norm, gen) -> dict:
    """One ``adamw_update`` of the whole tree at ``norm`` against the plain
    loop, with no second copy of the state: each leaf's first and last
    ``ADAMW_EDGE`` values and its share of ``ADAMW_SAMPLES`` drawn from
    ``gen`` are gathered from p, g, m and v before the update and from p, m
    and v after it, and the plain loop updates the gathered values (shaped
    (1, n) where the leaf decays, so that it decays them: the update is
    elementwise).  Returns the values checked and how many of p, m and v
    differ from the plain loop's."""
    import torch

    from repro_torch.models.layers import tree_leaves
    from repro_torch.optim.adamw import adamw_update

    leaves = tree_leaves(params)
    total = sum(p.numel() for p in leaves)
    index = []
    for p in leaves:
        edge = torch.arange(min(p.numel(), ADAMW_EDGE), device=p.device)
        drawn = torch.randint(p.numel(), (ADAMW_SAMPLES * p.numel() // total,), generator=gen,
                              device=p.device)
        index.append(torch.cat([edge, p.numel() - 1 - edge, drawn]))

    def gather(tree):
        return [t.reshape(-1)[i].reshape(1, -1) if t.ndim >= 2 else t.reshape(-1)[i]
                for t, i in zip(tree_leaves(tree), index, strict=True)]

    p, g, m, v = (gather(tree) for tree in (params, grads, opt["m"], opt["v"]))
    step = opt["step"].clone()
    adamw_update(params, grads, opt, adam, grad_norm=norm)
    got = [gather(tree) for tree in (params, opt["m"], opt["v"])]
    with plain_adamw():
        adamw_update(p, g, {"m": m, "v": v, "step": step}, adam, grad_norm=norm)
    differ = sum(int((a != b).sum()) for a, b in zip(sum(got, []), p + m + v, strict=True))
    return {"checked": sum(i.numel() for i in index), "differ": differ}


def float64_norm(leaves, chunk: int = 1 << 26) -> float:
    """The L2 norm over ``leaves`` in float64, ``chunk`` values at a time."""
    return math.sqrt(sum(float(c.double().square().sum())
                         for t in leaves for c in t.reshape(-1).split(chunk)))


def check_adamw_kernels(dev) -> list[dict]:
    """Phase 2, fourth slice: AdamW's fused pair against its plain versions
    (see the module's docstring)."""
    import torch

    from repro_torch.kernels import adamw as ka
    from repro_torch.models.layers import tree_leaves
    from repro_torch.optim.adamw import AdamWConfig, adamw_update

    adam = AdamWConfig()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 2)
    params, grads, opt = adamw_tree(ADAMW_DEPTH, dev, gen)
    leaves = tree_leaves(grads)
    total, again = ka.sum_of_squares(leaves), ka.sum_of_squares(leaves)
    exact = float64_norm(leaves)
    norm = torch.sqrt(total).to(torch.float32)
    norm_err = abs(float(norm) - exact) / exact
    check(torch.equal(total, again), "adamw: the fused sum of squares differs between two runs")
    check(norm_err <= ADAMW_TOL, f"adamw: the fused norm {float(norm)!r} is {norm_err:.3g} "
                                 f"from the float64 norm {exact!r}")
    sample = adamw_against_plain(params, grads, opt, adam, norm, gen)
    check(sample["differ"] == 0, f"adamw: the kernel's update differs from the plain loop at "
                                 f"{sample['differ']} of {sample['checked']} sampled values "
                                 "(x3: params and moments)")
    del leaves
    values = sum(p.numel() for p in tree_leaves(params))

    def update():
        adamw_update(params, grads, opt, adam)

    ms = median_ms(update, KERNEL_RUNS)
    norm_ms = median_ms(lambda: ka.sum_of_squares(tree_leaves(grads)), KERNEL_RUNS)
    with plain_adamw():
        plain_ms = median_ms(update, PLAIN_RUNS)
    nbytes = values * ADAMW_BYTES_PER_VALUE
    row = {
        "name": "adamw_update (sum_of_squares + adamw_step)", "counter": "adamw_step",
        "route": "cuda", "source": "src/repro_torch/kernels/csrc/adamw.cu",
        "replaces": "none (src/repro/optim/adamw.py:adamw_update, jnp)", "launches": None,
        "max_abs_err": 0, "tolerance": 0, "checked_values": sample["checked"],
        "norm_rel_err": norm_err,
        "ms": ms, "norm_ms": norm_ms, "plain_ms": plain_ms,
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        # no PyTorch call computes this update (torch.optim.AdamW decays first)
        "library_ms": None,
        "shape": f"yi-9b {ADAMW_DEPTH} layers: {len(tree_leaves(params))} leaves, {values} values",
        "bytes": nbytes,
    }
    print(f"  {row['name']} {row['shape']}: {ms:.3f} ms (norm {norm_ms:.3f} ms; plain "
          f"{plain_ms:.3f} ms, bound {row['bound_ms']:.3f} ms); update bit for bit at the same "
          f"norm at {sample['checked']} sampled values, norm {norm_err:.3g} from float64",
          flush=True)
    del params, grads, opt
    torch.cuda.empty_cache()
    return [row]


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
    deepseek-v2-lite MLA layer at full width, their q/k/v through the
    layers' ``attention`` against ``blockwise_attention``, and decode of
    the last position against the layer's last row."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_fwd_plain
    from repro_torch.models.attention import (
        attention, gqa_apply, gqa_decode, gqa_init, mla_apply, mla_decode, mla_init)
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
    with attention_entry(blockwise_entry(512)):     # the layer as it rounds off the card
        out = gqa_apply(p, x, h, hkv, hd)
    pos = torch.arange(s, device=dev)[None, :]
    q = apply_rope(dense_apply(p["wq"], x).reshape(b, s, h, hd), pos)
    k = apply_rope(dense_apply(p["wk"], x).reshape(b, s, hkv, hd), pos)
    v = dense_apply(p["wv"], x).reshape(b, s, hkv, hd)
    flash = attention(q, k, v)
    errors["gqa_flash_vs_plain"] = assert_close(
        flash, flash_attention_fwd_plain(q, k, v, True)[0], same, "yi-9b flash vs plain")
    errors["gqa_flash_vs_blockwise"] = assert_close(
        flash, blockwise_plain(q, k, v, True, 512, 0), tol, "yi-9b flash vs blockwise")
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
    with attention_entry(blockwise_entry(512)):
        out = mla_apply(p, x, h, lora, nope, rope, vh)
    q = dense_apply(p["wq"], x).reshape(b, s, h, nope + rope)
    q = torch.cat([q[..., :nope], apply_rope(q[..., nope:], pos)], dim=-1)
    dkv = dense_apply(p["w_dkv"], x)
    c_kv, k_rope = dkv[..., :lora], apply_rope(dkv[..., None, lora:], pos)[..., 0, :]
    k = torch.cat([dense_apply(p["w_uk"], c_kv).reshape(b, s, h, nope),
                   k_rope[:, :, None, :].expand(b, s, h, rope)], dim=-1)
    v = dense_apply(p["w_uv"], c_kv).reshape(b, s, h, vh)
    flash = attention(q, k, v)
    errors["mla_flash_vs_plain"] = assert_close(
        flash, flash_attention_fwd_plain(q, k, v, True)[0], same,
        "deepseek-v2-lite flash vs plain")
    errors["mla_flash_vs_blockwise"] = assert_close(
        flash, blockwise_plain(q, k, v, True, 512, 0), tol,
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


# -- phase 6: the model serving path ------------------------------------------------------

#: the main model, at its published size (arXiv:2403.04652: 48 layers, d_model
#: 4096, H=32, Hkv=4, D=128, d_ff 11008, vocab 64000), seeded fp32 master weights
MAIN_ARCH = "yi-9b"
#: every other registered architecture at its published widths, its depth cut
#: to its smallest repeating unit (a layer count; None keeps the whole model)
DEPTH_CUTS = {
    "deepseek-v2-lite-16b": 2,   # the dense first layer and one MoE layer
    "dbrx-132b": 1,              # 12.7 GB of expert weights
    "zamba2-2.7b": 6,            # one group: 6 Mamba2 layers and the shared block
    "llava-next-mistral-7b": 1,
    "minitron-8b": 1,
    "qwen1.5-4b": 1,
    "starcoder2-7b": 1,
    "xlstm-125m": None,
    "whisper-base": None,
}
MODEL_SEED = 7
PREFILL_BATCH, PREFILL_SEQ = 1, 4096        # yi-9b's prefill
PREFILL_RUNS = 3                            # timed prefills after the checked one
DECODE_BATCH, DECODE_PROMPT, DECODE_MAX_LEN = 4, 64, 128
CUT_SEQ, CUT_DECODE_STEPS = 512, 8          # the cut models' prefill and decode
WHISPER_FRAMES, WHISPER_TOKENS = 1500, 448  # 30 s of audio; the decoder's context
SERVE_SLOTS, SERVE_REQUESTS, SERVE_MAX_TOKENS, SERVE_MAX_LEN = 4, 12, 8, 64
SERVE_REJECT_RATE = 0.25
# A whole model's prefill with the flash kernel against the same prefill with
# blockwise_attention in the kernel's place (hidden states and last-row
# logits), and decode's logits against forward's rows: the two routes round
# at other places in every attention layer (see OTHER_ROUNDING), and the
# differences pass through the stack.  Measured on an H100 (700 W) at yi-9b's 48
# layers: 0.19 of a row's RMS and 0.022 relative RMS error (prefill), 0.15
# and 0.028 (decode); a causal mask dropped in layer 0 alone: 6.5 and 1.39.
WHOLE_MODEL = {"rtol": 2 ** -7, "row_atol": 0.3, "atol": 0.0, "rel_rms": 5e-2}
# A recurrent model's (Mamba2, xLSTM) decode against its forward, both in
# bf16: on random weights their exponential gates and decays turn one-ulp
# differences into large ones, in the reference as in the port
# (``tools/decode_witness.py``, seeds 0-4: the port on an H100 at 700 W
# reads up to 0.34 relative RMS error and about 2.0 of a row's RMS for
# xlstm-125m, 0.095 and 0.4 for zamba2's group; the reference's own decode
# against its forward, on the CPU, 0.28 and 1.9, 0.060 and 0.5).  Limits
# about twice the worst reading; a fault in decode's wiring shows in
# FP32_MODEL.
RECURRENT_MODEL = {
    "xlstm": {"rtol": 2 ** -7, "row_atol": 4.0, "atol": 0.0, "rel_rms": 0.7},
    "hybrid": {"rtol": 2 ** -7, "row_atol": 1.0, "atol": 0.0, "rel_rms": 0.2},
}
# The same decode and forward with every product in fp32 (``fp32_compute``):
# the two compute one function, so only fp32 rounding, amplified as above,
# parts them (the same readings: up to 3.0e-4 relative RMS error and 2.1e-3
# of a row's RMS, against 1e-3 and 1e-2 here).
FP32_MODEL = {"rtol": 0.0, "row_atol": 1e-2, "atol": 0.0, "rel_rms": 1e-3}


def model_configs() -> dict:
    """Phase 6's models: the main one whole, the rest cut (``DEPTH_CUTS``)."""
    import dataclasses

    from repro_torch.configs import ARCHS

    out = {MAIN_ARCH: ARCHS[MAIN_ARCH].model}
    for name, layers in DEPTH_CUTS.items():
        cfg = ARCHS[name].model
        out[name] = cfg if layers is None else dataclasses.replace(cfg, n_layers=layers)
    return out


def self_attention_layers(cfg) -> int:
    """Self-attention layers of one forward, each a kernel launch on the card."""
    if cfg.family in ("dense", "moe"):
        return cfg.n_layers
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.shared_attn_every
    if cfg.family == "encdec":
        return cfg.enc_layers + cfg.n_layers
    return 0


def model_batch(cfg, dev, rng, b: int, s: int) -> dict:
    """Seeded prefill inputs: tokens, and a frontend's stub embeddings."""
    import torch

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(
            device=dev, dtype=torch.bfloat16)

    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (b, s))).to(dev)}
    if cfg.frontend == "vision_stub":
        batch["patch_embeds"] = normal(b, cfg.frontend_tokens, cfg.d_model)
    if cfg.family == "encdec":
        batch["frames"] = normal(b, WHISPER_FRAMES, cfg.d_model)
    return batch


def unembed(params, hidden):
    """Logits of hidden states, a bf16 product as the reference's prefill step
    (``repro/launch/steps.py``) and ``decode_step`` compute them."""
    from repro_torch.models.layers import dense_apply

    return dense_apply(params["unembed"], hidden).float()


@contextlib.contextmanager
def fp32_compute():
    """The model stack with every product in fp32: the defaults through which
    it picks its compute dtype (``dense_apply``, ``embed_apply``, the loss's
    ``chunked_cross_entropy``) and its cache dtype (``init_cache``) read
    float32 inside."""
    import torch

    from repro_torch.models import layers, model

    fns = (layers.dense_apply, layers.embed_apply, layers.chunked_cross_entropy,
           model.init_cache)
    saved = [fn.__defaults__ for fn in fns]
    for fn, defaults in zip(fns, saved):
        fn.__defaults__ = tuple(torch.float32 if d is torch.bfloat16 else d for d in defaults)
    try:
        yield
    finally:
        for fn, defaults in zip(fns, saved):
            fn.__defaults__ = defaults


@contextlib.contextmanager
def attention_entry(fn):
    """``fn`` where the layers' attention route calls the flash kernel."""
    from repro_torch.kernels import flash_attention as fa

    saved = fa.flash_attention_fwd
    fa.flash_attention_fwd = fn
    try:
        yield
    finally:
        fa.flash_attention_fwd = saved


def blockwise_plain(q, k, v, causal=True, block=512, q_offset=0):
    """``blockwise_attention``'s plain forward (the online-softmax loops over
    ``block``-key blocks), which runs where the kernel pair does not: the
    yardstick the flash kernel is held against, on the card too."""
    from repro_torch.models.attention import _bw_attention_fwd_impl

    return _bw_attention_fwd_impl(q, k, v, causal, block, q_offset)[0]


def blockwise_entry(block: int, drop_causal_at: int | None = None):
    """:func:`blockwise_plain` with the flash kernel's signature; with
    ``drop_causal_at``, that call (0 = the first layer's) drops its causal
    mask: the planted fault."""
    calls = []

    def entry(q, k, v, causal=True, q_offset=0):
        calls.append(1)
        return blockwise_plain(q, k, v, causal and len(calls) - 1 != drop_causal_at,
                               block, q_offset)

    return entry


@contextlib.contextmanager
def recording(calls: list):
    """Record (args, kwargs, result) of every capacity-path ``moe_apply``
    call (the dense fallback routes nothing) into ``calls``."""
    from repro_torch.models import moe

    saved = moe.moe_apply

    def recorded(*args, **kwargs):
        out = saved(*args, **kwargs)
        if not kwargs.get("dense_fallback"):
            calls.append((args, kwargs, out))
        return out

    moe.moe_apply = recorded
    try:
        yield calls
    finally:
        moe.moe_apply = saved


def routing(p, x, n_experts: int, top_k: int, capacity_factor: float):
    """An MoE layer's routing, per token (B*S of them), as ``moe_apply``
    routes: the router's (B*S, E) probabilities, each token's top k
    experts in descending order, and a (B*S, k) mask of the choices kept,
    those whose rank among the earlier choices (token-major) of their row
    for the same expert is under the capacity."""
    import torch
    import torch.nn.functional as F

    b, s, d = x.shape
    probs = torch.softmax(x.reshape(-1, d).float() @ p["router"]["w"].float(), dim=-1)
    top_i = torch.topk(probs, top_k, dim=-1).indices
    capacity = max(1, int(s * top_k / n_experts * capacity_factor))
    onehot = F.one_hot(top_i.reshape(b, s * top_k), n_experts)           # (B, L, E)
    rank = ((onehot.cumsum(dim=1) - onehot) * onehot).sum(-1)            # earlier choices
    return probs, top_i, (rank < capacity).reshape(b * s, top_k)


@contextlib.contextmanager
def pinned_routing(calls: list):
    """Every capacity-path ``moe_apply`` as ``moe_plain`` routed as the
    recorded ``calls`` were, in order (the choices and what capacity kept;
    the probabilities that weight them are the call's own): a second
    prefill then routes each token as the first did, so that the two
    compute one continuous function and no near-tie of a router can part
    them."""
    from repro_torch.models import moe

    saved, recorded = moe.moe_apply, iter(calls)

    def pinned(p, x, n_experts, top_k, capacity_factor=1.25, dense_fallback=False):
        if dense_fallback:
            return saved(p, x, n_experts, top_k, capacity_factor, dense_fallback)
        args, kwargs, _ = next(recorded)
        route = routing(*args[:4], kwargs["capacity_factor"])[1:]
        return moe_plain(p, x, n_experts, top_k, capacity_factor, route)[0]

    moe.moe_apply = pinned
    try:
        yield
    finally:
        moe.moe_apply = saved


def moe_plain(p, x, n_experts: int, top_k: int, capacity_factor: float, route=None):
    """The capacity dispatch's function computed densely: route as
    ``moe_apply`` does (or as ``route``, the top-k experts and kept mask of
    ``routing``, says), drop each choice whose rank among the earlier
    choices (token-major) of its row for the same expert reaches the
    capacity, and weight every expert's SwiGLU output by the kept choices'
    probabilities.  Returns the output and the number of choices dropped."""
    import torch
    import torch.nn.functional as F

    from repro_torch.models.layers import swiglu_apply

    b, s, d = x.shape
    t, bf16 = b * s, torch.bfloat16
    xf = x.reshape(t, d)
    probs, top_i, kept = routing(p, x, n_experts, top_k, capacity_factor)
    if route is not None:
        top_i, kept = route
    top_p = probs.gather(1, top_i)
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
    weights = torch.zeros((t, n_experts), device=x.device).scatter_add_(1, top_i, top_p * kept)
    h = torch.einsum("td,edf->tef", xf.to(bf16), p["w_gate"].to(bf16))
    u = torch.einsum("td,edf->tef", xf.to(bf16), p["w_up"].to(bf16))
    y = torch.einsum("tef,efd->ted", F.silu(h) * u, p["w_down"].to(bf16))
    out = torch.einsum("ted,te->td", y, weights.to(bf16))
    if "shared" in p:
        out = out + swiglu_apply(p["shared"], xf)
    return out.reshape(b, s, d).to(x.dtype), int((~kept).sum())


def decode_against(params, cfg, dev, tokens, rows, max_len: int, tol: dict,
                   cross=None) -> dict:
    """Feed ``tokens`` (B, T) one position a step through ``decode_step``
    and hold each step's logits against ``rows`` (B, T, V), forward's
    logits of the same positions, under ``tol``.  ``cross``: whisper's
    encoder output, whose K/V fill the cross-attention cache first.  Returns
    the worst closeness and each step's time (CUDA events)."""
    import torch

    from repro_torch.models import decode_step, init_cache
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import dense_apply

    b, steps = tokens.shape
    cache = init_cache(cfg, b, max_len, device=dev)
    if cross is not None:
        for i in range(cfg.n_layers):
            lp = tf.layer(params["dec_layers"], i)["cross"]
            shape = (b, cross.shape[1], cfg.n_kv_heads, cfg.head_dim)
            cache["cross"]["k"][i, :, :cross.shape[1]] = dense_apply(lp["wk"], cross).reshape(shape)
            cache["cross"]["v"][i, :, :cross.shape[1]] = dense_apply(lp["wv"], cross).reshape(shape)
        cache["enc_len"].fill_(cross.shape[1])
    worst = {"max_abs_err": 0.0, "tolerance_share": 0.0, "rel_rms_err": 0.0}
    times = []
    for t in range(steps):
        (logits, cache), ms = event_ms(lambda: decode_step(
            params, cfg, cache, {"tokens": tokens[:, t:t + 1], "cur_len": t}))
        times.append(ms)
        check(bool(torch.isfinite(logits).all()), f"{cfg.name}: decode step {t} not finite")
        for key, value in zip(worst, closeness(logits[:, 0], rows[:, t], tol)):
            worst[key] = max(worst[key], value)
    return {**worst, "step_ms": times}


def run_model(name, cfg, dev, counters, failures: list) -> dict:
    """One model on the card: seeded params; a prefill with the kernel (its
    launches counted) against the same prefill with blockwise attention in
    the kernel's place; for the main model a planted fault; an MoE layer's
    dispatch against its plain version; decode against forward (for a
    recurrent model also in fp32); for the main model, serving."""
    import dataclasses

    import torch

    from repro_torch.models import forward, init_params
    from repro_torch.models.layers import tree_map
    from repro_torch.models.model import encode

    flash = counters["flash_attention_fwd"]
    main = name == MAIN_ARCH
    recurrent = cfg.family in ("hybrid", "xlstm")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=MODEL_SEED, device=dev)
    leaves = []
    tree_map(leaves.append, params)
    n_params = sum(x.numel() for x in leaves)
    del leaves
    rng = np.random.default_rng(MODEL_SEED)
    b, s = (PREFILL_BATCH, PREFILL_SEQ) if main else (
        1, WHISPER_TOKENS if cfg.family == "encdec" else CUT_SEQ)
    batch = model_batch(cfg, dev, rng, b, s)
    res = {"name": name, "layers": cfg.n_layers, "params": n_params, "prefill": [b, s]}

    def held(close, tol: dict, what: str, **extra) -> dict:
        out = dict(zip(("max_abs_err", "tolerance_share", "rel_rms_err"), close), **extra)
        if out["tolerance_share"] > 1.0 or out["rel_rms_err"] > tol["rel_rms"]:
            failures.append(f"{name} {what}: {out}")
        return out

    def prefill():
        hidden = forward(params, cfg, batch)
        return hidden, unembed(params, hidden[:, -1:])

    calls = []
    before = flash.launches
    with recording(calls):
        hidden, logits = prefill()
    torch.cuda.synchronize()
    res["launches"] = flash.launches - before
    res["expected_launches"] = self_attention_layers(cfg)
    if res["launches"] != res["expected_launches"]:
        failures.append(f"{name}: {res['launches']} flash launches in a prefill, "
                        f"{res['expected_launches']} self-attention layers")
    check(bool(torch.isfinite(hidden).all()), f"{name}: prefill not finite")
    res["prefill_ms"] = median_ms(prefill, PREFILL_RUNS)
    with attention_entry(blockwise_entry(cfg.attn_block)), pinned_routing(calls):
        want_hidden, want_logits = prefill()
    res["prefill_hidden_vs_blockwise"] = held(
        closeness(hidden, want_hidden, WHOLE_MODEL), WHOLE_MODEL,
        "prefill hidden with the kernel vs blockwise")
    res["prefill_logits_vs_blockwise"] = held(
        closeness(logits, want_logits, WHOLE_MODEL), WHOLE_MODEL,
        "prefill logits with the kernel vs blockwise")
    del want_hidden, want_logits
    if main and res["expected_launches"]:
        with attention_entry(blockwise_entry(cfg.attn_block, drop_causal_at=0)):
            wrong, _ = prefill()
        close = closeness(wrong, hidden, WHOLE_MODEL)
        res["planted_fault"] = dict(zip(("max_abs_err", "tolerance_share", "rel_rms_err"), close),
                                    fault="layer 0's causal mask dropped")
        if close[1] <= 1.0 and close[2] <= WHOLE_MODEL["rel_rms"]:
            failures.append(f"{name}: the planted fault passed: {res['planted_fault']}")
        del wrong
    if calls:
        (p, x, n_experts, top_k), kwargs, out = calls[0][0][:4], calls[0][1], calls[0][2]
        want, dropped = moe_plain(p, x, n_experts, top_k, kwargs["capacity_factor"])
        res["moe_dispatch_vs_plain"] = held(
            closeness(out, want, OTHER_ROUNDING), OTHER_ROUNDING,
            "MoE capacity dispatch vs its plain version", choices_dropped=dropped)
        del p, x, out, want

    # decode against forward
    if main:
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (DECODE_BATCH, DECODE_PROMPT))).to(dev)
        rows = unembed(params, forward(params, cfg, {"tokens": tokens}))
        cross, max_len = None, DECODE_MAX_LEN
    else:
        tokens = batch["tokens"][:, :CUT_DECODE_STEPS]
        if cfg.frontend == "vision_stub":
            # decode takes text alone: hold it against a forward of the text alone
            text_cfg = dataclasses.replace(cfg, frontend=None)
            rows = unembed(params, forward(params, text_cfg, {"tokens": tokens}))
        else:
            rows = unembed(params, hidden[:, :CUT_DECODE_STEPS])
        cross = encode(params, cfg, batch["frames"]) if cfg.family == "encdec" else None
        max_len = CUT_DECODE_STEPS if cross is None else cross.shape[1]
    closeness_of = operator.itemgetter("max_abs_err", "tolerance_share", "rel_rms_err")
    tol = RECURRENT_MODEL[cfg.family] if recurrent else WHOLE_MODEL
    decode = decode_against(params, cfg, dev, tokens, rows, max_len, tol, cross)
    res["decode"] = held(closeness_of(decode), tol, "decode vs forward")
    if recurrent:
        with fp32_compute():
            rows = unembed(params, forward(params, cfg, batch)[:, :CUT_DECODE_STEPS])
            exact = decode_against(params, cfg, dev, tokens, rows, max_len, FP32_MODEL)
        res["decode_fp32"] = held(closeness_of(exact), FP32_MODEL, "decode vs forward in fp32")
    res["decode_batch"] = list(tokens.shape)
    res["decode_step_ms"] = statistics.median(decode["step_ms"])
    if main:
        res["serve"] = serve_model(params, cfg, dev, failures)
    del params, batch, hidden, logits, rows, calls
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t0
    print(f"  {name} ({cfg.n_layers} layers, {n_params} params): prefill {b}x{s} "
          f"{res['prefill_ms']:.3f} ms, {res['launches']} flash launches "
          f"({res['expected_launches']} self-attention layers); kernel vs blockwise: hidden "
          f"{res['prefill_hidden_vs_blockwise']['tolerance_share']:.3g} of the allowance "
          f"(rel {res['prefill_hidden_vs_blockwise']['rel_rms_err']:.3g}), logits "
          f"{res['prefill_logits_vs_blockwise']['tolerance_share']:.3g} "
          f"(rel {res['prefill_logits_vs_blockwise']['rel_rms_err']:.3g}); "
          f"decode {tuple(tokens.shape)} vs "
          f"forward {res['decode']['tolerance_share']:.3g} (rel {res['decode']['rel_rms_err']:.3g})"
          f", {res['decode_step_ms']:.3f} ms a step; "
          f"{res['seconds']:.1f} s", flush=True)
    for key in ("planted_fault", "moe_dispatch_vs_plain", "decode_fp32"):
        if key in res:
            print(f"    {key}: {res[key]}", flush=True)
    return res


def serve_model(params, cfg, dev, failures: list) -> dict:
    """``ServeLoop`` over the main model: requests with 1-5-token prompts,
    some with capabilities lacking the READ right, as ``launch.serve``
    makes them.  Every good request must get ``SERVE_MAX_TOKENS`` tokens;
    every bad one must be rejected before it takes a slot."""
    from repro_torch.core.auth import CapabilityAuthority, Rights
    from repro_torch.models import decode_step, init_cache
    from repro_torch.runtime.serve_loop import Request, ServeLoop

    authority = CapabilityAuthority(b"serving-key-0123")
    now = int(time.time())
    rng = np.random.default_rng(MODEL_SEED)
    reqs, bad = [], set()
    for i in range(SERVE_REQUESTS):
        if rng.random() < SERVE_REJECT_RATE:
            bad.add(i)
        cap = authority.issue(client_id=i, object_id=0, offset=0, length=1 << 20,
                              rights=int(Rights.WRITE if i in bad else Rights.READ),
                              expiry=now + 3600)
        reqs.append(Request(i, rng.integers(1, cfg.vocab, rng.integers(1, 6)).tolist(),
                            SERVE_MAX_TOKENS, cap))
    seated = set()

    def step(p, c, b):
        seated.update(r.rid for r in loop.slots if r is not None)
        return decode_step(p, cfg, c, b)

    loop = ServeLoop(step, params, lambda: init_cache(cfg, SERVE_SLOTS, SERVE_MAX_LEN,
                                                      device=dev),
                     SERVE_SLOTS, authority, eos_id=-1)
    t0 = time.perf_counter()
    done = loop.run(reqs)
    wall = time.perf_counter() - t0
    served = [r for r in done if not r.rejected]
    rejected = sorted(r.rid for r in done if r.rejected)
    tokens = sum(len(r.out) for r in served)
    ok = (len(done) == SERVE_REQUESTS and rejected == sorted(bad) and not seated & bad
          and all(len(r.out) == SERVE_MAX_TOKENS for r in served)
          and all(not r.out for r in done if r.rejected))
    if not ok:
        failures.append(f"serving: rejected {rejected} (bad {sorted(bad)}), seated {seated}, "
                        f"tokens {[len(r.out) for r in served]}")
    res = {"requests": SERVE_REQUESTS, "served": len(served), "rejected": rejected,
           "tokens": tokens, "steps": loop.steps, "wall_s": wall,
           "tokens_per_s": tokens / wall, "ms_per_step": wall / loop.steps * 1e3}
    print(f"  serving {cfg.name}: {len(served)} requests served ({tokens} tokens), "
          f"{len(rejected)} rejected, {loop.steps} batched steps in {wall:.3f} s: "
          f"{res['tokens_per_s']:.1f} tokens/s, {res['ms_per_step']:.3f} ms a step", flush=True)
    return res


def drive_models(dev, counters) -> list[dict]:
    """Phase 6: every model of ``model_configs()`` on the card, one after the
    other (each freed before the next); fails after the last if any check
    failed."""
    import torch

    failures: list[str] = []
    results = []
    with torch.no_grad():
        for name, cfg in model_configs().items():
            results.append(run_model(name, cfg, dev, counters, failures))
    check(not failures, "phase 6 failed:\n  " + "\n  ".join(failures))
    return results


# -- phase 7: the training runtime --------------------------------------------------------

#: the main training model: yi-9b at its published widths with its depth cut
#: to 8 of 48 layers (1.91 B params): 48 layers need 141 GB of fp32 params,
#: gradients and AdamW moments, 8 need 30.5 GB
TRAIN_ARCH, TRAIN_DEPTH = "yi-9b", 8
TRAIN_BATCH, TRAIN_SEQ = 1, 4096            # train_4k's share of one chip
TRAIN_TIMED_STEPS = 3                       # timed steps after a warm one
#: the directional derivative's cut, its step (relative to each leaf's RMS)
#: and its limit: central differences D(h) = (L(p + h u) - L(p - h u)) / 2h
#: at h = eps and 2 eps, extrapolated to (4 D(eps) - D(2 eps)) / 3 (error
#: O(eps^4)), against <grad L, u>.  The fp32 loss's last bits (a sum over
#: 4096 tokens; its ulp is 1e-6) call for a step as large as that allows.
DIRECTIONAL_DEPTH, DIRECTIONAL_EPS, DIRECTIONAL_TOL = 2, 1e-2, 1e-2
#: leaves whose AdamW update is held against a float64 plain update on the
#: host: an unstacked norm scale (no decay), a stacked one (decays, as in the
#: reference) and a stacked weight
ADAMW_LEAVES = ("ln_f/scale", "layers/ln1/scale", "layers/attn/wk/w")
ADAMW_TOL = 1e-6
#: remat against no remat where an op of the step warns that it has no
#: deterministic CUDA path: both orders of a sum then differ in fp32 rounding,
#: carried through the backward; with every op deterministic, bit for bit
NONDETERMINISTIC_REMAT = 1e-3
#: the fault-tolerant runtime: whisper-base whole (6 + 6 layers, 0.10 B
#: params: 1.2 GB of params and moments a checkpoint), B=8, S=512 (a
#: multiple of its loss_chunk, 128), 8 steps, a checkpoint every 4, a compute
#: failure and storage node 2 lost at step 6; launch.train's cluster of 8
#: nodes and CheckpointPolicy(k=4, m=2), its nodes grown from 256 MiB to
#: 2 GiB so that the run's four saves (steps 0, 4 and 8, and the trainer's
#: final blocking save of step 8: 7.2 GB with parity, the last two on the 7
#: live nodes) fit
RUNTIME_ARCH = "whisper-base"
RUNTIME_BATCH, RUNTIME_SEQ = 8, 512
RUNTIME_STEPS, RUNTIME_CKPT_EVERY, RUNTIME_FAIL_AT = 8, 4, 6
RUNTIME_NODES, RUNTIME_NODE_CAPACITY, RUNTIME_FAILED_NODE = 8, 1 << 31, 2
#: the other archs train one step at their phase 6 cuts at B=1, S=512
CUT_TRAIN_SEQ = 512
TRAIN_LEFT_OUT = {"dbrx-132b": "one layer's 4.49 B params need 72 GB of training state"}
#: the reference's documented training command (src/repro/launch/train.py)
LAUNCHER_ARGS = ["--arch", "yi-9b", "--smoke", "--steps", "30", "--fail-at", "20"]


def training_configs() -> tuple:
    """Phase 7's models: (the main one, cut; the runtime's, whole; the rest
    at their phase 6 cuts, by name)."""
    import dataclasses

    from repro_torch.configs import ARCHS

    main = dataclasses.replace(ARCHS[TRAIN_ARCH].model, n_layers=TRAIN_DEPTH)
    cuts = {name: cfg for name, cfg in model_configs().items()
            if name != MAIN_ARCH and name not in TRAIN_LEFT_OUT}
    return main, ARCHS[RUNTIME_ARCH].model, cuts


def train_batch(cfg, dev, rng, b: int, s: int) -> dict:
    """Seeded training inputs: ``model_batch``'s and the labels."""
    import torch

    batch = model_batch(cfg, dev, rng, b, s)
    batch["labels"] = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s))).to(dev)
    return batch


def train_step_of(cfg, adam=None):
    """``launch.steps.make_train_step`` for ``cfg`` on one device."""
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch.steps import make_train_step

    arch = next(a for a in ARCHS.values() if a.model.name == cfg.name or a.smoke.name == cfg.name)
    return make_train_step(dataclasses.replace(arch, model=cfg), SHAPES["train_4k"], None, adam)


def by_path(tree) -> dict:
    from repro_torch.checkpoint.manager import flatten, path_str

    return {path_str(p): x for p, x in flatten(tree)}


@contextlib.contextmanager
def deterministic():
    """``torch.use_deterministic_algorithms(True, warn_only=True)`` inside;
    yields a list that gathers the ops that warned that they have no
    deterministic path."""
    import warnings

    import torch

    ops: list[str] = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            yield ops
        finally:
            torch.use_deterministic_algorithms(False)
    ops.extend(sorted({str(w.message).split(" does not have")[0][:120] for w in caught
                       if "deterministic" in str(w.message)}))


def remat_against_none(params, cfg, batch) -> dict:
    """One step's loss and gradients with ``remat`` on against off, under
    deterministic algorithms: equal bit for bit, or, where an op warned that
    it has none, within ``NONDETERMINISTIC_REMAT`` relative RMS error."""
    import dataclasses

    import torch

    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models.layers import tree_leaves

    with deterministic() as ops:
        loss_on, on = loss_and_grads(params, dataclasses.replace(cfg, remat=True), batch)
        loss_off, off = loss_and_grads(params, dataclasses.replace(cfg, remat=False), batch)
        pairs = list(zip(tree_leaves(on), tree_leaves(off), strict=True))
        bitwise = bool(torch.equal(loss_on, loss_off)) and all(torch.equal(a, b) for a, b in pairs)
        worst = 0.0 if bitwise else max(
            float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30))
            for a, b in pairs)
        finite = all(bool(torch.isfinite(a).all()) for a, _ in pairs)
    del on, off, pairs
    ok = finite and (bitwise or (bool(ops) and worst <= NONDETERMINISTIC_REMAT))
    return {"loss": float(loss_on), "finite": finite, "bitwise": bitwise,
            "worst_rel_err": worst, "nondeterministic_ops": ops, "ok": ok}


def adamw_plain(p, g, m, v, step: int, lr: float, gnorm: float, cfg) -> tuple:
    """The reference's AdamW update of one leaf in float64 on the host."""
    import torch

    p, g, m, v = (x.detach().cpu().double() for x in (p, g, m, v))
    step += 1
    g = g * min(1.0, cfg.grad_clip / max(gnorm, 1e-9))
    m2 = cfg.b1 * m + (1 - cfg.b1) * g
    v2 = cfg.b2 * v + (1 - cfg.b2) * g * g
    direction = (m2 / (1 - cfg.b1 ** step)) / (torch.sqrt(v2 / (1 - cfg.b2 ** step)) + cfg.eps)
    if p.ndim >= 2:
        direction = direction + cfg.weight_decay * p
    return p - lr * direction, m2, v2


def adamw_against_float64(params, opt, cfg, batch, counter) -> dict:
    """One AdamW update on the card (``adamw_update`` at the peak learning
    rate, so that the update stands far above fp32 rounding) against
    ``adamw_plain`` for ``ADAMW_LEAVES``: params, ``m`` and ``v`` within
    ``ADAMW_TOL`` of each leaf's largest magnitude, the update through the
    fused kernel (``counter``: its launches)."""
    import torch

    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models.layers import tree_leaves
    from repro_torch.optim.adamw import AdamWConfig, adamw_update

    adam = AdamWConfig()
    _, grads = loss_and_grads(params, cfg, batch)
    step = int(opt["step"])
    gnorm = float(torch.sqrt(sum(g.double().square().sum() for g in tree_leaves(grads))))
    before = {path: [by_path(tree)[path].detach().cpu().clone()
                     for tree in (params, grads, opt["m"], opt["v"])] for path in ADAMW_LEAVES}
    launches = counter.launches
    params, opt, metrics = adamw_update(params, grads, opt, adam)
    del grads
    res = {"step": step + 1, "lr": float(metrics["lr"]), "grad_norm": float(metrics["grad_norm"]),
           "grad_norm_f64": gnorm, "launches": counter.launches - launches}
    for path, leaf in before.items():
        want = adamw_plain(*leaf, step, adam.lr, gnorm, adam)
        got = [by_path(tree)[path] for tree in (params, opt["m"], opt["v"])]
        res[path] = max(float((g.detach().cpu().double() - w).abs().max() / w.abs().max())
                        for g, w in zip(got, want))
    res["ok"] = all(res[path] <= ADAMW_TOL for path in ADAMW_LEAVES) and \
        abs(res["grad_norm"] - gnorm) <= ADAMW_TOL * gnorm and res["launches"] > 0
    return res


def model_flops(cfg, tokens: int, seq: int) -> dict:
    """The step's floating-point operations, from its shapes: bf16 products
    (6 x matmul params x tokens: forward and backward; remat recomputes
    the layers' forward once more) and the blockwise attention in fp32 as its
    loops compute it (forward: the KV blocks each query row sees, whole
    blocks, masked; backward: every block, every row)."""
    d, hd = cfg.d_model, cfg.head_dim
    per_layer = (d * cfg.n_heads * hd * 2 + d * cfg.n_kv_heads * hd * 2
                 + 3 * d * cfg.d_ff)
    matmul = cfg.n_layers * per_layer + d * cfg.vocab
    block = min(cfg.attn_block, seq)
    seen = sum((seq - start) * min(block, seq - start) for start in range(0, seq, block))
    batch = tokens // seq
    fwd = 4 * hd * seen * cfg.n_heads * batch * cfg.n_layers
    bwd = 10 * hd * seq * seq * cfg.n_heads * batch * cfg.n_layers
    return {"matmul_params": matmul, "bf16": 6 * matmul * tokens,
            "bf16_recompute": 2 * cfg.n_layers * per_layer * tokens,
            "attention_fp32": fwd + bwd, "attention_fp32_recompute": fwd,
            "formula": "6 x matmul params x tokens (bf16) + blockwise attention in fp32: "
                       "forward 4 x D x (query, key) pairs of the blocks each row sees, "
                       "backward 10 x D x S^2, x heads x layers"}


def train_main_model(cfg, dev, counters, failures: list) -> dict:
    """7a: the main model's train step at full width: the prefill (the
    flash kernel) and the training forward; timed steps with and without
    remat; remat against none; AdamW against float64."""
    import dataclasses

    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention, forward, init_params, loss_fn
    from repro_torch.models.layers import chunked_cross_entropy, tree_leaves
    from repro_torch.optim.adamw import init_opt_state

    flash = counters["flash_attention_fwd"]
    # the train step's attention: the kernel pair where the route takes it
    # (bf16 on the card), else the plain loops, whose forward is blockwise_loss's
    pair = attention.attention_route(dev.type, (torch.bfloat16,) * 3, cfg.head_dim,
                                     cfg.head_dim, True, False) == "pair"
    t0 = time.perf_counter()
    params = init_params(cfg, seed=MODEL_SEED, device=dev)
    opt = init_opt_state(params)
    n_params = sum(x.numel() for x in tree_leaves(params))
    rng = np.random.default_rng(MODEL_SEED + 1)
    batch = train_batch(cfg, dev, rng, TRAIN_BATCH, TRAIN_SEQ)
    res = {"name": cfg.name, "layers": cfg.n_layers, "params": n_params,
           "batch": [TRAIN_BATCH, TRAIN_SEQ], "remat": cfg.remat}

    # the serving forward (the flash kernel) and the training forward's
    # function (blockwise attention in the kernel's place), under no_grad
    with torch.no_grad():
        before = flash.launches
        hidden = forward(params, cfg, batch)
        prefill_loss = float(chunked_cross_entropy(hidden, params["unembed"]["w"],
                                                   batch["labels"], chunk=cfg.loss_chunk))
        res["prefill_launches"] = flash.launches - before
        logits_rms = float(unembed(params, hidden[:, -cfg.loss_chunk:]).square().mean().sqrt())
        del hidden
        with attention_entry(blockwise_entry(cfg.attn_block)):
            blockwise_loss = float(loss_fn(params, cfg, batch))
    if res["prefill_launches"] != cfg.n_layers:
        failures.append(f"{cfg.name}: {res['prefill_launches']} flash launches in the prefill, "
                        f"{cfg.n_layers} layers")

    step = train_step_of(cfg)
    before = flash.launches
    pair_before = (fa.flash_attention_fwd_lse.launches, fa.flash_attention_bwd.launches,
                   attention.PLAIN_CALLS[dev.type])
    losses, times, peaks = {}, {}, {}
    for remat in (True, False):
        fn = step if remat else train_step_of(dataclasses.replace(cfg, remat=False))
        torch.cuda.reset_peak_memory_stats()
        key = "remat" if remat else "no_remat"
        losses[key], times[key] = [], []
        for i in range(1 + TRAIN_TIMED_STEPS):
            ctx = deterministic() if (remat and i == 0) else contextlib.nullcontext()
            start = time.perf_counter()
            with ctx:
                params, opt, metrics = fn(params, opt, batch)
                losses[key].append(float(metrics["loss"]))
            torch.cuda.synchronize()
            times[key].append((time.perf_counter() - start) * 1e3)
        peaks[key] = torch.cuda.max_memory_allocated()
    res["train_step_launches"] = flash.launches - before
    if res["train_step_launches"]:
        failures.append(f"{cfg.name}: the train step launched the forward-only flash kernel "
                        f"{res['train_step_launches']} times")
    # each remat step runs a layer's forward twice, each step without once;
    # every step runs its backward once
    steps = 1 + TRAIN_TIMED_STEPS
    res["pair_launches"] = {
        "forward": fa.flash_attention_fwd_lse.launches - pair_before[0],
        "backward": fa.flash_attention_bwd.launches - pair_before[1],
        "plain_calls": attention.PLAIN_CALLS[dev.type] - pair_before[2]}
    want = ({"forward": 3 * steps * cfg.n_layers, "backward": 2 * steps * cfg.n_layers,
             "plain_calls": 0} if pair else
            {"forward": 0, "backward": 0, "plain_calls": 3 * steps * cfg.n_layers})
    if res["pair_launches"] != want:
        failures.append(f"{cfg.name}: the train steps' attention calls {res['pair_launches']}, "
                        f"expected {want}")
    all_losses = losses["remat"] + losses["no_remat"]
    if not all(np.isfinite(all_losses)):
        failures.append(f"{cfg.name}: a train step's loss is not finite: {all_losses}")
    # (iv) the step's loss at step 0 is the training forward's function, bit
    # for bit: on the kernel pair, the flash kernel's no_grad prefill (the
    # same launch, with lse written beside it); on the plain loops,
    # blockwise attention's plain forward under no_grad; and the kernel's
    # prefill within WHOLE_MODEL's relative RMS error on the logits of the
    # plain forward's loss, carried to the loss by |d CE| <= 2 max |d logit|
    # (in RMS: 2 rel_rms rms(logits))
    limit = 2 * WHOLE_MODEL["rel_rms"] * logits_rms
    res["step0_loss"], res["blockwise_loss"], res["prefill_loss"] = (
        losses["remat"][0], blockwise_loss, prefill_loss)
    res["prefill_loss_limit"] = limit
    res["train_forward"] = "kernel pair" if pair else "blockwise"
    train_forward_loss = prefill_loss if pair else blockwise_loss
    if losses["remat"][0] != train_forward_loss:
        failures.append(f"{cfg.name}: step 0's loss {losses['remat'][0]!r} is not the "
                        f"{res['train_forward']} forward's {train_forward_loss!r}")
    if abs(prefill_loss - blockwise_loss) > limit:
        failures.append(f"{cfg.name}: the kernel's prefill loss {prefill_loss} vs the blockwise "
                        f"forward's {blockwise_loss}: more than {limit:.3g} apart")
    flops = model_flops(cfg, TRAIN_BATCH * TRAIN_SEQ, TRAIN_SEQ)
    for key in ("remat", "no_remat"):
        ms = statistics.median(times[key][1:])
        model = flops["bf16"] + flops["attention_fp32"]
        res[key] = {"losses": losses[key], "step_ms": times[key], "median_step_ms": ms,
                    "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / ms * 1e3,
                    "model_flops": model, "model_tflops_per_s": model / ms / 1e9,
                    "share_of_bf16_peak": model / (ms * 1e-3) / PEAK_FLOPS["bfloat16"],
                    "max_memory_allocated": peaks[key]}
    res["flops"] = flops

    # (ii) remat against none, and (v) AdamW against float64
    res["remat_vs_none"] = remat_against_none(params, cfg, batch)
    if not res["remat_vs_none"]["ok"]:
        failures.append(f"{cfg.name}: gradients with remat vs without: {res['remat_vs_none']}")
    res["adamw_vs_float64"] = adamw_against_float64(params, opt, cfg, batch,
                                                    counters["adamw_step"])
    if not res["adamw_vs_float64"]["ok"]:
        failures.append(f"{cfg.name}: AdamW vs a float64 update: {res['adamw_vs_float64']}")
    del params, opt, batch
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t0
    return res


def directional_check(cfg, dev) -> dict:
    """7a (iii): the whole backward of ``loss_fn`` on a ``DIRECTIONAL_DEPTH``
    cut with every product in fp32: for a seeded direction u (each leaf's
    normal draws times its RMS), the extrapolated central difference of L
    along u (see ``DIRECTIONAL_EPS``) against <grad L, u>, every L through
    the same blockwise attention."""
    import dataclasses

    import torch

    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import init_params, loss_fn
    from repro_torch.models.layers import tree_leaves, tree_map, tree_unflatten

    cfg = dataclasses.replace(cfg, n_layers=DIRECTIONAL_DEPTH)
    rng = np.random.default_rng(MODEL_SEED + 2)
    with fp32_compute():
        params = init_params(cfg, seed=MODEL_SEED + 2, device=dev)
        batch = train_batch(cfg, dev, rng, TRAIN_BATCH, TRAIN_SEQ)
        _, grads = loss_and_grads(params, cfg, batch)
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED + 7)
        u = tree_map(lambda p: torch.randn(p.shape, generator=gen, device=dev)
                     * p.square().mean().sqrt(), params)
        dot = float(sum((g.double() * d.double()).sum()
                        for g, d in zip(tree_leaves(grads), tree_leaves(u), strict=True)))
        del grads
        losses = {}
        with torch.no_grad(), attention_entry(blockwise_entry(cfg.attn_block)):
            for h in (DIRECTIONAL_EPS, -DIRECTIONAL_EPS, 2 * DIRECTIONAL_EPS,
                      -2 * DIRECTIONAL_EPS):
                moved = tree_unflatten(params, [p + h * d for p, d in
                                                zip(tree_leaves(params), tree_leaves(u))])
                losses[h] = float(loss_fn(moved, cfg, batch))
                del moved

    def central(h):
        return (losses[h] - losses[-h]) / (2 * h)

    fd = (4 * central(DIRECTIONAL_EPS) - central(2 * DIRECTIONAL_EPS)) / 3
    rel = abs(fd - dot) / max(abs(dot), 1e-30)
    del params, u, batch
    torch.cuda.empty_cache()
    return {"layers": cfg.n_layers, "eps": DIRECTIONAL_EPS, "directional": dot,
            "finite_difference": fd, "central": central(DIRECTIONAL_EPS), "rel_err": rel,
            "ok": rel <= DIRECTIONAL_TOL}


def train_runtime(cfg, dev, counters, failures: list) -> dict:
    """7b: the fault-tolerant runtime as ``launch.train`` builds it, on the
    card: ``RUNTIME_STEPS`` steps, a checkpoint every ``RUNTIME_CKPT_EVERY``
    under RS(4,2), a compute failure and storage node
    ``RUNTIME_FAILED_NODE`` lost at step ``RUNTIME_FAIL_AT``.  One restart;
    the restored state bitwise the state saved; the replayed steps' losses
    equal their first run's, bit for bit (deterministic algorithms on); the
    GF(2^8) kernel launched on every save (encode) and on the degraded
    restore (decode)."""
    import torch

    from repro_torch.checkpoint import CheckpointManager, CheckpointPolicy, StorageCluster
    from repro_torch.data import DataPipeline, PipelineConfig, SyntheticSource
    from repro_torch.launch.train import make_batch_extras
    from repro_torch.models import init_params
    from repro_torch.models.layers import tree_leaves
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.runtime import Trainer, TrainLoopConfig

    matmul = counters["gf_matmul_bytes_batched"]
    t0 = time.perf_counter()
    params = init_params(cfg, seed=MODEL_SEED, device=dev)
    opt = init_opt_state(params)
    n_params = sum(x.numel() for x in tree_leaves(params))
    step = train_step_of(cfg)

    def step_fn(p, o, batch):
        return step(p, o, make_batch_extras(cfg, dict(batch)))

    pipe = DataPipeline(SyntheticSource(cfg.vocab, seed=SEED),
                        PipelineConfig(batch=RUNTIME_BATCH, seq=RUNTIME_SEQ), device=dev)
    cluster = StorageCluster(num_nodes=RUNTIME_NODES, node_capacity=RUNTIME_NODE_CAPACITY,
                             device=dev)
    mgr = CheckpointManager(cluster, CheckpointPolicy(k=4, m=2))
    trainer = Trainer(step_fn, params, opt, pipe, mgr,
                      TrainLoopConfig(total_steps=RUNTIME_STEPS,
                                      checkpoint_every=RUNTIME_CKPT_EVERY))
    del params, opt
    saves, restores, held = [], [], {}
    write = mgr._write

    def counted_write(step_no, snap):
        before = matmul.launches
        write(step_no, snap)
        saves.append({"step": step_no, "encode_launches": matmul.launches - before,
                      "seconds": mgr.save_seconds[-1]})

    mgr._write = counted_write
    restore = trainer.restore_latest

    def timed_restore():
        before, ec_before = matmul.launches, totals["ec_s"]
        start = time.perf_counter()
        restore()
        torch.cuda.synchronize()
        restores.append({"step": trainer.step, "seconds": time.perf_counter() - start,
                         "ec_s": totals["ec_s"] - ec_before,
                         "decode_launches": matmul.launches - before})
        got = by_path({"params": trainer.params, "opt": trainer.opt_state})
        restores[-1]["bitwise"] = sorted(got) == sorted(held) and all(
            got[path].dtype == want.dtype and torch.equal(got[path].cpu(), want)
            for path, want in held.items())

    trainer.restore_latest = timed_restore

    def inject(step_no, tr):
        if step_no == RUNTIME_CKPT_EVERY and not held:
            # the state the step-4 checkpoint holds, for the restore to match
            held.update({path: x.detach().cpu().clone() for path, x in
                         by_path({"params": tr.params, "opt": tr.opt_state}).items()})
        if step_no == RUNTIME_FAIL_AT and not tr.restarts:
            cluster.fail_node(RUNTIME_FAILED_NODE)
            return True
        return False

    with deterministic() as ops, ec_wall_time({"ec_s": 0.0}) as totals:
        try:
            hist = trainer.run(inject_failure=inject)
        finally:
            pipe.close()
    steps = [h["step"] for h in hist]
    first = {h["step"]: h["loss"] for h in hist[:RUNTIME_FAIL_AT]}
    replayed = hist[RUNTIME_FAIL_AT:RUNTIME_FAIL_AT + RUNTIME_FAIL_AT - RUNTIME_CKPT_EVERY]
    want_steps = [*range(1, RUNTIME_FAIL_AT + 1), *range(RUNTIME_CKPT_EVERY + 1,
                                                          RUNTIME_STEPS + 1)]
    save_s = sum(s["seconds"] for s in saves)
    restore_ec = sum(r["ec_s"] for r in restores)
    res = {"name": cfg.name, "params": n_params, "batch": [RUNTIME_BATCH, RUNTIME_SEQ],
           "steps": steps, "losses": [h["loss"] for h in hist], "restarts": trainer.restarts,
           "replayed_equal": bool(replayed) and all(h["loss"] == first[h["step"]]
                                                    for h in replayed),
           "saves": saves, "restores": restores, "save_s": save_s,
           "save_ec_s": totals["ec_s"] - restore_ec,
           "restore_s": sum(r["seconds"] for r in restores), "restore_ec_s": restore_ec,
           "step_ms": statistics.median(h["dt"] for h in hist[1:]) * 1e3,
           "nondeterministic_ops": ops, "storage": cluster.stats()}
    if trainer.restarts != 1 or steps != want_steps:
        failures.append(f"{cfg.name} runtime: {trainer.restarts} restarts, steps {steps}")
    if not res["replayed_equal"]:
        failures.append(f"{cfg.name} runtime: replayed losses {[h['loss'] for h in replayed]} "
                        f"differ from their first run {first}")
    if not (restores and restores[0]["bitwise"]):
        failures.append(f"{cfg.name} runtime: the restored state is not the state saved at "
                        f"step {RUNTIME_CKPT_EVERY}")
    if not (restores and restores[0]["decode_launches"] > 0):
        failures.append(f"{cfg.name} runtime: the degraded restore launched no decode kernel")
    # the step-0 snapshot, one a RUNTIME_CKPT_EVERY steps, the final blocking save
    want_saves = [*range(0, RUNTIME_STEPS + 1, RUNTIME_CKPT_EVERY), RUNTIME_STEPS]
    if [s["step"] for s in saves] != want_saves or not all(
            s["encode_launches"] > 0 for s in saves):
        failures.append(f"{cfg.name} runtime: saves {saves}")
    if not all(np.isfinite(res["losses"])):
        failures.append(f"{cfg.name} runtime: losses {res['losses']}")
    del trainer
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t0
    return res


def train_cut_model(name, cfg, dev, failures: list) -> dict:
    """7c: one train step of a cut model at B=1, S=``CUT_TRAIN_SEQ`` (llava
    with its patch tokens, whisper over its frames): finite, and its
    gradients with remat equal to those without."""
    import torch

    from repro_torch.models import init_params
    from repro_torch.models.layers import tree_leaves
    from repro_torch.optim.adamw import init_opt_state

    t0 = time.perf_counter()
    params = init_params(cfg, seed=MODEL_SEED, device=dev)
    opt = init_opt_state(params)
    n_params = sum(x.numel() for x in tree_leaves(params))
    batch = train_batch(cfg, dev, np.random.default_rng(MODEL_SEED + 3), 1, CUT_TRAIN_SEQ)
    res = {"name": name, "layers": cfg.n_layers, "params": n_params,
           "remat_vs_none": remat_against_none(params, cfg, batch)}
    if not res["remat_vs_none"]["ok"]:
        failures.append(f"{name}: gradients with remat vs without: {res['remat_vs_none']}")
    step = train_step_of(cfg)
    times, losses = [], []
    for _ in range(2):                      # a warm step, a timed one
        start = time.perf_counter()
        params, opt, metrics = step(params, opt, batch)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
    res.update(losses=losses, step_ms=times[-1])
    if not all(np.isfinite(losses)):
        failures.append(f"{name}: train step losses {losses}")
    del params, opt, batch
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t0
    return res


def train_launcher(dev, failures: list) -> dict:
    """7d: ``launch.train.main`` with the reference's documented command on
    the card: one restart, finite losses."""
    from repro_torch.launch import train

    t0 = time.perf_counter()
    trainer = train.main([*LAUNCHER_ARGS, "--device", str(dev)])
    losses = [h["loss"] for h in trainer.history]
    res = {"args": LAUNCHER_ARGS, "steps": trainer.step, "restarts": trainer.restarts,
           "first_loss": losses[0], "last_loss": losses[-1],
           "seconds": time.perf_counter() - t0}
    if trainer.restarts != 1 or not all(np.isfinite(losses)):
        failures.append(f"launcher: {trainer.restarts} restarts, losses {losses}")
    return res


def drive_training(dev, counters) -> dict:
    """Phase 7: the training runtime on the card, part by part (each model
    freed before the next); fails after the last if any check failed."""
    import torch

    main_cfg, runtime_cfg, cuts = training_configs()
    failures: list[str] = []
    res = {"main": train_main_model(main_cfg, dev, counters, failures)}
    main = res["main"]
    print(f"  7a {main['name']} ({main['layers']} layers, {main['params']} params), B={TRAIN_BATCH} "
          f"S={TRAIN_SEQ}: step {main['remat']['median_step_ms']:.3f} ms with remat "
          f"({main['remat']['tokens_per_s']:.1f} tokens/s, "
          f"{main['remat']['model_tflops_per_s']:.1f} TFLOP/s of model FLOPs, "
          f"{main['remat']['share_of_bf16_peak']:.4f} of 989 TFLOP/s; peak "
          f"{main['remat']['max_memory_allocated']} B), {main['no_remat']['median_step_ms']:.3f} ms "
          f"without ({main['no_remat']['max_memory_allocated']} B); model FLOPs "
          f"{main['remat']['model_flops']:.4g} = {main['flops']['formula']}", flush=True)
    print(f"    losses {main['remat']['losses']} / {main['no_remat']['losses']}; step 0 "
          f"{main['step0_loss']!r} ({main['train_forward']}), blockwise "
          f"{main['blockwise_loss']!r}, kernel prefill {main['prefill_loss']!r} (limit "
          f"{main['prefill_loss_limit']:.3g}, {main['prefill_launches']} flash launches; "
          f"{main['train_step_launches']} in the train steps, whose attention calls were "
          f"{main['pair_launches']}); remat vs none {main['remat_vs_none']}; AdamW vs float64 "
          f"{main['adamw_vs_float64']}", flush=True)
    res["directional"] = directional_check(main_cfg, dev)
    print(f"  7a directional derivative (fp32, {res['directional']['layers']} layers): "
          f"{res['directional']}", flush=True)
    if not res["directional"]["ok"]:
        failures.append(f"directional derivative: {res['directional']}")
    res["runtime"] = train_runtime(runtime_cfg, dev, counters, failures)
    rt = res["runtime"]
    print(f"  7b {rt['name']} ({rt['params']} params) B={RUNTIME_BATCH} S={RUNTIME_SEQ}: steps "
          f"{rt['steps']}, {rt['restarts']} restart, replayed losses equal: "
          f"{rt['replayed_equal']}; save_s {rt['save_s']:.6f} (EC "
          f"{rt['save_ec_s'] / max(rt['save_s'], 1e-9):.4f}) over {len(rt['saves'])} saves "
          f"{[round(s['seconds'], 3) for s in rt['saves']]}, encode launches "
          f"{[s['encode_launches'] for s in rt['saves']]}; restore_s {rt['restore_s']:.6f} (EC "
          f"{rt['restore_ec_s'] / max(rt['restore_s'], 1e-9):.4f}), decode launches "
          f"{[r['decode_launches'] for r in rt['restores']]}, bitwise "
          f"{[r['bitwise'] for r in rt['restores']]}; step {rt['step_ms']:.3f} ms", flush=True)
    res["cuts"] = []
    for name, cfg in cuts.items():
        res["cuts"].append(train_cut_model(name, cfg, dev, failures))
        cut = res["cuts"][-1]
        print(f"  7c {name} ({cut['layers']} layers, {cut['params']} params) B=1 "
              f"S={CUT_TRAIN_SEQ}: step {cut['step_ms']:.3f} ms, losses {cut['losses']}, remat "
              f"vs none bitwise {cut['remat_vs_none']['bitwise']} (worst "
              f"{cut['remat_vs_none']['worst_rel_err']:.3g}, nondeterministic ops "
              f"{cut['remat_vs_none']['nondeterministic_ops']})", flush=True)
    for name, why in TRAIN_LEFT_OUT.items():
        print(f"  7c {name} left out: {why}", flush=True)
    res["left_out"] = TRAIN_LEFT_OUT
    res["launcher"] = train_launcher(dev, failures)
    print(f"  7d launch.train {' '.join(LAUNCHER_ARGS)}: {res['launcher']}", flush=True)
    torch.cuda.empty_cache()
    check(not failures, "phase 7 failed:\n  " + "\n  ".join(failures))
    return res


# -- phase 8: training and prefill on a device mesh ----------------------------------------

#: 8c: the host CPU's gloo world: its ranks, the smoke archs it trains, the
#: batch, and the optimizer's step count before the compared step (lr > 0)
MESH_WORLD = 4
MESH_ARCHS = ("yi-9b", "deepseek-v2-lite-16b", "zamba2-2.7b")
MESH_SHAPES = {"2x2": (2, 2), "4x1": (4, 1)}
MESH_BATCH, MESH_SEQ = 4, 64
MESH_START_STEP = 20
#: every product in fp32: the sharded step sums the same fp32 terms in
#: another order (the CPU tests read at most 6e-6 a leaf)
MESH_FP32 = 1e-5
#: an MoE layer's experts run bf16 einsums whatever the switch: a one-ulp
#: flip of an input moves their gradients by about 2e-3 (the CPU tests'
#: limit, test_torch_grads.BF16_GRAD)
MESH_MOE = 5e-2
#: 8b: the context-parallel split of the flash kernel: (case, B, S, H, Hkv,
#: D, Dv, dtype), q cut in CP_SPLIT row blocks
CP_SPLIT = 4
CP_CASES = [("yi-9b prefill_32k", 1, 32768, 32, 4, 128, 128, "bfloat16"),
            ("yi-9b fp32", 1, 4096, 32, 4, 128, 128, "float32")]
CP_RUNS = 5


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def mesh_cfg(name: str):
    """A smoke config for 8c: remat on, and an MoE capacity that drops
    nothing (per-rank routing then agrees with per-row routing)."""
    import dataclasses

    from repro_torch.configs import ARCHS

    cfg = dataclasses.replace(ARCHS[name].smoke, remat=True)
    return dataclasses.replace(cfg, capacity_factor=8.0) if cfg.moe_experts else cfg


def arch_shape(cfg, kind: str, b: int, s: int):
    """(ArchConfig, ShapeConfig) of one step of ``cfg`` at (b, s)."""
    from repro_torch.configs.base import ArchConfig, ShapeConfig

    return ArchConfig(model=cfg, smoke=cfg), ShapeConfig(f"{kind}_{b}x{s}", kind, s, b)


def opt_at(params, step: int) -> dict:
    """AdamW's zero moments for ``params`` (DTensors stay DTensors) at ``step``."""
    from repro_torch.optim.adamw import init_opt_state

    opt = init_opt_state(params)
    opt["step"] = opt["step"] + step
    return opt


def clone_tree(tree):
    from repro_torch.models.layers import tree_map

    return tree_map(lambda t: t.detach().clone(), tree)


def shard_errors(got_tree, want_tree, ctx) -> dict:
    """{path: [squared error, squared norm]} of the shards of ``got_tree``
    (DTensors) this rank holds the counted copy of, against ``want_tree``'s
    whole tensors cut the same way."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.parallel import sharding as sh

    wants = dict(sh.leaves_with_path(want_tree))
    specs = dict(sh.leaves_with_path(sh.param_specs(got_tree, ctx.mesh)))
    out = {}
    for path, got in sh.leaves_with_path(got_tree):
        if not ctx.owns(specs[path]):
            continue
        want = distribute_tensor(wants[path], got.device_mesh, got.placements,
                                 src_data_rank=None).to_local()
        g, w = got.to_local().double(), want.double()
        out[path] = [float((g - w).square().sum()), float(w.square().sum())]
    return out


def mesh_rank(rank: int, world: int, port: int, results) -> None:
    """One rank of 8c's gloo world (see the module's docstring)."""
    import datetime

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=300))
    try:
        with fp32_compute():
            out = {"steps": mesh_steps(), "prefill": mesh_prefill(),
                   "shrink": mesh_shrink(rank)}
        results.put((rank, out))
    finally:
        dist.destroy_process_group()


def mesh_steps() -> dict:
    """8c: each arch's sharded train step on each mesh against the one-device
    step on the same params and batch."""
    import torch

    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import steps
    from repro_torch.models import init_params
    from repro_torch.parallel import sharding as sh

    meshes = {key: mesh_mod.make_debug_mesh(*shape, device_type="cpu")
              for key, shape in MESH_SHAPES.items()}
    cpu = torch.device("cpu")
    out = {}
    for name in MESH_ARCHS:
        cfg = mesh_cfg(name)
        arch, shape = arch_shape(cfg, "train", MESH_BATCH, MESH_SEQ)
        params0 = init_params(cfg, seed=MODEL_SEED, device=cpu)
        batch = train_batch(cfg, cpu, np.random.default_rng(MODEL_SEED), MESH_BATCH, MESH_SEQ)
        want_p, want_o = clone_tree(params0), opt_at(params0, MESH_START_STEP)
        want_p, want_o, want_m = steps.make_train_step(arch, shape)(want_p, want_o, batch)
        for key, mesh in meshes.items():
            params = sh.distribute_tree(clone_tree(params0), mesh)
            got_p, got_o, got_m = steps.make_train_step(arch, shape, mesh)(
                params, opt_at(params, MESH_START_STEP), batch)
            resid, _, attn = steps.model_constraints(arch, shape, mesh)
            specs = sh.param_specs(got_p, mesh)
            out[f"{name} {key}"] = {
                "loss": [float(got_m["loss"]), float(want_m["loss"])],
                "grad_norm": [float(got_m["grad_norm"]), float(want_m["grad_norm"])],
                "placed": all(t.placements == sh.placements(spec, mesh)
                              for tree in (got_p, got_o["m"], got_o["v"])
                              for (_, t), (_, spec) in zip(sh.leaves_with_path(tree),
                                                           sh.leaves_with_path(specs))),
                "moe_ep": "moe_ep" in (attn or {}),
                "errors": {kind: shard_errors(got, want, resid.ctx) for kind, got, want in
                           (("params", got_p, want_p), ("m", got_o["m"], want_o["m"]),
                            ("v", got_o["v"], want_o["v"]))},
            }
    return out


def mesh_prefill() -> dict:
    """8c: the prefill on (1, 4): each rank a quarter of the sequence."""
    import torch

    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import steps
    from repro_torch.models import init_params
    from repro_torch.parallel import sharding as sh

    mesh = mesh_mod.make_debug_mesh(1, 4, device_type="cpu")
    cpu = torch.device("cpu")
    cfg = mesh_cfg(MAIN_ARCH)
    arch, shape = arch_shape(cfg, "prefill", 2, MESH_SEQ)
    params = init_params(cfg, seed=MODEL_SEED + 1, device=cpu)
    batch = model_batch(cfg, cpu, np.random.default_rng(MODEL_SEED + 1), 2, MESH_SEQ)
    want = steps.make_prefill_step(arch, shape)(params, batch)
    got = steps.make_prefill_step(arch, shape, mesh)(sh.distribute_tree(params, mesh), batch)
    return {"rel_err": float((got - want).norm() / want.norm()), "shape": list(got.shape)}


def mesh_shrink(rank: int) -> dict:
    """8c: a step on (2, 2), ``elastic.shrink`` to ranks 0 and 1, one more
    step; against the same state distributed afresh on the survivors."""
    import torch

    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import steps
    from repro_torch.models import init_params
    from repro_torch.models.layers import tree_leaves, tree_map
    from repro_torch.parallel import sharding as sh
    from repro_torch.runtime import elastic

    cpu = torch.device("cpu")
    cfg = mesh_cfg(MAIN_ARCH)
    arch, shape = arch_shape(cfg, "train", MESH_BATCH, MESH_SEQ)
    batch = train_batch(cfg, cpu, np.random.default_rng(MODEL_SEED + 2), MESH_BATCH, MESH_SEQ)
    mesh = mesh_mod.make_debug_mesh(2, 2, device_type="cpu")
    params = sh.distribute_tree(init_params(cfg, seed=MODEL_SEED + 2, device=cpu), mesh)
    params, opt, _ = steps.make_train_step(arch, shape, mesh)(
        params, opt_at(params, MESH_START_STEP), batch)
    state = {"params": params, "m": opt["m"], "v": opt["v"]}
    whole = tree_map(lambda t: t.full_tensor(), state)
    moved, small = elastic.shrink(state, mesh, {2, 3})
    if moved is None:
        return {"evicted": True}
    kept = all(torch.equal(a.full_tensor(), b) for a, b in
               zip(*(tree_leaves(t) for t in (moved, whole))))
    fresh = {key: sh.distribute_tree(clone_tree(whole[key]), small) for key in whole}
    step = steps.make_train_step(arch, shape, small)
    after = step(moved["params"], {"m": moved["m"], "v": moved["v"], "step": opt["step"]},
                 batch)
    again = step(fresh["params"], {"m": fresh["m"], "v": fresh["v"], "step": opt["step"]},
                 batch)
    equal = float(after[2]["loss"]) == float(again[2]["loss"]) and all(
        torch.equal(a.to_local(), b.to_local()) for a, b in
        zip(*(tree_leaves((x[0], x[1]["m"], x[1]["v"])) for x in (after, again))))
    return {"evicted": False, "mesh": dict(zip(small.mesh_dim_names, small.shape)),
            "kept": kept, "next_step_equal": equal}


def host_world(target, what: str) -> dict:
    """A gloo world of MESH_WORLD ranks on the host running ``target(rank,
    world, port, results)``; each rank's report by rank.  The ranks are
    spawned where this process has used the card (autograd's device threads
    do not survive a fork), and forked where it has not (a rehearsal on the
    CPU: each rank then starts from this process's modules as they stand)."""
    import multiprocessing

    import torch
    import torch.multiprocessing as tmp

    method = "spawn" if torch.cuda.is_initialized() else "fork"
    results = multiprocessing.get_context(method).SimpleQueue()
    procs = tmp.start_processes(target, args=(MESH_WORLD, free_port(), results),
                                nprocs=MESH_WORLD, join=False, start_method=method)
    ranks: dict = {}
    done = False
    while not done:
        done = procs.join(timeout=0.5)     # raises when a rank failed
        while not results.empty():
            rank, out = results.get()
            ranks[rank] = out
    check(len(ranks) == MESH_WORLD, f"{what}: {len(ranks)} of {MESH_WORLD} ranks reported")
    return ranks


def mesh_world(failures: list) -> dict:
    """8c: the gloo world on the host; the ranks' shard errors added up per
    leaf."""
    t0 = time.perf_counter()
    ranks = host_world(mesh_rank, "8c")
    res = {"seconds": time.perf_counter() - t0, "world": MESH_WORLD, "steps": {}}
    for case, first in ranks[0]["steps"].items():
        moe = case.split()[0] == "deepseek-v2-lite-16b"
        limit = MESH_MOE if moe else MESH_FP32
        worst = {}
        for kind in ("params", "m", "v"):
            total: dict = {}
            for r in ranks.values():
                for path, (err, norm) in r["steps"][case]["errors"][kind].items():
                    e, n = total.get(path, (0.0, 0.0))
                    total[path] = (e + err, n + norm)
            rel = {path: (e / n) ** 0.5 if n else e ** 0.5 for path, (e, n) in total.items()}
            path = max(rel, key=rel.get)
            worst[kind] = [path, rel[path]]
        (loss, loss_want), (gn, gn_want) = first["loss"], first["grad_norm"]
        row = {"loss": [loss, loss_want], "grad_norm": [gn, gn_want], "worst": worst,
               "limit": limit, "moe_ep": first["moe_ep"],
               "placed": all(r["steps"][case]["placed"] for r in ranks.values())}
        res["steps"][case] = row
        ok = (abs(loss - loss_want) <= MESH_FP32 * abs(loss_want)
              and abs(gn - gn_want) <= limit * gn_want and row["placed"]
              and all(err <= limit for _, err in worst.values())
              and (row["moe_ep"] or not moe))
        if not ok:
            failures.append(f"8c sharded train step {case}: {row}")
    res["prefill"] = ranks[0]["prefill"]
    if any(r["prefill"]["rel_err"] > MESH_FP32 for r in ranks.values()):
        failures.append(f"8c prefill on (1, 4): {[r['prefill'] for r in ranks.values()]}")
    res["shrink"] = {rank: r["shrink"] for rank, r in ranks.items()}
    survivors = [r["shrink"] for r in ranks.values() if not r["shrink"]["evicted"]]
    if len(survivors) != 2 or not all(s["kept"] and s["next_step_equal"] for s in survivors):
        failures.append(f"8c shrink 4 -> 2: {res['shrink']}")
    return res


def sharded_main_model(cfg, dev, counters, failures: list) -> dict:
    """8a: a one-rank world on this device and a (1, 1) mesh: phase 7a's
    model from the same params and moments, the sharded train step against
    the one-device step, and the sharded prefill against the one-device
    prefill, under deterministic algorithms, bit for bit."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import steps
    from repro_torch.models import init_params
    from repro_torch.models.layers import tree_leaves, tree_map, tree_unflatten
    from repro_torch.parallel import sharding as sh

    backend = "nccl" if dev.type == "cuda" else "gloo"
    extra = {}
    if dev.type == "cuda":     # the communicator is built for this card at once
        extra["device_id"] = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0, **extra)
    try:
        mesh = mesh_mod.make_debug_mesh(1, 1, device_type=dev.type)
        arch, shape = arch_shape(cfg, "train", TRAIN_BATCH, TRAIN_SEQ)
        rng = np.random.default_rng(MODEL_SEED + 1)
        batch = train_batch(cfg, dev, rng, TRAIN_BATCH, TRAIN_SEQ)
        params = init_params(cfg, seed=MODEL_SEED, device=dev)
        host = [t.to("cpu", copy=True) for t in tree_leaves(params)]
        res = {"name": cfg.name, "layers": cfg.n_layers, "batch": [TRAIN_BATCH, TRAIN_SEQ],
               "mesh": [1, 1], "backend": backend}
        # the prefill first, on both (no gradient: the flash kernel)
        prefill_arch, prefill_shape = arch_shape(cfg, "prefill", TRAIN_BATCH, TRAIN_SEQ)
        tokens = {"tokens": batch["tokens"]}
        want_logits = steps.make_prefill_step(prefill_arch, prefill_shape)(params, tokens)
        flash = counters["flash_attention_fwd"]
        before = flash.launches
        sharded = sh.distribute_tree(params, mesh)
        got_logits = steps.make_prefill_step(prefill_arch, prefill_shape, mesh)(sharded, tokens)
        res["prefill_launches"] = flash.launches - before
        res["prefill_bitwise"] = bool(torch.equal(got_logits, want_logits))
        del sharded, got_logits, want_logits
        # the train step, one-device then sharded, from the same start
        step, times = steps.make_train_step(arch, shape), {}
        opt = opt_at(params, MESH_START_STEP)
        with deterministic() as ops_one:
            params, opt, metrics = step(params, opt, batch)
        want = (params, opt, {k: v.clone() for k, v in metrics.items()})
        fresh = [t.to(dev) for t in host]
        del host
        sparams = sh.distribute_tree(tree_unflatten(params, fresh), mesh)
        del fresh
        sopt = opt_at(sparams, MESH_START_STEP)
        sstep = steps.make_train_step(arch, shape, mesh)
        adamw = counters["adamw_step"]
        before = adamw.launches
        with deterministic() as ops_mesh:
            sparams, sopt, smetrics = sstep(sparams, sopt, batch)
        res["adamw_launches"] = adamw.launches - before
        pairs = list(zip(tree_leaves((sparams, sopt["m"], sopt["v"])),
                         tree_leaves((want[0], want[1]["m"], want[1]["v"])), strict=True))
        res["bitwise"] = (all(torch.equal(a.to_local(), b) for a, b in pairs)
                          and all(torch.equal(smetrics[k], want[2][k])
                                  for k in ("loss", "grad_norm", "lr")))
        res["loss"] = [float(smetrics["loss"]), float(want[2]["loss"])]
        res["nondeterministic_ops"] = sorted(set(ops_one) | set(ops_mesh))
        if not res["bitwise"]:
            res["worst_rel_err"] = max(
                float((a.to_local().double() - b.double()).norm()
                      / b.double().norm().clamp_min(1e-30)) for a, b in pairs)
        del pairs, want
        # timed: the one-device step and the sharded one, in turns
        one = (tree_map(lambda t: t.to_local(), sparams),
               {"m": tree_map(lambda t: t.to_local(), sopt["m"]),
                "v": tree_map(lambda t: t.to_local(), sopt["v"]), "step": sopt["step"]})
        for key, fn, state in (("one_device", step, one), ("mesh", sstep, (sparams, sopt))):
            times[key] = []
            p, o = state
            for _ in range(1 + TRAIN_TIMED_STEPS):
                start = time.perf_counter()
                p, o, _ = fn(p, o, batch)
                torch.cuda.synchronize()
                times[key].append((time.perf_counter() - start) * 1e3)
            res[f"{key}_step_ms"] = statistics.median(times[key][1:])
        res["step_ms"] = times
    finally:
        dist.destroy_process_group()
    if not res["prefill_bitwise"] or res["prefill_launches"] != cfg.n_layers:
        failures.append(f"8a sharded prefill: bitwise {res['prefill_bitwise']}, "
                        f"{res['prefill_launches']} flash launches for {cfg.n_layers} layers")
    if not res["bitwise"]:
        failures.append(f"8a sharded train step on (1, 1) differs from the one-device step: "
                        f"{res}")
    if not res["adamw_launches"]:
        failures.append("8a sharded train step: AdamW's update did not go through its kernel")
    return res


def context_parallel_flash(dev, gen, case, flash, failures: list) -> dict:
    """8b: one attention of ``case`` as CP_SPLIT ranks of a context-parallel
    prefill launch it (q row block r at offset r * S / CP_SPLIT against the
    whole K/V; counted), then held against the unsplit launch, bit for
    bit, and each block against its plain version with ``q_offset``."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    name, b, s, h, hkv, d, dv, dtype = case
    dt = getattr(torch, dtype)

    def draw(shape):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    q, k, v = draw((b, s, h, d)), draw((b, s, hkv, d)), draw((b, s, hkv, dv))
    rows = s // CP_SPLIT
    blocks = [(q[:, r * rows:(r + 1) * rows], r * rows) for r in range(CP_SPLIT)]
    before = (flash.launches, flash.offset_launches)
    parts = [fa.flash_attention_fwd(qb, k, v, True, off) for qb, off in blocks]
    path = (flash.launches - before[0], flash.offset_launches - before[1])
    # the comparisons (their launches are not the path's)
    whole = fa.flash_attention_fwd(q, k, v, True)
    bitwise = bool(torch.equal(torch.cat(parts, dim=1), whole))
    tol = SAME_ARITHMETIC[dtype]
    closes = [closeness(part, fa.flash_attention_fwd_plain(qb, k, v, True, off)[0], tol)
              for part, (qb, off) in zip(parts, blocks)]
    del whole
    last, off = blocks[-1]
    pairs = b * h * sum(off + i + 1 for i in range(rows))
    flops = 2 * pairs * (d + dv)
    nbytes = q.element_size() * b * (rows * h * d + s * hkv * (d + dv) + rows * h * dv)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
    # the yardstick: one PyTorch call with the offset causal mask, the K/V
    # heads repeated (a boolean mask and grouped heads together would leave
    # it the math kernel's (B, H, Sq, Skv) scores)
    qt, kt, vt = (x.transpose(1, 2) for x in (last, k.repeat_interleave(h // hkv, dim=2),
                                               v.repeat_interleave(h // hkv, dim=2)))
    mask = (torch.arange(s, device=dev)[None, :]
            <= off + torch.arange(rows, device=dev)[:, None])

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

    res = {"case": name, "dtype": dtype, "split": CP_SPLIT, "offsets": [o for _, o in blocks],
           "launches": path[0], "offset_launches": path[1],
           "shape": f"q {(b, rows, h, d)} at offset {off}, k {(b, s, hkv, d)}",
           "bitwise_vs_unsplit": bitwise,
           "max_abs_err": max(c[0] for c in closes),
           "tolerance_share": max(c[1] for c in closes),
           "rel_rms_err": max(c[2] for c in closes), "tolerance": tol,
           "ms": median_ms(lambda: fa.flash_attention_fwd(last, k, v, True, off), CP_RUNS),
           "plain_ms": median_ms(lambda: fa.flash_attention_fwd_plain(last, k, v, True, off)[0],
                                 1),
           "bound_ms": max(t_ops, t_bytes) * 1e3,
           "bound_by": "operations" if t_ops >= t_bytes else "bytes", "flops": flops,
           "bytes": nbytes}
    try:
        lib_out = library()
    except RuntimeError as exc:
        res["library_ms"] = None
        res["library_note"] = f"scaled_dot_product_attention refused: {str(exc)[:160]}"
    else:
        res["library_max_abs_err"] = float((lib_out.transpose(1, 2).float()
                                            - parts[-1].float()).abs().max())
        del lib_out
        res["library_ms"] = median_ms(library, CP_RUNS)
    if not bitwise or res["tolerance_share"] > 1.0 or res["rel_rms_err"] > tol["rel_rms"]:
        failures.append(f"8b flash with q_offset {name}: {res}")
    del q, k, v, parts, blocks, last, qt, kt, vt, mask
    return res


def drive_mesh(dev, counters) -> dict:
    """Phase 8 (see the module's docstring): 8c on the host first (its
    ranks are forked before this process joins a process group), then 8a
    and 8b on the card; fails after the last if any check failed."""
    import torch

    failures: list[str] = []
    res = {"world": mesh_world(failures)}
    for case, row in res["world"]["steps"].items():
        print(f"  8c {case}: loss {row['loss']}, grad norm {row['grad_norm']}, worst leaf "
              f"{row['worst']} (limit {row['limit']}), placed {row['placed']}, moe_ep "
              f"{row['moe_ep']}", flush=True)
    print(f"  8c prefill (1, 4): {res['world']['prefill']}; shrink 4 -> 2: "
          f"{res['world']['shrink']}; {res['world']['seconds']:.1f} s", flush=True)
    main_cfg, _, _ = training_configs()
    res["main"] = sharded_main_model(main_cfg, dev, counters, failures)
    main = res["main"]
    print(f"  8a {main['name']} ({main['layers']} layers) on a (1, 1) {main['backend']} mesh, "
          f"B={TRAIN_BATCH} S={TRAIN_SEQ}: train step bit for bit {main['bitwise']} (loss "
          f"{main['loss']}), step {main['mesh_step_ms']:.3f} ms sharded, "
          f"{main['one_device_step_ms']:.3f} ms one-device; prefill bit for bit "
          f"{main['prefill_bitwise']} ({main['prefill_launches']} flash launches); AdamW "
          f"kernel launches {main['adamw_launches']}; "
          f"nondeterministic ops {main['nondeterministic_ops']}", flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 8)
    flash = counters["flash_attention_fwd"]
    res["context_parallel"] = [context_parallel_flash(dev, gen, case, flash, failures)
                               for case in CP_CASES]
    # the path's launches: 8a's sharded prefill and 8b's splits (not the
    # launches that they are compared with)
    res["launches"] = main["prefill_launches"] + sum(
        row["launches"] for row in res["context_parallel"])
    res["offset_launches"] = sum(row["offset_launches"] for row in res["context_parallel"])
    for row in res["context_parallel"]:
        lib = "refused" if row["library_ms"] is None else f"{row['library_ms']:.3f} ms"
        print(f"  8b flash {row['case']} {row['dtype']} split {row['split']} at "
              f"{row['offsets']}: joined = unsplit bit for bit {row['bitwise_vs_unsplit']}; "
              f"vs plain max |err| {row['max_abs_err']:.3g} ({row['tolerance_share']:.3g} of "
              f"the allowance), relative RMS {row['rel_rms_err']:.3g}; last block "
              f"{row['shape']}: {row['ms']:.3f} ms (plain {row['plain_ms']:.3f} ms, bound "
              f"{row['bound_ms']:.3f} ms by {row['bound_by']}, library {lib})", flush=True)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    check(not failures, "phase 8 failed:\n  " + "\n  ".join(failures))
    return res


# -- phase 9: decode on a device mesh, the dry-run and the roofline ------------------------

#: 9a: the host CPU's gloo world decodes every cache layout (GQA, MLA with MoE
#: layers, Mamba2 with the shared block, xLSTM, whisper's self and cross
#: caches) at smoke widths on these meshes, every product in fp32
DECODE_MESH_ARCHS = ("yi-9b", "deepseek-v2-lite-16b", "zamba2-2.7b", "xlstm-125m",
                     "whisper-base")
DECODE_MESH_SHAPES = {"2x2": (2, 2), "1x4": (1, 4)}
#: B and Smax (a cache dim the rules take for the batch must be the batch:
#: zamba2's smoke cache has 2 groups of 2 layers); four steps after a prompt
#: of MESH_DECODE_LENS[0] tokens, the last at cur_len = Smax (the clamped write)
MESH_DECODE_BATCH, MESH_DECODE_MAX_LEN = 4, 12
MESH_DECODE_LENS = (9, 10, 11, 12)
#: deepseek-v2's decode rounds to bf16 whatever the switch (MLA's absorbed
#: attention casts its softmax weights and latent output, the MoE experts
#: run bf16 einsums, as in the reference): scores summed in another order
#: can flip one weight's rounding by one bf16 ulp, which moves a row's output
#: by at most that fraction (read 2.5e-4 on the CPU); the others MESH_FP32
MESH_DECODE_BF16 = {"deepseek-v2-lite-16b": 2 ** -8}
#: 9b: yi-9b whole at phase 6's decode (B=4 over 128 rows, a prompt's rows
#: drawn from a seeded normal): steps timed on one device and on a (1, 1) mesh
SHARDED_DECODE_STEPS = 8
#: 9c: the dry-run's cells, yi-9b on the production (16, 16) mesh, each in a
#: process of its own (a fake world is process-global)
DRYRUN_CELLS = ("decode_32k", "train_4k")
DRYRUN_TIMEOUT = 300
#: the witness of the sharded decode (``tools/sharding_on_cards.py`` part
#: (f); 9b reads its one-card controls): yi-9b whole at B=8 over 4096 rows,
#: four steps, the last at cur_len = Smax (the clamped write), from a cache
#: drawn from a normal seeded by MODEL_SEED + 6, on part (f)'s meshes
WITNESS_BATCH, WITNESS_SEQ = 8, 4096
WITNESS_LENS = (4093, 4094, 4095, 4096)
WITNESS_MESHES = {"4x1": (4, 1), "2x2": (2, 2)}
#: part (f)'s tokens: one generator a purpose and a mesh, seeded from
#: MODEL_SEED, the purpose's offset and the mesh's shape, so what one mesh
#: decodes depends on no other draw
TOKEN_PURPOSES = {"timed": 1, "witness": 2}


def seeded_decode_cache(cfg, dev, b: int, smax: int, prompt: int, seed: int):
    """A decode cache of (b, smax) rows, its first ``prompt`` rows filled by
    the one-device decode of seeded tokens (whisper's cross K/V, which a
    prefill fills, drawn from a seeded normal, its encoder length smax - 2)."""
    import torch

    from repro_torch.models import decode_step, init_cache, init_params

    rng = np.random.default_rng(seed)
    cache = init_cache(cfg, b, smax, device=dev)
    if cfg.family == "encdec":
        for key in ("k", "v"):
            leaf = cache["cross"][key]
            leaf.copy_(torch.from_numpy(rng.standard_normal(tuple(leaf.shape)).astype(
                np.float32)))
        cache["enc_len"].fill_(smax - 2)
    params = init_params(cfg, seed=MODEL_SEED, device=dev)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (b, prompt))).to(dev)
    for t in range(prompt):
        decode_step(params, cfg, cache, {"tokens": tokens[:, t:t + 1], "cur_len": t})
    return cache


def decode_steps(step, params, cache, tokens, lens) -> list:
    """``step`` at each position of ``lens`` (the cache written in place)."""
    return [step(params, cache, {"tokens": tokens[:, i:i + 1], "cur_len": t})[0]
            for i, t in enumerate(lens)]


def rel_rms(got, want) -> float:
    g, w = got.double(), want.double()
    norm = float(w.norm())
    return float((g - w).norm()) / norm if norm else float((g - w).norm())


def token_rng(purpose: str, shape: tuple[int, int]) -> np.random.Generator:
    """The generator of one purpose's tokens (``TOKEN_PURPOSES``) on the mesh
    of ``shape``."""
    return np.random.default_rng([MODEL_SEED, TOKEN_PURPOSES[purpose], *shape])


def witness_tokens(cfg, shape: tuple[int, int]) -> np.ndarray:
    """The witness's tokens on the mesh of ``shape``, (WITNESS_BATCH, steps):
    drawn once, for every decode that witnesses that mesh."""
    return token_rng("witness", shape).integers(0, cfg.vocab,
                                                (WITNESS_BATCH, len(WITNESS_LENS)))


def witness_cache(cfg, dev):
    """The witness's whole cache in ``init_cache``'s dtype, k and v drawn
    from a normal seeded by MODEL_SEED + 6, a layer at a time."""
    import torch

    from repro_torch.models import init_cache

    gen = torch.Generator(device=dev)
    gen.manual_seed(MODEL_SEED + 6)
    whole = init_cache(cfg, WITNESS_BATCH, WITNESS_SEQ, device=dev)
    for leaf in (whole["scan"]["k"], whole["scan"]["v"]):
        for i in range(leaf.shape[0]):
            leaf[i].copy_(torch.randn(leaf[i].shape, generator=gen, device=dev))
    return whole


@contextlib.contextmanager
def split_head_vector(parts: int):
    """Every decode attention on one device computed as a mesh whose model
    axis has ``parts`` ranks computes it: the scores as ``parts`` slices of
    the head vector, each its own product in fp32, added in rank order (a
    2-rank all-reduce adds the same two terms), the output a slice of the
    value vector at a time, joined."""
    import torch

    from repro_torch.models import attention

    saved = attention._grouped_attend

    def split(qg, cache_k, cache_v, valid, sp=None, split=None):
        ks = [k.contiguous() for k in cache_k.chunk(parts, -1)]      # as a rank's shard
        vs = [v.contiguous() for v in cache_v.chunk(parts, -1)]
        partial = [torch.einsum("bqgrd,bkgd->bgrqk", q.float(), k.float())
                   for q, k in zip(qg.chunk(parts, -1), ks)]
        scores = partial[0]
        for more in partial[1:]:
            scores = scores + more
        scores = scores.masked_fill(~valid, attention.NEG_INF)
        w = torch.softmax(scores, dim=-1).to(cache_v.dtype)
        return torch.cat([torch.einsum("bgrqk,bkgd->bqgrd", w.float(), v.float()).to(v.dtype)
                          for v in vs], dim=-1)

    attention._grouped_attend = split
    try:
        yield
    finally:
        attention._grouped_attend = saved


def witness_decode(params, cfg, dev, tokens: np.ndarray, parts: int = 1,
                   head_parts: int = 1) -> list:
    """The witness's decode on one device, its cache drawn anew: each step's
    logits on ``tokens``, the batch decoded as ``parts`` blocks of rows,
    each alone, joined (as ``parts`` data ranks split it; a dense model's
    cache holds the batch on dim 1), each attention's head vector in
    ``head_parts`` slices (``split_head_vector``)."""
    import torch

    from repro_torch.launch import steps
    from repro_torch.models.layers import tree_map

    whole = witness_cache(cfg, dev)
    rows = WITNESS_BATCH // parts
    arch, cell = arch_shape(cfg, "decode", rows, WITNESS_SEQ)
    step = steps.make_serve_step(arch, cell)
    toks = torch.from_numpy(tokens).to(dev)
    blocks = []
    with split_head_vector(head_parts) if head_parts > 1 else contextlib.nullcontext():
        for j in range(parts):
            block = slice(j * rows, (j + 1) * rows)
            cache = whole if parts == 1 else tree_map(lambda t: t[:, block].clone(), whole)
            blocks.append(decode_steps(step, params, cache, toks[block], WITNESS_LENS))
            del cache
    del whole
    return [torch.cat(logits, 0) for logits in zip(*blocks)]


def witness_controls(params, cfg, dev, tokens: np.ndarray, shape: tuple[int, int]) -> dict:
    """The one-device controls of the witness on the mesh of ``shape``
    (data, model), each step's logits: the batch split as its data ranks
    split it (``batch_split``) and, where its model axis splits the head
    vector, the scores split as well (``score_split``)."""
    data, model = shape
    out = {"batch_split": witness_decode(params, cfg, dev, tokens, data)}
    if model > 1:
        out["score_split"] = witness_decode(params, cfg, dev, tokens, data, model)
    return out


def distances(gots: list, wants: list, tol: dict) -> dict:
    """Step by step closeness of ``gots`` to ``wants`` under ``tol``: the
    largest |error| and share of the allowance, each step's relative RMS."""
    closes = [closeness(g, w, tol) for g, w in zip(gots, wants)]
    return {"max_abs_err": max(c[0] for c in closes),
            "tolerance_share": max(c[1] for c in closes),
            "rel_rms_err": [c[2] for c in closes]}


def witness_floor(params, cfg, dev) -> dict:
    """9b: how far the one-device controls of each of part (f)'s meshes move
    the witness's logits from its whole-batch decode, on that mesh's
    tokens (``WHOLE_MODEL``'s shares)."""
    out = {}
    for key, shape in WITNESS_MESHES.items():
        tokens = witness_tokens(cfg, shape)
        want = witness_decode(params, cfg, dev, tokens)
        out[key] = {name: distances(got, want, WHOLE_MODEL) for name, got in
                    witness_controls(params, cfg, dev, tokens, shape).items()}
    return out


def mesh_decode_cases() -> dict:
    """9a: each family's serve step on each mesh against the one-device step
    from the same params, cache and tokens: the logits of every step and
    every cache leaf after the last, gathered whole (a family that raises
    reports its error)."""
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import steps
    from repro_torch.models import init_params
    from repro_torch.parallel import sharding as sh

    meshes = {key: mesh_mod.make_debug_mesh(*shape, device_type="cpu")
              for key, shape in DECODE_MESH_SHAPES.items()}
    cpu = torch.device("cpu")
    b, smax, lens = MESH_DECODE_BATCH, MESH_DECODE_MAX_LEN, MESH_DECODE_LENS
    out = {}
    for name in DECODE_MESH_ARCHS:
        try:
            cfg = ARCHS[name].smoke
            arch, shape = arch_shape(cfg, "decode", b, smax)
            params = init_params(cfg, seed=MODEL_SEED + 4, device=cpu)
            cache0 = seeded_decode_cache(cfg, cpu, b, smax, lens[0], MODEL_SEED + 5)
            tokens = torch.from_numpy(np.random.default_rng(MODEL_SEED + 6).integers(
                0, cfg.vocab, (b, len(lens))))
            want_cache = clone_tree(cache0)
            wants = decode_steps(steps.make_serve_step(arch, shape), params, want_cache,
                                 tokens, lens)
            want_leaves = dict(sh.leaves_with_path(want_cache))
            for key, mesh in meshes.items():
                specs = sh.cache_specs(cache0, mesh, smax, b)
                cache = sh.distribute_tree(clone_tree(cache0), mesh, specs)
                gots = decode_steps(steps.make_serve_step(arch, shape, mesh),
                                    sh.distribute_tree(params, mesh), cache, tokens, lens)
                leaves = {path: rel_rms(t.full_tensor() if t.dim() else t, want_leaves[path])
                          for path, t in sh.leaves_with_path(cache)}
                worst = max(leaves, key=leaves.get)
                out[f"{name} {key}"] = {"logits": max(rel_rms(g, w) for g, w in zip(gots, wants)),
                                        "cache": [worst, leaves[worst]]}
        except Exception as exc:  # reported, and the phase fails
            out[name] = {"error": repr(exc)[:400]}
    return out


def decode_rank(rank: int, world: int, port: int, results) -> None:
    """One rank of 9a's gloo world."""
    import datetime

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=120))
    try:
        with fp32_compute():
            results.put((rank, mesh_decode_cases()))
    finally:
        dist.destroy_process_group()


def decode_world(failures: list) -> dict:
    """9a: the gloo world on the host; each rank's cases against their limits."""
    t0 = time.perf_counter()
    ranks = host_world(decode_rank, "9a")
    res = {"seconds": time.perf_counter() - t0, "world": MESH_WORLD, "cases": ranks[0]}
    for rank, cases in ranks.items():
        for case, row in cases.items():
            limit = MESH_DECODE_BF16.get(case.split()[0], MESH_FP32)
            if "error" in row or row["logits"] > limit or row["cache"][1] > limit:
                failures.append(f"9a sharded decode {case} (rank {rank}): {row}, limit {limit}")
    return res


def sharded_decode_main(dev, failures: list) -> dict:
    """9b: a one-rank world on this device and a (1, 1) mesh: yi-9b whole at
    phase 6's decode, the sharded serve step against the one-device step
    from the same params and cache, under deterministic algorithms, bit for
    bit (the logits of every step, every cache leaf); both ms a step."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import steps
    from repro_torch.models import init_cache, init_params
    from repro_torch.models.layers import tree_leaves
    from repro_torch.parallel import sharding as sh

    cfg = model_configs()[MAIN_ARCH]
    backend = "nccl" if dev.type == "cuda" else "gloo"
    extra = {"device_id": torch.device("cuda", torch.cuda.current_device())} \
        if dev.type == "cuda" else {}
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0, **extra)
    try:
        mesh = mesh_mod.make_debug_mesh(1, 1, device_type=dev.type)
        arch, shape = arch_shape(cfg, "decode", DECODE_BATCH, DECODE_MAX_LEN)
        params = init_params(cfg, seed=MODEL_SEED, device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED + 9)
        cache0 = init_cache(cfg, DECODE_BATCH, DECODE_MAX_LEN, device=dev)
        for leaf in tree_leaves(cache0):       # the prompt's rows, seeded
            leaf[:, :, :DECODE_PROMPT].copy_(torch.randn(
                leaf[:, :, :DECODE_PROMPT].shape, generator=gen, device=dev))
        lens = range(DECODE_PROMPT, DECODE_PROMPT + SHARDED_DECODE_STEPS)
        tokens = torch.from_numpy(np.random.default_rng(MODEL_SEED + 9).integers(
            0, cfg.vocab, (DECODE_BATCH, len(lens)))).to(dev)
        # on one rank a shard is the whole tensor: the same 35 GB of params
        # serve both runs (distribute_tensor would copy every split leaf)
        placed = sh.spec_map(lambda t, spec: DTensor.from_local(
            t, mesh, sh.placements(spec, mesh), run_check=False), params,
            sh.param_specs(params, mesh))
        runs = {"one_device": (steps.make_serve_step(arch, shape), params, clone_tree(cache0)),
                "mesh": (steps.make_serve_step(arch, shape, mesh), placed,
                         sh.distribute_tree(clone_tree(cache0), mesh,
                                            sh.cache_specs(cache0, mesh, DECODE_MAX_LEN,
                                                           DECODE_BATCH)))}
        out, times, nondeterministic = {}, {}, set()
        for key, (step, p, cache) in runs.items():
            times[key] = []
            logits = []
            with deterministic() as ops:
                for i, t in enumerate(lens):
                    start = time.perf_counter()
                    logits.append(step(p, cache, {"tokens": tokens[:, i:i + 1], "cur_len": t})[0])
                    if dev.type == "cuda":
                        torch.cuda.synchronize()
                    times[key].append((time.perf_counter() - start) * 1e3)
            nondeterministic |= set(ops)
            out[key] = (logits, [t.to_local() if hasattr(t, "to_local") else t
                                 for t in tree_leaves(cache)])
        (want, want_cache), (got, got_cache) = out["one_device"], out["mesh"]
        res = {"name": cfg.name, "layers": cfg.n_layers, "mesh": [1, 1], "backend": backend,
               "batch": [DECODE_BATCH, DECODE_MAX_LEN], "steps": len(lens),
               "logits_bitwise": all(torch.equal(g, w) for g, w in zip(got, want)),
               "cache_bitwise": all(torch.equal(g, w) for g, w in zip(got_cache, want_cache)),
               "step_ms": times, "nondeterministic_ops": sorted(nondeterministic),
               "finite": all(bool(torch.isfinite(g).all()) for g in got)}
        for key in runs:
            res[f"{key}_step_ms"] = statistics.median(times[key][1:])
        del runs, out, placed, cache0
        # numbers only, on a decode whose checks held: the bf16 floor of
        # part (f)'s witness on one device
        if not failures and res["logits_bitwise"] and res["cache_bitwise"]:
            res["witness_floor"] = witness_floor(params, cfg, dev)
        del params
    finally:
        dist.destroy_process_group()
    if not (res["logits_bitwise"] and res["cache_bitwise"] and res["finite"]):
        failures.append(f"9b sharded decode on (1, 1) differs from the one-device decode: {res}")
    return res


def start_dryrun() -> tuple[list, str]:
    """9c: one dry-run process a cell of DRYRUN_CELLS, all started at once."""
    import tempfile

    out_dir = tempfile.mkdtemp(prefix="dryrun_torch_")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), REPRO_TORCH_DRYRUN_DIR=out_dir)
    procs = [subprocess.Popen([sys.executable, "-W", "ignore", "-m", "repro_torch.launch.dryrun",
                               "--arch", MAIN_ARCH, "--shape", shape], env=env, cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for shape in DRYRUN_CELLS]
    return procs, out_dir


def finish_dryrun(procs: list, out_dir: str, failures: list) -> list[dict]:
    """9c: each dry-run process's cell line and its JSON; a cell that failed
    or did not finish within DRYRUN_TIMEOUT fails the phase (and its process
    is ended)."""
    rows = []
    for shape, proc in zip(DRYRUN_CELLS, procs):
        try:
            text, _ = proc.communicate(timeout=DRYRUN_TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            text, _ = proc.communicate()
            text += f"\n(ended after {DRYRUN_TIMEOUT} s)"
        lines = [line for line in text.splitlines() if line.startswith("[")]
        for line in lines:
            print(f"  9c {line}", flush=True)
        path = Path(out_dir) / f"{MAIN_ARCH}__{shape}__pod16x16.json"
        if proc.returncode != 0 or "ALL DRY-RUN CELLS PASSED" not in text or not path.exists():
            failures.append(f"9c dry-run {MAIN_ARCH} x {shape}: rc {proc.returncode}, "
                            f"{text[-1500:]}")
            continue
        rows.append(json.loads(path.read_text()))
    return rows


def drive_decode_mesh(dev) -> dict:
    """Phase 9 (see the module's docstring): 9c's processes first, then 9a on
    the host and 9b on the card while they run; fails after the last if any
    check failed."""
    import torch

    failures: list[str] = []
    procs, out_dir = start_dryrun()
    try:
        res = {"world": decode_world(failures)}
        for case, row in res["world"]["cases"].items():
            print(f"  9a {case}: {row}", flush=True)
        print(f"  9a: {res['world']['seconds']:.1f} s, limit {MESH_FP32} relative RMS "
              f"({MESH_DECODE_BF16} rounded in bf16)", flush=True)
        res["main"] = main = sharded_decode_main(dev, failures)
        print(f"  9b {main['name']} ({main['layers']} layers) decode on a (1, 1) "
              f"{main['backend']} mesh, B={DECODE_BATCH} over {DECODE_MAX_LEN} rows: bit for "
              f"bit logits {main['logits_bitwise']}, cache {main['cache_bitwise']}; step "
              f"{main['mesh_step_ms']:.3f} ms sharded, {main['one_device_step_ms']:.3f} ms "
              f"one-device; nondeterministic ops {main['nondeterministic_ops']}", flush=True)
        for key, controls in main.get("witness_floor", {}).items():
            print(f"  9b bf16 floor of tools/sharding_on_cards.py part (f)'s witness on {key} "
                  f"(one device, B={WITNESS_BATCH} over {WITNESS_SEQ} rows, "
                  f"{len(WITNESS_LENS)} steps), each step's relative RMS against the whole "
                  f"batch: " + "; ".join(f"{name} {row['rel_rms_err']}"
                                         for name, row in controls.items()), flush=True)
        res["dryrun"] = finish_dryrun(procs, out_dir, failures)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    check(not failures, "phase 9 failed:\n  " + "\n  ".join(failures))
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
    from repro_torch.kernels import adamw as ka
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gf256_encode as ge
    from repro_torch.kernels import xor_reduce as xr

    # phase 7 runs with deterministic algorithms, which need cuBLAS's
    # workspace fixed before its first use
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}", flush=True)
    seconds = {}
    t0 = time.perf_counter()
    per_source = _build.build()
    print(f"phase 1: built {sorted(per_source)} in {time.perf_counter() - t0:.2f} s "
          f"({', '.join(f'{k} {v:.2f} s' for k, v in per_source.items())})", flush=True)
    flash_build = inspect_flash_build()
    gf_build = inspect_gf_build()
    seconds["1"] = time.perf_counter() - t0

    def phase(name: str, title: str):
        seconds[name] = time.perf_counter()
        print(f"phase {name}: {title}", flush=True)

    def phase_done(name: str):
        seconds[name] = time.perf_counter() - seconds[name]
        print(f"  phase {name}: {seconds[name]:.1f} s", flush=True)

    phase("2", "kernels against their plain versions")
    dataplane_rows, _ = check_kernels(dev)
    copy = copy_rate(dev)
    torch.cuda.empty_cache()
    attention_rows = check_attention_kernels(dev)
    attention_rows[0]["hgmma"] = sum(flash_build["hgmma"].values())
    attention_rows[0]["nvcc_s"] = per_source.get("flash_attention")
    pair_rows = check_pair_kernels(dev) + check_pair_kernels(dev, MLA_PAIR_CASE)
    pair_rows[1]["nvcc_s"] = per_source.get("flash_attention_bwd")
    pair_rows[1]["ptxas"] = inspect_pair_build()
    torch.cuda.empty_cache()
    adamw_rows = check_adamw_kernels(dev)
    adamw_rows[0]["nvcc_s"] = per_source.get("adamw")
    adamw_rows[0]["ptxas"] = ptxas_usage("adamw")
    phase_done("2")

    counters = {fn.__name__: fn
                for fn in (*ge.KERNELS, *xr.KERNELS, *fa.KERNELS, *ka.KERNELS)}
    phase("3", "data-plane main path")
    for fn in counters.values():
        fn.launches = 0
    drive_entry_points(dev)
    cluster = drive_cluster(dev, counters)
    torch.cuda.synchronize()
    count_launches(dataplane_rows, counters, "data-plane")
    torch.cuda.empty_cache()
    phase_done("3")

    phase("4", "attention main path")
    for fn in counters.values():
        fn.launches = 0
    attention = drive_attention_path(dev)
    torch.cuda.synchronize()
    count_launches(attention_rows, counters, "attention")
    torch.cuda.empty_cache()
    phase_done("4")

    phase("5", "checkpoint path")
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
    torch.cuda.empty_cache()
    phase_done("5")

    phase("6", "model serving path")
    for fn in counters.values():
        fn.launches = 0
    models = drive_models(dev, counters)
    torch.cuda.synchronize()
    flash_row = attention_rows[0]
    flash_row["model_launches"] = counters[flash_row["name"]].launches
    check(flash_row["model_launches"] > 0,
          f"{flash_row['name']} was not launched on the model serving path")
    print(f"  launches on the model serving path: "
          f"{ {flash_row['name']: flash_row['model_launches']} }", flush=True)
    main_model = next(m for m in models if m["name"] == MAIN_ARCH)
    serve = main_model["serve"]
    print(f"  {MAIN_ARCH} on {card}: prefill {main_model['prefill_ms']:.3f} ms "
          f"(B={main_model['prefill'][0]}, S={main_model['prefill'][1]}), decode "
          f"{main_model['decode_step_ms']:.3f} ms a step (B={main_model['decode_batch'][0]}), "
          f"serving {serve['steps']} steps, {serve['tokens_per_s']:.1f} tokens/s", flush=True)
    phase_done("6")

    phase("7", "training runtime")
    for fn in counters.values():
        fn.launches = 0
    training = drive_training(dev, counters)
    torch.cuda.synchronize()
    matmul_row["training_launches"] = counters[matmul_row["name"]].launches
    matmul_row["training_encode_launches"] = sum(
        s["encode_launches"] for s in training["runtime"]["saves"])
    matmul_row["training_decode_launches"] = sum(
        r["decode_launches"] for r in training["runtime"]["restores"])
    check(matmul_row["training_launches"] > 0,
          f"{matmul_row['name']} was not launched on the training path")
    flash_row["training_launches"] = counters[flash_row["name"]].launches
    flash_row["train_step_launches"] = training["main"]["train_step_launches"]
    count_launches(pair_rows, counters, "training")
    count_launches(adamw_rows, counters, "training")
    print(f"  launches on the training path: {matmul_row['name']} "
          f"{matmul_row['training_launches']} (7b: encode "
          f"{matmul_row['training_encode_launches']}, decode "
          f"{matmul_row['training_decode_launches']}); {flash_row['name']} "
          f"{flash_row['training_launches']} (7a's prefill; the train steps "
          f"{flash_row['train_step_launches']})", flush=True)
    main_train = training["main"]
    runtime = training["runtime"]
    print(f"  {main_train['name']} {main_train['layers']} layers training on {card}: step "
          f"{main_train['remat']['median_step_ms']:.3f} ms with remat, "
          f"{main_train['no_remat']['median_step_ms']:.3f} ms without; "
          f"{main_train['remat']['tokens_per_s']:.1f} tokens/s; model FLOPs "
          f"{main_train['remat']['model_flops']:.4g}, {main_train['remat']['share_of_bf16_peak']:.4f}"
          f" of the bf16 peak; peak memory {main_train['remat']['max_memory_allocated']} B with "
          f"remat, {main_train['no_remat']['max_memory_allocated']} B without; "
          f"{runtime['name']} runtime save_s {runtime['save_s']:.3f} (EC "
          f"{runtime['save_ec_s']:.3f}), restore_s {runtime['restore_s']:.3f} (EC "
          f"{runtime['restore_ec_s']:.3f}), step {runtime['step_ms']:.3f} ms", flush=True)
    phase_done("7")

    phase("8", "training and prefill on a device mesh")
    for fn in counters.values():
        fn.launches = 0
    fa.flash_attention_fwd.offset_launches = 0
    mesh = drive_mesh(dev, counters)
    torch.cuda.synchronize()
    flash_row["mesh_launches"] = mesh["launches"]
    check(flash_row["mesh_launches"] > 0,
          f"{flash_row['name']} was not launched on the device-mesh path")
    cp = mesh["context_parallel"][0]
    offset_row = {
        "name": "flash_attention_fwd (q_offset)", "route": "cuda",
        "source": flash_row["source"], "replaces": flash_row["replaces"],
        "launches": mesh["offset_launches"],
        **{key: cp[key] for key in ("max_abs_err", "tolerance", "tolerance_share", "rel_rms_err",
                                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                    "shape")},
        "cases": mesh["context_parallel"],
    }
    check(offset_row["launches"] > 0, "flash_attention_fwd was not launched with a q_offset "
                                      "on the device-mesh path")
    print(f"  launches on the device-mesh path: {flash_row['name']} "
          f"{flash_row['mesh_launches']} (8a's sharded prefill and 8b's split), of them "
          f"{offset_row['launches']} with a q_offset", flush=True)
    phase_done("8")

    phase("9", "decode on a device mesh, the dry-run and the roofline")
    for fn in counters.values():
        fn.launches = 0
    decode_mesh = drive_decode_mesh(dev)
    torch.cuda.synchronize()
    # decode attends in einsum in both packages and the dry-run traces on
    # meta tensors: this path launches none of the kernels
    print(f"  launches on the decode-mesh path: "
          f"{ {name: fn.launches for name, fn in counters.items()} }", flush=True)
    phase_done("9")

    print(json.dumps({"cluster": cluster, "attention": attention, "checkpoint": checkpoint,
                      "models": models, "training": training, "mesh": mesh,
                      "decode_mesh": decode_mesh, "flash_build": flash_build,
                      "gf_build": gf_build, "copy": copy, "phase_seconds": seconds}))
    print(card)
    print(json.dumps({"kernels": dataplane_rows + attention_rows + pair_rows + adamw_rows
                      + [offset_row]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
