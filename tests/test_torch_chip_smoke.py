"""``chip_smoke.py``'s training-pair rows, checkpoint and model phases
rehearsed on the CPU.

The phase functions run with small widths on ``torch.device("cpu")``,
where each wrapper runs its plain version; the tests count the matmul
wrapper's calls, and the flash kernel's plain version's, in place of their
launches.  Each phase must pass as it is, and each of its checks must fail
when its fault is planted.  The training pair's rows (phase 2): a backward
that rounds P or dS once to bf16, and a planted rounding that rounds
nothing.  Checkpoint: a leaf the save drops, a restored
byte flipped, a fourth node failure that does not happen, a verifier that
ignores half of each tag.  Models (every registered architecture's smoke
config): a causal mask dropped in one prefill layer, a decode cache written
a row late, an MoE dispatch that drops choices within capacity, and a
Mamba2 or mLSTM decode that does not carry its state from step to step.
Training (phase 7): a dropped ``delta`` term, a remat recompute on other
params, AdamW's bias correction a step off, a restore without ``seek``.
Device mesh (phase 8, its one-rank world on gloo and its 4-rank host world
forked from the test's process, which carries the planted faults): a
gradient left partial (each rank keeping its own share, unsummed), a
dropped ``q_offset``, a replicated leaf counted once per rank in the
global norm, and a reshard that drops a shard.  Decode on a mesh (phase
9, its 4-rank host world forked from the test's process): the score
all-reduce over model dropped, k rotated after its slice of the head
vector is cut, and the cache written unclamped at ``cur_len = Smax``.
"""

import importlib.util
import math
import types
from pathlib import Path

import pytest
import torch

from repro_torch.checkpoint import manager as pt_manager
from repro_torch.checkpoint.storage import StorageCluster
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gf256_encode, ops

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


@pytest.fixture
def smoke(monkeypatch):
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    monkeypatch.setattr(module, "YI", dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16))
    monkeypatch.setattr(module, "CKPT_STRIPE_BYTES", 6 * 1024)
    monkeypatch.setattr(module, "CKPT_NODE_CAPACITY", 1 << 22)
    monkeypatch.setattr(module, "median_ms", lambda fn, runs, per_event=1: 0.0)
    return module


@pytest.fixture
def counters(monkeypatch):
    """The matmul wrapper's calls, counted where the card counts launches."""
    matmul = types.SimpleNamespace(launches=0)
    plain = gf256_encode.gf_matmul_bytes_batched_plain

    def counted(*args, **kwargs):
        matmul.launches += 1
        return plain(*args, **kwargs)

    monkeypatch.setattr(gf256_encode, "gf_matmul_bytes_batched_plain", counted)
    return {"gf_matmul_bytes_batched": matmul}


@pytest.fixture
def pair_on_cpu(smoke, monkeypatch):
    """Phase 2's training-pair rows at a small shape, each timing 1 ms."""
    monkeypatch.setattr(smoke, "PAIR_CASE", ("small", 1, 300, 8, 2, 128, 128))
    monkeypatch.setattr(smoke, "median_ms", lambda fn, runs, per_event=1: 1.0)
    return smoke


@pytest.mark.parametrize("case", [None, ("small mla", 1, 300, 4, 4, 192, 128)])
def test_pair_rows_pass_on_the_cpu(pair_on_cpu, case):
    """On CPU tensors the wrappers are their plain versions, at D = Dv = 128
    and at MLA's 192/128: no error; each planted rounding lands well past
    the RMS allowance on the gradients it moves; the backward's products
    counted at 8D + 5Dv a pair with the splits, 3D + 2Dv as the model's."""
    fwd, bwd = pair_on_cpu.check_pair_kernels(CPU, case)
    assert fwd["max_abs_err"] == bwd["max_abs_err"] == fwd["lse_max_abs_err"] == 0
    assert bwd["rms_ratio"] == 1.0 and bwd["repeat_bitwise"]
    factor = pair_on_cpu.PAIR_GRADS["rms_factor"]
    planted = bwd["planted_faults"]
    assert planted["P"]["dv"]["rms_ratio"] > 1.2 * factor
    assert min(planted["dS"][g]["rms_ratio"] for g in ("dq", "dk")) > 1.2 * factor
    d, dv = (case or pair_on_cpu.PAIR_CASE)[-2:]
    flops = bwd["flops"]
    assert flops["with_splits"] * (3 * d + 2 * dv) == flops["model"] * (8 * d + 5 * dv)
    assert fwd["flops"] * (8 * d + 5 * dv) == bwd["flops"]["with_splits"] * (d + dv)
    assert fwd["library_ms"] == bwd["library_ms"] == 1.0


@pytest.mark.parametrize("sq,skv,causal,q_offset", [
    (5, 5, True, 0), (1, 1, False, 0), (1, 7, False, 0), (4, 9, True, 3), (3, 6, True, 0)])
def test_pair_exact_zeros_are_the_exact_function_s(smoke, sq, skv, causal, q_offset):
    """The masks mark exactly the gradient rows that are 0 in float64."""
    gen = torch.Generator().manual_seed(sq * 10 + skv)
    q, k, v = (torch.randn(shape, generator=gen, dtype=torch.float64).requires_grad_()
               for shape in ((1, sq, 2, 8), (1, skv, 1, 8), (1, skv, 1, 8)))
    s = torch.einsum("bqhd,bkgd->bhqk", q, k) / 8 ** 0.5
    if causal:
        rows = q_offset + torch.arange(sq)[:, None]
        s = s.masked_fill(torch.arange(skv)[None, :] > rows, -math.inf)
    torch.einsum("bhqk,bkgd->bqhd", s.softmax(-1), v).backward(
        torch.randn((1, sq, 2, 8), generator=gen, dtype=torch.float64))
    for grad, zero in zip((q.grad, k.grad, v.grad),
                          smoke.pair_exact_zeros(sq, skv, causal, q_offset, CPU), strict=True):
        rows_zero = grad.abs().amax(dim=(0, 2, 3)) <= 1e-12 * grad.abs().max().clamp_min(1.0)
        assert torch.equal(rows_zero, zero.reshape(-1))


def _round_once(smoke, monkeypatch, rounded):
    def kernel(q, k, v, out, dout, lse, causal=True, q_offset=0):
        return smoke.pair_bwd_rounded_once(q, k, v, out, dout, lse, causal, q_offset, rounded)

    monkeypatch.setattr(fa, "flash_attention_bwd", kernel)


def _round_p_once(smoke, monkeypatch):
    _round_once(smoke, monkeypatch, "P")


def _round_ds_once(smoke, monkeypatch):
    _round_once(smoke, monkeypatch, "dS")


def _plant_no_rounding(smoke, monkeypatch):
    monkeypatch.setattr(smoke, "pair_bwd_rounded_once",
                        lambda *args: fa.flash_attention_bwd_plain(*args[:-1]))


@pytest.mark.parametrize("plant, message", [
    (_round_p_once, "flash_attention_bwd small: dv differs"),
    (_round_ds_once, "flash_attention_bwd small: dq differs"),
    (_plant_no_rounding, "planted fault passed: P rounded once"),
], ids=lambda x: x.__name__.strip("_") if callable(x) else None)
def test_pair_rows_fail_on_a_planted_fault(pair_on_cpu, monkeypatch, plant, message):
    plant(pair_on_cpu, monkeypatch)
    with pytest.raises(AssertionError, match=message):
        pair_on_cpu.check_pair_kernels(CPU)


def test_checkpoint_phase_passes_on_the_cpu(smoke, counters):
    res = smoke.drive_checkpoint(CPU, counters)
    assert res["leaves"] == 13 and res["save_launches"] > 0 and res["restore_launches"] > 0
    weights = 64 * 64 * 2 + 64 * 32 * 2          # wq, wo and wk, wv at the small widths
    assert res["bytes"] == weights * (2 + 4 + 4) + 8   # bf16 weights, fp32 moments, the step
    assert res["degraded_objects"] > 0 and res["refused"]
    assert res["rejected"] == sorted(smoke.CORRUPTED_TAGS)


def _drop_last_leaf(monkeypatch):
    write = pt_manager.CheckpointManager._write
    monkeypatch.setattr(pt_manager.CheckpointManager, "_write",
                        lambda self, step, snap: write(self, step, snap[:-1]))


def _flip_a_restored_byte(monkeypatch):
    to_leaf = pt_manager._bytes_to_leaf

    def flipped(raw, meta):
        raw = raw.copy()
        raw[-1] ^= 1
        return to_leaf(raw, meta)

    monkeypatch.setattr(pt_manager, "_bytes_to_leaf", flipped)


def _fourth_failure_missed(monkeypatch):
    fail = StorageCluster.fail_node

    def fail_three(self, node):
        if len(self.failed) < 3:
            fail(self, node)

    monkeypatch.setattr(StorageCluster, "fail_node", fail_three)


def _verifier_reads_half_the_tag(monkeypatch):
    def half(words, tags, key, device):
        dev = torch.device(device)
        want = ops._sponge_mac(ops._words_on(words, dev), ops._words_on(key, dev))
        return want[:, 0] == ops._words_on(tags, dev)[:, 0]

    monkeypatch.setattr(ops, "bulk_verify", half)


@pytest.mark.parametrize("plant, message", [
    (_drop_last_leaf, "manifest leaves"),
    (_flip_a_restored_byte, "not restored bitwise"),
    (_fourth_failure_missed, "did not raise"),
    (_verifier_reads_half_the_tag, "not exactly the corrupted"),
], ids=lambda x: x.__name__.strip("_") if callable(x) else None)
def test_checkpoint_phase_fails_on_a_planted_fault(smoke, counters, monkeypatch, plant,
                                                    message):
    plant(monkeypatch)
    with pytest.raises(AssertionError, match=message):
        smoke.drive_checkpoint(CPU, counters)


# -- phase 6, the model serving path ------------------------------------------------------


@pytest.fixture
def models_on_cpu(smoke, monkeypatch):
    """Phase 6 at smoke widths on the CPU: every registered architecture's
    smoke config, short sequences, and the flash kernel's plain version in
    the kernel's place for every prefill self-attention, its calls counted
    where the card counts launches."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import flash_attention as fa

    monkeypatch.setattr(smoke, "model_configs",
                        lambda: {name: ARCHS[name].smoke for name in
                                 [smoke.MAIN_ARCH, *smoke.DEPTH_CUTS]})
    for name, value in [("PREFILL_SEQ", 32), ("PREFILL_RUNS", 1), ("DECODE_PROMPT", 8),
                        ("DECODE_MAX_LEN", 16), ("CUT_SEQ", 32), ("CUT_DECODE_STEPS", 4),
                        ("WHISPER_FRAMES", 24), ("WHISPER_TOKENS", 16)]:
        monkeypatch.setattr(smoke, name, value)
    monkeypatch.setattr(smoke, "event_ms", lambda fn: (fn(), 0.0))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *args: None)
    flash = types.SimpleNamespace(launches=0)

    def stand_in(q, k, v, causal=True, q_offset=0):
        flash.launches += 1
        return fa.flash_attention_fwd_plain(q, k, v, causal, q_offset)

    monkeypatch.setattr(fa, "flash_attention_fwd", stand_in)
    dispatch = ops.flash_attention

    def on_the_kernel(q, k, v, causal=True, backend=None, device=None, block=512, q_offset=0):
        # the CPU's operands take the kernel's route, as the card's do
        return dispatch(q, k, v, causal, "kernel", device, block, q_offset)

    monkeypatch.setattr(ops, "flash_attention", on_the_kernel)
    return {"flash_attention_fwd": flash}


def test_model_phase_passes_on_the_cpu(smoke, models_on_cpu):
    results = {r["name"]: r for r in smoke.drive_models(CPU, models_on_cpu)}
    assert sorted(results) == sorted([smoke.MAIN_ARCH, *smoke.DEPTH_CUTS])
    launches = {name: r["launches"] for name, r in results.items()}
    assert launches == {"yi-9b": 2, "deepseek-v2-lite-16b": 3, "dbrx-132b": 2,
                        "zamba2-2.7b": 2, "llava-next-mistral-7b": 2, "minitron-8b": 2,
                        "qwen1.5-4b": 2, "starcoder2-7b": 2, "xlstm-125m": 0,
                        "whisper-base": 4}
    main = results["yi-9b"]
    assert main["planted_fault"]["tolerance_share"] > 1.0
    assert main["decode_batch"] == [smoke.DECODE_BATCH, 8]
    serve = main["serve"]
    assert serve["served"] + len(serve["rejected"]) == smoke.SERVE_REQUESTS
    assert serve["rejected"] and serve["tokens"] == serve["served"] * smoke.SERVE_MAX_TOKENS
    for name in ("dbrx-132b", "deepseek-v2-lite-16b"):
        assert "moe_dispatch_vs_plain" in results[name]


def _drop_the_causal_mask_once(monkeypatch):
    from repro_torch.kernels import flash_attention as fa

    stand_in, calls = fa.flash_attention_fwd, []

    def faulty(q, k, v, causal=True, q_offset=0):
        calls.append(1)
        return stand_in(q, k, v, causal and len(calls) > 1, q_offset)

    monkeypatch.setattr(fa, "flash_attention_fwd", faulty)


def _write_the_cache_a_row_late(monkeypatch):
    from repro_torch.models import attention

    monkeypatch.setattr(attention, "_cache_slot", lambda t, smax: min(max(t + 1, 0), smax - 1))


def _drop_moe_choices_within_capacity(monkeypatch):
    from repro_torch.models import moe

    original = moe.moe_apply

    def faulty(p, x, n_experts, top_k, capacity_factor=1.25, dense_fallback=False):
        return original(p, x, n_experts, top_k, capacity_factor=capacity_factor / 2,
                        dense_fallback=dense_fallback)

    monkeypatch.setattr(moe, "moe_apply", faulty)


def _carry_no_ssm_state(monkeypatch):
    from repro_torch.models import mamba2

    original = mamba2.mamba2_decode

    def faulty(p, u, h, *args):
        return original(p, u, torch.zeros_like(h), *args)

    monkeypatch.setattr(mamba2, "mamba2_decode", faulty)


def _carry_no_mlstm_state(monkeypatch):
    from repro_torch.models import xlstm

    original = xlstm.mlstm_decode

    def faulty(p, x, state, *args):
        c, n, m = state
        return original(p, x, (torch.zeros_like(c), torch.zeros_like(n),
                               torch.full_like(m, xlstm.M_INIT)), *args)

    monkeypatch.setattr(xlstm, "mlstm_decode", faulty)


@pytest.mark.parametrize("plant, message", [
    (_drop_the_causal_mask_once, "yi-9b prefill hidden with the kernel vs blockwise"),
    (_write_the_cache_a_row_late, "decode vs forward"),
    (_drop_moe_choices_within_capacity, "MoE capacity dispatch vs its plain version"),
    (_carry_no_ssm_state, "zamba2-2.7b decode vs forward in fp32"),
    (_carry_no_mlstm_state, "xlstm-125m decode vs forward in fp32"),
], ids=lambda x: x.__name__.strip("_") if callable(x) else None)
def test_model_phase_fails_on_a_planted_fault(smoke, models_on_cpu, monkeypatch, plant,
                                              message):
    plant(monkeypatch)
    with pytest.raises(AssertionError, match=message):
        smoke.drive_models(CPU, models_on_cpu)


# -- phase 7, the training runtime --------------------------------------------------------


@pytest.fixture
def training_on_cpu(smoke, counters, monkeypatch):
    """Phase 7 at smoke widths on the CPU: every training model's smoke
    config, short sequences, a small cluster, and the flash kernel's plain
    version in the kernel's place wherever the card's rule picks the kernel
    (no gradient needed), its calls counted where the card counts
    launches."""
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.kernels import flash_attention as fa

    cuts = {name: ARCHS[name].smoke for name in smoke.DEPTH_CUTS
            if name not in smoke.TRAIN_LEFT_OUT}
    monkeypatch.setattr(smoke, "training_configs", lambda: (
        dataclasses.replace(ARCHS[smoke.TRAIN_ARCH].smoke, remat=True),
        ARCHS[smoke.RUNTIME_ARCH].smoke, cuts))
    for name, value in [("TRAIN_SEQ", 32), ("RUNTIME_BATCH", 2), ("RUNTIME_SEQ", 32),
                        ("RUNTIME_NODE_CAPACITY", 1 << 24), ("CUT_TRAIN_SEQ", 32),
                        ("WHISPER_FRAMES", 24),
                        ("LAUNCHER_ARGS", ["--arch", "yi-9b", "--smoke", "--steps", "6",
                                           "--fail-at", "4", "--checkpoint-every", "2"])]:
        monkeypatch.setattr(smoke, name, value)
    for name, value in [("synchronize", lambda *args: None),
                        ("reset_peak_memory_stats", lambda *args: None),
                        ("max_memory_allocated", lambda *args: 0),
                        ("empty_cache", lambda: None)]:
        monkeypatch.setattr(torch.cuda, name, value)
    flash = types.SimpleNamespace(launches=0, offset_launches=0)

    def stand_in(q, k, v, causal=True, q_offset=0):
        flash.launches += 1
        flash.offset_launches += q_offset > 0
        return fa.flash_attention_fwd_plain(q, k, v, causal, q_offset)

    monkeypatch.setattr(fa, "flash_attention_fwd", stand_in)
    dispatch = ops.flash_attention

    def by_the_card_s_rule(q, k, v, causal=True, backend=None, device=None, block=512,
                           q_offset=0):
        needs_grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
        return dispatch(q, k, v, causal, None if needs_grad else "kernel", device, block,
                        q_offset)

    monkeypatch.setattr(ops, "flash_attention", by_the_card_s_rule)
    return {"flash_attention_fwd": flash, **counters}


def test_training_phase_passes_on_the_cpu(smoke, training_on_cpu):
    res = smoke.drive_training(CPU, training_on_cpu)
    main = res["main"]
    assert main["prefill_launches"] == main["layers"] == 2 and main["train_step_launches"] == 0
    assert main["step0_loss"] == main["blockwise_loss"] and main["train_forward"] == "blockwise"
    # on CPU tensors every train step's attention takes the plain loops
    assert main["pair_launches"] == {
        "forward": 0, "backward": 0,
        "plain_calls": 3 * (1 + smoke.TRAIN_TIMED_STEPS) * main["layers"]}
    assert main["remat_vs_none"]["bitwise"] and main["adamw_vs_float64"]["ok"]
    assert len(main["remat"]["losses"]) == 1 + smoke.TRAIN_TIMED_STEPS
    assert res["directional"]["rel_err"] <= smoke.DIRECTIONAL_TOL
    rt = res["runtime"]
    assert rt["restarts"] == 1 and rt["replayed_equal"] and rt["steps"] == [1, 2, 3, 4, 5, 6, 5,
                                                                             6, 7, 8]
    assert [s["step"] for s in rt["saves"]] == [0, 4, 8, 8]
    assert all(s["encode_launches"] > 0 for s in rt["saves"])
    assert rt["restores"][0]["decode_launches"] > 0 and rt["restores"][0]["bitwise"]
    assert sorted(c["name"] for c in res["cuts"]) == sorted(
        set(smoke.DEPTH_CUTS) - set(smoke.TRAIN_LEFT_OUT))
    assert all(c["remat_vs_none"]["bitwise"] for c in res["cuts"])
    assert res["launcher"]["restarts"] == 1


def _drop_the_delta_term(monkeypatch):
    from repro_torch.models import attention

    monkeypatch.setattr(attention, "_row_dot", lambda out, dout: torch.zeros_like(out[..., 0]))


def _recompute_on_other_params(monkeypatch):
    from repro_torch.models import transformer
    from repro_torch.models.layers import tree_map

    checkpoint = transformer.checkpoint

    def faulty(fn, *args, **kwargs):
        calls = []

        def twice(first, *rest):
            calls.append(1)
            if len(calls) > 1:          # the recompute, on params moved by 1e-3
                first = tree_map(lambda t: t * (1 + 1e-3), first)
            return fn(first, *rest)

        return checkpoint(twice, *args, **kwargs)

    monkeypatch.setattr(transformer, "checkpoint", faulty)


def _bias_correction_a_step_off(monkeypatch):
    from repro_torch.optim import adamw

    update = adamw.adamw_update

    def faulty(params, grads, opt_state, cfg, lr_scale=1.0):
        params, opt, metrics = update(params, grads, {**opt_state, "step": opt_state["step"] - 1},
                                      cfg, lr_scale)
        return params, {**opt, "step": opt["step"] + 1}, metrics

    monkeypatch.setattr(adamw, "adamw_update", faulty)


def _restore_without_seek(monkeypatch):
    from repro_torch.data.pipeline import DataPipeline

    monkeypatch.setattr(DataPipeline, "seek", lambda self, step: None)


@pytest.mark.parametrize("plant, message", [
    (_drop_the_delta_term, "directional derivative"),
    (_recompute_on_other_params, "gradients with remat vs without"),
    (_bias_correction_a_step_off, "AdamW vs a float64 update"),
    (_restore_without_seek, "replayed losses"),
], ids=lambda x: x.__name__.strip("_") if callable(x) else None)
def test_training_phase_fails_on_a_planted_fault(smoke, training_on_cpu, monkeypatch, plant,
                                                 message):
    # each fault lies in 7a's or 7b's path: the cut models are left out here
    main, runtime, _ = smoke.training_configs()
    monkeypatch.setattr(smoke, "training_configs", lambda: (main, runtime, {}))
    plant(monkeypatch)
    with pytest.raises(AssertionError, match=message):
        smoke.drive_training(CPU, training_on_cpu)


# -- phase 8, the device mesh --------------------------------------------------------------

#: 8b's context-parallel split at small widths: both bodies' dtypes
CP_SMALL = [("small bf16", 1, 128, 4, 2, 64, 64, "bfloat16"),
            ("small fp32", 1, 128, 4, 2, 64, 64, "float32")]


@pytest.fixture
def mesh_on_cpu(smoke, training_on_cpu, monkeypatch):
    """Phase 8 at smoke widths on the CPU: 8a's one-rank world on gloo with
    phase 7a's smoke model, 8b at ``CP_SMALL``, 8c as on the card."""
    monkeypatch.setattr(smoke, "CP_CASES", CP_SMALL)
    return training_on_cpu


def test_mesh_phase_passes_on_the_cpu(smoke, mesh_on_cpu):
    res = smoke.drive_mesh(CPU, mesh_on_cpu)
    main = res["main"]
    assert main["bitwise"] and main["prefill_bitwise"] and main["prefill_launches"] == 2
    assert res["offset_launches"] == len(CP_SMALL) * (smoke.CP_SPLIT - 1)
    assert res["launches"] == 2 + len(CP_SMALL) * smoke.CP_SPLIT
    assert all(row["bitwise_vs_unsplit"] for row in res["context_parallel"])
    steps = res["world"]["steps"]
    assert sorted(steps) == sorted(f"{name} {mesh}" for name in smoke.MESH_ARCHS
                                   for mesh in smoke.MESH_SHAPES)
    assert all(row["moe_ep"] == name.startswith("deepseek") for name, row in steps.items())
    survivors = [r for r in res["world"]["shrink"].values() if not r["evicted"]]
    assert len(survivors) == 2 and all(r["mesh"] == {"data": 1, "model": 2} for r in survivors)


def _leave_gradients_partial(monkeypatch):
    from repro_torch.parallel import spmd

    monkeypatch.setattr(spmd, "_reduce_scatter", spmd._own_slice)


def _drop_the_query_offset(monkeypatch):
    from repro_torch.kernels import flash_attention as fa

    kernel = fa.flash_attention_fwd
    monkeypatch.setattr(fa, "flash_attention_fwd",
                        lambda q, k, v, causal=True, q_offset=0: kernel(q, k, v, causal, 0))


def _count_replicated_leaves_per_rank(monkeypatch):
    from repro_torch.parallel import spmd

    monkeypatch.setattr(spmd.StepContext, "owns", lambda self, spec: True)


def _drop_a_shard_in_the_reshard(monkeypatch):
    import torch.distributed as dist

    from repro_torch.models.layers import tree_leaves
    from repro_torch.runtime import elastic

    reshard = elastic.reshard_state

    def faulty(state, new_mesh, specs=None, old_mesh=None):
        moved = reshard(state, new_mesh, specs, old_mesh)
        if moved is not None and dist.get_rank() == 0:
            tree_leaves(moved)[0].to_local().zero_()
        return moved

    monkeypatch.setattr(elastic, "reshard_state", faulty)


@pytest.mark.parametrize("plant, message", [
    (_leave_gradients_partial, "8c sharded train step"),
    (_drop_the_query_offset, "8b flash with q_offset"),
    (_count_replicated_leaves_per_rank, "8c sharded train step"),
    (_drop_a_shard_in_the_reshard, "8c shrink"),
], ids=lambda x: x.__name__.strip("_") if callable(x) else None)
def test_mesh_phase_fails_on_a_planted_fault(smoke, mesh_on_cpu, monkeypatch, plant, message):
    plant(monkeypatch)
    with pytest.raises(AssertionError, match=message):
        smoke.drive_mesh(CPU, mesh_on_cpu)


# -- phase 9, decode on a device mesh ------------------------------------------------------


@pytest.fixture
def decode_mesh_on_cpu(smoke, models_on_cpu, monkeypatch):
    """Phase 9 on the CPU: 9a's host world as on the card, 9b's one-rank
    world on gloo with phase 6's smoke models and the witness over 32
    rows, 9c's dry-run of the production cells as on the card."""
    monkeypatch.setattr(smoke, "WITNESS_SEQ", 32)
    monkeypatch.setattr(smoke, "WITNESS_LENS", (29, 30, 31, 32))
    return smoke


def test_decode_mesh_phase_passes_on_the_cpu(smoke, decode_mesh_on_cpu):
    res = smoke.drive_decode_mesh(CPU)
    cases = res["world"]["cases"]
    assert sorted(cases) == sorted(f"{name} {mesh}" for name in smoke.DECODE_MESH_ARCHS
                                   for mesh in smoke.DECODE_MESH_SHAPES)
    assert all(row["logits"] <= smoke.MESH_DECODE_BF16.get(case.split()[0], smoke.MESH_FP32)
               for case, row in cases.items())
    main = res["main"]
    assert main["logits_bitwise"] and main["cache_bitwise"] and main["steps"] == 8
    floor = main["witness_floor"]
    assert sorted(floor) == sorted(smoke.WITNESS_MESHES)
    assert sorted(floor["2x2"]) == ["batch_split", "score_split"]
    assert all(len(row["rel_rms_err"]) == 4 and all(map(math.isfinite, row["rel_rms_err"]))
               for controls in floor.values() for row in controls.values())
    assert [row["shape"] for row in res["dryrun"]] == list(smoke.DRYRUN_CELLS)
    assert all(row["chips"] == 256 for row in res["dryrun"])


def _drop_the_score_all_reduce(monkeypatch):
    from repro_torch.parallel import spmd

    monkeypatch.setattr(spmd.StepContext, "sum_over_model", lambda self, x: x)


def _rotate_k_after_slicing(monkeypatch):
    from repro_torch.models import attention
    from repro_torch.models.layers import apply_rope, dense_apply

    decode_qkv = attention._decode_qkv

    def faulty(p, x, pos, n_heads, n_kv_heads, head_dim, rope_theta, sp=None, split=None):
        qg, _, v = decode_qkv(p, x, pos, n_heads, n_kv_heads, head_dim, rope_theta, sp, split)
        k = dense_apply(p["wk"], x).reshape(x.shape[0], 1, n_kv_heads, head_dim)
        if split is not None:
            k = sp.own_model(k, split)
        return qg, (apply_rope(k, pos, rope_theta) if rope_theta > 0 else k), v

    monkeypatch.setattr(attention, "_decode_qkv", faulty)


def _write_the_cache_unclamped(monkeypatch):
    from repro_torch.models import attention

    monkeypatch.setattr(attention, "_cache_slot", lambda t, smax: t)


@pytest.mark.parametrize("plant", [_drop_the_score_all_reduce, _rotate_k_after_slicing,
                                   _write_the_cache_unclamped],
                         ids=lambda x: x.__name__.strip("_"))
def test_decode_mesh_phase_fails_on_a_planted_fault(smoke, decode_mesh_on_cpu, monkeypatch,
                                                    plant):
    monkeypatch.setattr(smoke, "DRYRUN_CELLS", ())
    plant(monkeypatch)
    with pytest.raises(AssertionError, match="9a sharded decode"):
        smoke.drive_decode_mesh(CPU)
