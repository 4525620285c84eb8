"""Fixtures shared by ``tests/test_torch_chip_smoke_*.py``, which rehearse
``chip_smoke.py``'s phases on the CPU, one file per phase.

The phase functions run with small widths on ``torch.device("cpu")``,
where each wrapper runs its plain version; the tests count the matmul
wrapper's calls, and the flash kernel's plain version's, in place of their
launches (and the plain AdamW loop's where the card counts its fused
kernel's).  Each phase must pass as it is, and each of its checks must fail
when its fault is planted.  The phase files load this module as a pytest
plugin (``pytest_plugins``): ``smoke`` (``chip_smoke.py`` loaded afresh at
small widths), ``counters``, and the fixtures that later phases build on,
``models_on_cpu`` (phases 6 and 9) and ``training_on_cpu`` (phases 7 and 8).
"""

import importlib.util
import types
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import gf256_encode

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


def _flash_counted(monkeypatch):
    """The flash kernel's plain version in the kernel's place, its calls
    counted where the card counts launches (returned); and the CPU's
    operands routed as the card's wherever the card takes the forward
    kernel (self-attention with no gradient needed), as the CPU's
    elsewhere."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention

    flash = types.SimpleNamespace(launches=0, offset_launches=0)

    def stand_in(q, k, v, causal=True, q_offset=0):
        flash.launches += 1
        flash.offset_launches += q_offset > 0
        return fa.flash_attention_fwd_plain(q, k, v, causal, q_offset)[0]

    route = attention.attention_route

    def as_on_the_card(device_type, *call):
        on_card = route("cuda", *call)
        return on_card if on_card == "flash" else route(device_type, *call)

    monkeypatch.setattr(fa, "flash_attention_fwd", stand_in)
    monkeypatch.setattr(attention, "attention_route", as_on_the_card)
    return flash


def _adamw_counted(monkeypatch):
    """The plain AdamW loop's calls, counted where the card counts the fused
    kernel's launches (returned)."""
    from repro_torch.kernels import adamw

    counter = types.SimpleNamespace(launches=0)
    plain = adamw.adamw_step_plain

    def counted(*args, **kwargs):
        counter.launches += 1
        return plain(*args, **kwargs)

    monkeypatch.setattr(adamw, "adamw_step_plain", counted)
    return counter


@pytest.fixture
def models_on_cpu(smoke, monkeypatch):
    """Phase 6 at smoke widths on the CPU: every registered architecture's
    smoke config, short sequences, and the flash kernel's plain version in
    the kernel's place for every prefill self-attention, its calls counted
    where the card counts launches."""
    from repro_torch.configs import ARCHS

    monkeypatch.setattr(smoke, "model_configs",
                        lambda: {name: ARCHS[name].smoke for name in
                                 [smoke.MAIN_ARCH, *smoke.DEPTH_CUTS]})
    for name, value in [("PREFILL_SEQ", 32), ("PREFILL_RUNS", 1), ("DECODE_PROMPT", 8),
                        ("DECODE_MAX_LEN", 16), ("CUT_SEQ", 32), ("CUT_DECODE_STEPS", 4),
                        ("WHISPER_FRAMES", 24), ("WHISPER_TOKENS", 16)]:
        monkeypatch.setattr(smoke, name, value)
    monkeypatch.setattr(smoke, "event_ms", lambda fn: (fn(), 0.0))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *args: None)
    return {"flash_attention_fwd": _flash_counted(monkeypatch)}


@pytest.fixture
def training_on_cpu(smoke, counters, monkeypatch):
    """Phase 7 at smoke widths on the CPU: every training model's smoke
    config, short sequences, a small cluster, and the flash kernel's plain
    version in the kernel's place wherever the card's route picks the
    kernel (no gradient needed), its calls counted where the card counts
    launches."""
    import dataclasses

    from repro_torch.configs import ARCHS

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
    return {"flash_attention_fwd": _flash_counted(monkeypatch),
            "adamw_step": _adamw_counted(monkeypatch), **counters}
