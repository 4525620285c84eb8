"""``chip_smoke.py``'s phase 6, the model serving path, rehearsed on the
CPU at every registered architecture's smoke config (fixtures:
``tests/_torch_chip_smoke.py``): it passes as it is, and fails on a causal
mask dropped in one prefill layer, a decode cache written a row late, an
MoE dispatch that drops choices within capacity, and a Mamba2 or mLSTM
decode that does not carry its state from step to step."""

import pytest
import torch

from _torch_chip_smoke import CPU

pytest_plugins = ["_torch_chip_smoke"]


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
