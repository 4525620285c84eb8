"""``chip_smoke.py``'s phase 2 training-pair rows rehearsed on the CPU
(fixtures: ``tests/_torch_chip_smoke.py``): the rows pass as they are, and
fail on a backward that rounds P or dS once to bf16, or on a planted
rounding that rounds nothing."""

import math

import pytest
import torch

from _torch_chip_smoke import CPU
from repro_torch.kernels import flash_attention as fa

pytest_plugins = ["_torch_chip_smoke"]


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
