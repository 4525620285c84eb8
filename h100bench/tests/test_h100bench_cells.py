"""Each cell driven on the CPU at smoke widths: the port's timed path against
the plain references, the controls, and each planted fault seen as not
correct under the cell's own limits.  The look for a card is skipped:
``run.drive`` is the run after that look.

    python3 -m pytest -q h100bench/tests
"""

from __future__ import annotations

import contextlib
import json
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

import faults  # noqa: E402
import harness as h  # noqa: E402
import run  # noqa: E402

h.port_path()
SPEC = h.load_spec()
SEED = 2**31 + 12345
SMOKE = {"hidden_size": 64, "intermediate_size": 128, "num_attention_heads": 4,
         "vocab_size": 256, "port_options": {"loss_chunk": 16, "attn_block": 16}}


def small(cell: str) -> tuple[dict, dict]:
    entry = h.cell_of(SPEC, cell)
    c, mix = h.config_of(SPEC, entry["config"]), h.mix_of(entry["traffic"])
    if c.get("model_type") == "llama":
        c.update(SMOKE, num_key_value_heads=2, num_hidden_layers=2)
    else:
        c.update(stripe_bytes=6 * 4096, node_capacity_bytes=1 << 24, stage_layers=3,
                 state_widths={"hidden_size": 256, "intermediate_size": 384,
                               "num_attention_heads": 4, "num_key_value_heads": 2})
    if mix["kind"] == "train":
        mix.update(seq=64, batch=2)
    return c, mix


def judged(cell: str, numbers: dict, failed: int = 0) -> bool:
    correct, _ = h.judge(numbers, run.limits_of(cell))
    return correct and failed == 0


def drive_once(cell: str, fault: str | None = None, seconds: float = 0.5):
    import torch

    c, mix = small(cell)
    kind = h.kind_of(mix)
    plant = faults.FAULTS[mix["kind"]](fault) if fault else contextlib.nullcontext()
    with plant:
        obj = kind.Cell(h, c, mix, SEED, torch.device("cpu"))
        out = run.drive(obj, SPEC, cell, seconds, False, torch.device("cpu"), 1)
    return obj, out


# -- training -------------------------------------------------------------------------


def test_train_reference_agrees_with_the_ports_step():
    # bf16 products over 2 layers of width 64 against fp32
    _, out = drive_once("yi9b-train4k")
    n = out["numbers"]
    assert n["loss_gap"] < 1e-3 and n["grad_gap"] < 1e-2 and n["delta_gap"] < 1e-2, n


def test_train_control_is_not_correct():
    obj, out = drive_once("yi9b-train4k")
    kind = h.kind_of(small("yi9b-train4k")[1])
    control = kind.compare(obj.reference(control=True), obj.reference())
    assert not judged("yi9b-train4k", control), control


@pytest.mark.parametrize("fault", ["half", "altered", "unchanged"])
def test_train_faults_are_not_correct(fault):
    _, out = drive_once("yi9b-train4k", fault)
    assert not judged("yi9b-train4k", out["numbers"]), out["numbers"]


# -- checkpoints ----------------------------------------------------------------------------


def test_ckpt_is_exact():
    _, out = drive_once("rs63-ckpt-degraded")
    assert judged("rs63-ckpt-degraded", out["numbers"], out["result"]["failed"]), out["numbers"]


@pytest.mark.parametrize("fault", ["control", "altered", "half", "unchanged"])
def test_ckpt_control_and_faults_are_not_correct(fault):
    _, out = drive_once("rs63-ckpt-degraded", fault)
    assert not judged("rs63-ckpt-degraded", out["numbers"], out["result"]["failed"])


def test_rs_reference_matches_a_hand_worked_product():
    import numpy as np

    import rs_ref

    assert rs_ref.mul(0x80, 2) == 0x1D and rs_ref.mul(3, 7) == 9
    assert rs_ref.mul(rs_ref.inv(0x53), 0x53) == 1
    cells = np.array([[1, 0], [0, 1], [0, 0], [0, 0], [0, 0], [0, 0]], np.uint8)
    parity = rs_ref.encode(cells, 3)
    assert (parity[:, 0] == rs_ref.cauchy(6, 3)[:, 0]).all()


# -- a cell on several processes (gloo ranks) ------------------------------------------------


def ranks_with_a_planted_module(rank: int, payload: dict) -> None:
    """``run.rank_main``, with a module of the JAX package's name loaded on
    the rank ``payload["plant"]`` names (none where it is None)."""
    import types

    if rank == payload["plant"]:
        sys.modules["repro.planted"] = types.ModuleType("repro.planted")
    run.rank_main(rank, payload)


@pytest.mark.parametrize("plant", [None, 0, 1])
def test_a_forbidden_module_in_any_rank_refuses_the_result(plant, capsys):
    import argparse

    c, mix = small("yi9b-train4k")
    out = h.launch(ranks_with_a_planted_module, {
        "workload": "yi9b-train4k", "seed": SEED, "seconds": 0.5, "trace": False, "chips": 2,
        "config": c, "mix": mix, "start": 0.0, "device_type": "cpu", "plant": plant}, 2)
    assert set(out["forbidden"]) == {"rank 0", "rank 1"}
    args = argparse.Namespace(workload="yi9b-train4k", trace=0)
    rc = run.report(SPEC, args, out, 2)
    printed = capsys.readouterr().out
    if plant is None:
        assert rc == 0 and set(json.loads(printed.splitlines()[-1])) >= {
            "correct", "attempted", "failed", "metrics", "device"}
    else:
        assert rc == 1 and printed == ""
        assert out["forbidden"][f"rank {plant}"] == ["repro.planted"]
