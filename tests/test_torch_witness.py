"""The witness of ``tools/sharding_on_cards.py`` part (f): the sharded decode
of yi against the one-device decode, with the one-device controls that read
how far bf16 reordering alone moves the logits.

The tool's CPU rehearsal (``--cpu-rehearsal --parts f``: 4 gloo ranks, yi's
smoke widths at 48 layers, the witness at B=8 over 32 rows) runs once for
the module; each test reads its ``sharding.json``:

* (i) each mesh's witness tokens come from a generator of its own: the
  tokens a mesh decoded after the other mesh drew equal those drawn here,
  where no other draw came first;
* (ii) the bf16 and the fp32 witness of a mesh decode the same tokens;
* (iii) the sharded decode run twice from the same inputs gives the same
  logits bit for bit, on (4, 1) and on (2, 2);
* (iv) the batch-split control gives a finite distance, and in fp32 one
  within ``chip_smoke.FP32_MODEL``;
* the one-device control that does a mesh's arithmetic (the batch split on
  (4, 1), the scores split as well on (2, 2)) gives that mesh's bf16 logits
  bit for bit here (the host's bf16 products do not depend on the weights'
  layout, as the card's need not: a gathered down projection comes back
  transposed).
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

MESHES = list(cs.WITNESS_MESHES)


@pytest.fixture(scope="module")
def rehearsal(tmp_path_factory) -> tuple[subprocess.CompletedProcess, dict]:
    out = tmp_path_factory.mktemp("witness")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "sharding_on_cards.py"), "--cpu-rehearsal",
         "--parts", "f", "--out-dir", str(out)],
        cwd=ROOT, env=dict(os.environ), capture_output=True, text=True, timeout=600)
    return proc, json.loads((out / "sharding.json").read_text())


def _yi_smoke():
    from repro_torch.configs import ARCHS

    return ARCHS["yi-9b"].smoke


def test_part_f_rehearsal_runs_clean(rehearsal):
    proc, out = rehearsal
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["failed"] == []
    for key in MESHES:
        checks = out["f"][key]["checks"]
        assert sorted(checks) == ["finite", "fp32_model", "repeat_bitwise", "whole_model",
                                  "within_controls"]
        assert all(checks.values()), (key, checks)


@pytest.mark.parametrize("key", MESHES)
def test_witness_tokens_depend_on_no_other_draw(rehearsal, key):
    """(i): the world drew (4, 1)'s tokens, timed and witness, before
    (2, 2)'s; here each mesh's are drawn with nothing before them."""
    _, out = rehearsal
    shape = cs.WITNESS_MESHES[key]
    alone = cs.witness_tokens(_yi_smoke(), shape)
    assert out["f"][key]["witness"]["tokens"] == alone.tolist()
    others = [cs.witness_tokens(_yi_smoke(), s) for k, s in cs.WITNESS_MESHES.items() if k != key]
    assert all(not np.array_equal(alone, other) for other in others)


@pytest.mark.parametrize("key", MESHES)
def test_both_witnesses_of_a_mesh_decode_the_same_tokens(rehearsal, key):
    """(ii)"""
    row = rehearsal[1]["f"][key]
    assert row["witness"]["tokens"] == row["witness_fp32"]["tokens"]
    assert np.array(row["witness"]["tokens"]).shape == (cs.WITNESS_BATCH, 4)
    assert (row["witness"]["dtype"], row["witness_fp32"]["dtype"]) == ("torch.bfloat16",
                                                                       "torch.float32")


@pytest.mark.parametrize("key", MESHES)
def test_sharded_decode_repeats_bit_for_bit(rehearsal, key):
    """(iii)"""
    row = rehearsal[1]["f"][key]
    for name in ("witness", "witness_fp32"):
        assert row[name]["repeat_bitwise"], (name, row[name])
        assert row[name]["rel_rms_err_again"] == row[name]["rel_rms_err"]


@pytest.mark.parametrize("key", MESHES)
def test_batch_split_control_reads_a_finite_distance(rehearsal, key):
    """(iv)"""
    row = rehearsal[1]["f"][key]
    bf16 = row["witness"]["controls"]["batch_split"]
    assert len(bf16["rel_rms_err"]) == 4 and all(map(math.isfinite, bf16["rel_rms_err"]))
    fp32 = row["witness_fp32"]["controls"]["batch_split"]
    assert fp32["tolerance_share"] <= 1.0
    assert max(fp32["rel_rms_err"]) <= cs.FP32_MODEL["rel_rms"]
    assert row["witness_fp32"]["tolerance"] == cs.FP32_MODEL


@pytest.mark.parametrize("key, control", [("4x1", "batch_split"), ("2x2", "score_split")])
def test_the_control_that_does_a_meshs_arithmetic_gives_its_logits(rehearsal, key, control):
    witness = rehearsal[1]["f"][key]["witness"]
    assert sorted(witness["controls"]) == (["batch_split", "score_split"] if key == "2x2"
                                           else ["batch_split"])
    assert witness["mesh_vs_controls"][control] == [0.0] * 4
    assert witness["rel_rms_err"] == witness["controls"][control]["rel_rms_err"]


@pytest.mark.parametrize("parts", [2, 4])
def test_split_head_vector_computes_the_same_attention(parts):
    """The score-split control's attention against the port's one-device
    ``_grouped_attend`` on the same fp32 inputs: the same function, its
    sums in another order; the port's own is back after the block."""
    from repro_torch.models import attention

    gen = torch.Generator().manual_seed(0)
    b, s, g, r, d = 2, 24, 2, 3, 16
    qg = torch.randn(b, 1, g, r, d, generator=gen)
    k, v = (torch.randn(b, s, g, d, generator=gen) for _ in range(2))
    valid = torch.arange(s) <= 20
    want = attention._grouped_attend(qg, k, v, valid)
    saved = attention._grouped_attend
    with cs.split_head_vector(parts):
        got = attention._grouped_attend(qg, k, v, valid)
    assert attention._grouped_attend is saved
    assert got.shape == want.shape
    assert float((got - want).norm() / want.norm()) <= 1e-6
