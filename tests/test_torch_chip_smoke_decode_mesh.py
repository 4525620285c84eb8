"""``chip_smoke.py``'s phase 9, decode on a device mesh, rehearsed on the
CPU: its 4-rank host world forked from the test's process (fixtures:
``tests/_torch_chip_smoke.py``).  It passes as it is, and fails on the
score all-reduce over model dropped, k rotated after its slice of the head
vector is cut, and the cache written unclamped at ``cur_len = Smax``."""

import math

import pytest

from _torch_chip_smoke import CPU

pytest_plugins = ["_torch_chip_smoke"]


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
