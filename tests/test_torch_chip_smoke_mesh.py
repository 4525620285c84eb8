"""``chip_smoke.py``'s phase 8, the device mesh, rehearsed on the CPU: its
one-rank world on gloo and its 4-rank host world forked from the test's
process, which carries the planted faults (fixtures:
``tests/_torch_chip_smoke.py``).  It passes as it is, and fails on a
gradient left partial (each rank keeping its own share, unsummed), a
dropped ``q_offset``, a replicated leaf counted once per rank in the global
norm, and a reshard that drops a shard."""

import pytest

from _torch_chip_smoke import CPU

pytest_plugins = ["_torch_chip_smoke"]

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
