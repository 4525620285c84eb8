"""``chip_smoke.py``'s checkpoint phase rehearsed on the CPU (fixtures:
``tests/_torch_chip_smoke.py``): it passes as it is, and fails on a leaf the
save drops, a restored byte flipped, a fourth node failure that does not
happen, and a verifier that ignores half of each tag."""

import pytest
import torch

from _torch_chip_smoke import CPU
from repro_torch.checkpoint import manager as pt_manager
from repro_torch.checkpoint.storage import StorageCluster
from repro_torch.kernels import ops

pytest_plugins = ["_torch_chip_smoke"]


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
