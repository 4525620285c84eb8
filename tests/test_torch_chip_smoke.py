"""``chip_smoke.py``'s checkpoint phase rehearsed on the CPU.

The phase function runs with small widths on ``torch.device("cpu")``,
where each wrapper runs its plain version; the test counts the matmul
wrapper's calls in place of its launches.  The phase must pass as it is,
and each of its checks must fail when its fault is planted: a leaf the
save drops, a restored byte flipped, a fourth node failure that does not
happen, a verifier that ignores half of each tag.
"""

import importlib.util
import types
from pathlib import Path

import pytest
import torch

from repro_torch.checkpoint import manager as pt_manager
from repro_torch.checkpoint.storage import StorageCluster
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
