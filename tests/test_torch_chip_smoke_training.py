"""``chip_smoke.py``'s phase 7, the training runtime, rehearsed on the CPU
(fixtures: ``tests/_torch_chip_smoke.py``): it passes as it is, and fails
on a dropped ``delta`` term, a remat recompute on other params, AdamW's
bias correction a step off, and a restore without ``seek``."""

import pytest
import torch

from _torch_chip_smoke import CPU

pytest_plugins = ["_torch_chip_smoke"]


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
    from repro_torch.kernels import flash_attention as fa

    monkeypatch.setattr(fa, "_row_dot", lambda out, dout: torch.zeros_like(out[..., 0]))


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
