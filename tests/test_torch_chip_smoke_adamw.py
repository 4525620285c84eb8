"""``chip_smoke.py``'s phase 2 AdamW check (``adamw_against_plain``)
rehearsed on the CPU (fixtures: ``tests/_torch_chip_smoke.py``), where both
sides of the comparison are the plain loop: the check passes as it is, and
fails on an update that leaves a leaf's last value alone or decays every
leaf."""

import pytest
import torch

from repro_torch.kernels import adamw as ka
from repro_torch.optim.adamw import AdamWConfig

pytest_plugins = ["_torch_chip_smoke"]

#: stacked and unstacked leaves, one longer than a kernel tile plus the
#: check's edges, sizes off the vector width, and a 0-d leaf
SHAPES = [(2, 64, 300), (2, 64), (4097,), (3,), (1,), ()]
SAMPLES = 4096


def _tree():
    gen = torch.Generator().manual_seed(53)

    def draw(scale):
        return [torch.randn(shape, generator=gen).mul_(scale) for shape in SHAPES]

    params, grads, m = draw(0.02), draw(1e-3), draw(1e-4)
    v = [t.square_() for t in draw(1e-4)]
    return params, grads, {"m": m, "v": v, "step": torch.tensor(10, dtype=torch.int32)}, gen


def _last_value_left_alone(params, *args, **kwargs):
    kept = params[0].reshape(-1)[-1].clone()
    ka.adamw_step_plain(params, *args, **kwargs)
    params[0].reshape(-1)[-1] = kept


def _every_leaf_decayed(params, grads, ms, vs, *args, **kwargs):
    ka.adamw_step_plain(*([t.reshape(1, -1) for t in ts] for ts in (params, grads, ms, vs)),
                        *args, **kwargs)


@pytest.mark.parametrize("plant", [None, _last_value_left_alone, _every_leaf_decayed])
def test_adamw_sample_check_catches_a_planted_fault(smoke, monkeypatch, plant):
    monkeypatch.setattr(smoke, "ADAMW_SAMPLES", SAMPLES)
    if plant is not None:
        monkeypatch.setattr(ka, "adamw_step", plant)
    params, grads, opt, gen = _tree()
    edges = sum(2 * min(p.numel(), smoke.ADAMW_EDGE) for p in params)
    values = sum(p.numel() for p in params)
    drawn = sum(SAMPLES * p.numel() // values for p in params)
    got = smoke.adamw_against_plain(params, grads, opt, AdamWConfig(), ka.grad_norm(grads), gen)
    assert got["checked"] == edges + drawn
    assert (got["differ"] == 0) == (plant is None), got
