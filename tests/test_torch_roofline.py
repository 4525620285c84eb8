"""The port's roofline counting (``repro_torch.launch.roofline``), mirroring
``tests/test_roofline.py`` on the reference's HLO walker: the same loop of
products, the same collectives and the same in-place update, counted by
running them under ``analyze_step``, and the same roofline terms on the
H100's figures.

The collectives run on a fake process group, which is process-global, so
the counting runs in a subprocess (the dry-run isolation rule).
"""

import json
import subprocess
import sys
import textwrap

import pytest

import conftest
from repro.configs import SHAPES as JX_SHAPES
from repro.configs import cells
from repro.launch import roofline as jx_rl
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.launch.roofline import HW, Roofline, model_flops_for_cell

_COUNT = textwrap.dedent(
    """
    import json
    import torch
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.roofline import analyze_step

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)

    def body(a, w):
        x = a
        for _ in range(5):
            ag = torch.empty(4, 64)
            dist.all_gather_into_tensor(ag, x.reshape(2, 64))     # (4, 64) from 2 x (2, 64)
            x = x @ w
        out = x.clone()
        dist.all_reduce(out)
        return out

    def slice_write(a, u):
        a[3:4] = u

    def index_write(a, u):
        a.index_copy_(0, torch.tensor([3]), u)

    loop = analyze_step(body, torch.ones(4, 32), torch.ones(32, 32))
    rows = {"loop": loop.__dict__}
    for name, fn in (("slice", slice_write), ("index", index_write)):
        rows[name] = analyze_step(fn, torch.zeros(1024, 1024), torch.ones(1, 1024)).__dict__
    print(json.dumps(rows))
    """
)


@pytest.fixture(scope="module")
def counted() -> dict:
    proc = subprocess.run([sys.executable, "-c", _COUNT], env=conftest.multidevice_subprocess_env(),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_loop_flops(counted):
    loop = counted["loop"]
    # 2 * (4*32 out) * 32 contraction = 8192 flops x 5 iterations
    assert loop["flops_per_chip"] == 2 * 4 * 32 * 32 * 5
    assert loop["max_loop_mult"] == 1          # eager runs every iteration


def test_collective_accounting(counted):
    loop = counted["loop"]
    # all-gather inside the loop: 4*64*4B = 1024 B x 5; all-reduce outside:
    # 4*32*4 = 512 B x2 (RS+AG phases)
    assert loop["collectives"]["all-gather"] == 1024 * 5
    assert loop["collectives"]["all-reduce"] == 512 * 2
    assert loop["collective_counts"]["all-gather"] == 5
    assert loop["collective_counts"]["all-reduce"] == 1
    assert loop["collective_bytes_per_chip"] == 1024 * 5 + 512 * 2


@pytest.mark.parametrize("form", ["slice", "index"])
def test_update_counted_at_update_bytes(counted, form):
    # 2x the 4 KiB update, NOT 2x the 4 MiB buffer (written in place)
    assert counted[form]["hbm_bytes_per_chip"] == 2 * 1024 * 4


def test_peak_counts_the_arguments_and_what_lives_at_once(counted):
    loop = counted["loop"]
    args = 4 * 32 * 4 + 32 * 32 * 4
    assert loop["peak_bytes"] > args and loop["output_bytes"] == 4 * 32 * 4
    assert counted["slice"]["peak_bytes"] == 1024 * 1024 * 4 + 1024 * 4


def test_roofline_terms_and_bottleneck():
    r = Roofline(
        flops_per_chip=HW["peak_flops"],            # 1 s of compute
        hbm_bytes=HW["hbm_Bps"] / 2,                # 0.5 s of memory
        collective_bytes=HW["node_link_Bps"] * 2,   # 2 s of collectives across nodes
        chips=256,
        model_flops=HW["peak_flops"] * 256 / 2,     # 0.5 s ideal
        collectives={},
    )
    assert r.bottleneck == "collective"
    assert abs(r.t_compute - 1.0) < 1e-9
    assert abs(r.t_collective - 2.0) < 1e-9
    assert abs(r.roofline_fraction - 0.25) < 1e-9
    assert abs(r.useful_flop_ratio - 0.5) < 1e-9


def test_a_mesh_within_one_node_takes_nvlink():
    r = Roofline(flops_per_chip=0.0, hbm_bytes=0.0, collective_bytes=HW["nvlink_Bps"],
                 chips=4, model_flops=0.0, collectives={})
    assert r.link_Bps == 450e9 and abs(r.t_collective - 1.0) < 1e-12
    assert r.bottleneck == "collective"


def test_h100_figures():
    assert HW["peak_flops"] == 989e12 and HW["hbm_Bps"] == 3.35e12
    assert HW["node_link_Bps"] == 50e9 and HW["cards_per_node"] == 8


@pytest.mark.parametrize("cell", cells(), ids="/".join)
def test_model_flops_equal_the_reference(cell):
    from repro.configs import ARCHS as JX_ARCHS

    name, shape = cell
    assert model_flops_for_cell(ARCHS[name], SHAPES[shape]) == \
        jx_rl.model_flops_for_cell(JX_ARCHS[name], JX_SHAPES[shape])
