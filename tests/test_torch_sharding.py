"""The port's sharding rules against the reference's, spec for spec.

No process group: the port's rules take its ``AbstractMesh`` (axis names
and sizes), the reference's take ``repro.parallel.compat.abstract_mesh``.
The first tests mirror ``tests/test_sharding_rules.py`` on the port.  Then,
for every registered architecture on the production meshes (16, 16) and
(2, 16, 16) and the debug meshes (2, 2), (4, 1), (1, 4): ``param_specs`` of
the port's ``params_struct`` (``meta`` tensors) equals the reference's on
``jax.eval_shape(init_params)``, path for path; and for every ``SHAPES``
entry, ``data_batch_specs``, ``residual_spec``, ``moe_buffer_spec``,
``cache_specs``, ``input_specs``' shapes and dtypes, ``model_constraints``
and ``step_shardings`` equal the reference's.  A spec is compared in the
canonical form (a one-name tuple as the bare name).
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JX_ARCHS
from repro.configs.base import SHAPES as JX_SHAPES
from repro.launch import steps as jx_steps
from repro.parallel import sharding as jx_sh
from repro.parallel.compat import abstract_mesh
from repro_torch.configs import ARCHS
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.launch import mesh as pt_mesh
from repro_torch.launch import steps
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.sharding import P

MESH = sh.AbstractMesh((16, 16), ("data", "model"))
MESH3 = sh.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "4x1": ((4, 1), ("data", "model")),
          "1x4": ((1, 4), ("data", "model"))}
NAMES = sorted(ARCHS)


class _Leaf:
    def __init__(self, shape):
        self.shape = shape


# -- the reference's rule tests, on the port ------------------------------------------


def test_mesh_axes_detection():
    assert sh.MeshAxes.for_mesh(MESH).data == ("data",)
    assert sh.MeshAxes.for_mesh(MESH3).data == ("pod", "data")


def test_param_rules_shard_when_divisible():
    params = {
        "embed": {"table": _Leaf((64000, 4096))},
        "layers": {
            "attn": {"wq": {"w": _Leaf((48, 4096, 4096))}},
            "mlp": {"down": {"w": _Leaf((48, 11008, 4096))}},
        },
        "unembed": {"w": _Leaf((4096, 64000))},
        "ln": {"scale": _Leaf((4096,))},
    }
    specs = sh.param_specs(params, MESH)
    assert specs["embed"]["table"] == P("model", "data")
    assert specs["layers"]["attn"]["wq"]["w"] == P(None, "data", "model")
    assert specs["layers"]["mlp"]["down"]["w"] == P(None, "model", "data")
    assert specs["unembed"]["w"] == P("data", "model")
    assert specs["ln"]["scale"] == P(None)


def test_param_rules_fall_back_when_indivisible():
    specs = sh.param_specs({"w_odd": {"w": _Leaf((17, 33))}}, MESH)
    assert specs["w_odd"]["w"] == P(None)


def test_moe_expert_specs():
    params = {"w_gate": _Leaf((16, 6144, 10752)), "w_down": _Leaf((16, 10752, 6144))}
    specs = sh.param_specs(params, MESH)
    assert specs["w_gate"] == P("model", "data", None)
    assert specs["w_down"] == P("model", None, "data")


def test_batch_and_residual_specs():
    specs = sh.data_batch_specs({"tokens": (256, 4096)}, MESH)
    assert specs["tokens"] == P(("data",), None)
    specs1 = sh.data_batch_specs({"tokens": (1, 524288)}, MESH)
    assert specs1["tokens"] == P(None, None)
    assert sh.residual_spec(256, 4096, MESH) == P(("data",), "model", None)
    assert sh.residual_spec(1, 524288, MESH) == P(None, "model", None)


def test_cache_specs_never_shard_seq_and_find_batch():
    cache = {"k": _Leaf((32, 128, 32768, 8, 128))}   # (L, B, S, kv, hd)
    spec = sh.cache_specs(cache, MESH, max_len=32768, batch=128)["k"]
    assert spec[2] is None
    assert spec[1] in ("data", ("data",))
    assert spec[0] is None
    assert spec[4] == "model"
    mla = {"c": _Leaf((26, 128, 32768, 512))}
    spec = sh.cache_specs(mla, MESH, max_len=32768, batch=128)["c"]
    assert spec[3] == "model" and spec[1] in ("data", ("data",))
    assert spec[2] is None


def test_moe_buffer_spec():
    assert sh.moe_buffer_spec(16, MESH, 256) == P(("data",), "model", None, None)
    assert sh.moe_buffer_spec(10, MESH, 256) is None


# -- the port's own -------------------------------------------------------------------


def test_production_mesh_shapes_and_placements():
    assert pt_mesh.make_production_mesh().shape == {"data": 16, "model": 16}
    assert pt_mesh.make_production_mesh(multi_pod=True).shape == {"pod": 2, "data": 16,
                                                                   "model": 16}
    from torch.distributed.tensor import Replicate, Shard

    assert sh.placements(P(None, "data", "model"), MESH) == (Shard(1), Shard(2))
    assert sh.placements(P(("pod", "data"), None), MESH3) == (Shard(0), Shard(0), Replicate())
    assert sh.placements(P(None), MESH) == (Replicate(), Replicate())


def test_sharded_serve_step_names_the_next_slice():
    """The sharded serve step was the next slice of the port; it now runs on
    a (data, model) or (pod, data, model) mesh
    (``tests/test_torch_sharded_decode.py``), and a mesh of other axes is
    refused with the axes the steps take."""
    class _Mesh:
        mesh_dim_names = ("r",)

        def get_group(self, name):
            raise AssertionError("not reached")

        def size(self):
            return 4

    with pytest.raises(NotImplementedError, match="'data', 'model'"):
        steps.make_serve_step(ARCHS["yi-9b"], SHAPES["decode_32k"], _Mesh())
    with pytest.raises(TypeError):
        steps.make_train_step(ARCHS["yi-9b"], SHAPES["train_4k"], MESH)


def test_sharded_serve_step_refuses_a_cache_split_off_its_batch():
    """The rules find a cache's batch dim by its size: where a stacked axis
    is as long as the batch (zamba2's smoke cache has 2 groups of 2 layers)
    they split it over data, and the decode, which reads each shard's rows as
    the tokens' rows, refuses the cell; at another batch it takes it."""
    arch = ARCHS["zamba2-2.7b"]
    smoke = dataclasses.replace(arch, model=arch.smoke)
    for batch, refused in ((2, True), (4, False)):
        shape = ShapeConfig("decode_test", "decode", 16, batch)
        specs = sh.cache_specs(steps.cache_struct(smoke, shape),
                               sh.AbstractMesh((2, 2), ("data", "model")), 16, batch)
        if refused:
            with pytest.raises(NotImplementedError, match="batch dim"):
                steps._check_cache_specs(smoke.model, shape, specs, batch_split=True)
        else:
            steps._check_cache_specs(smoke.model, shape, specs, batch_split=True)


# -- against the reference --------------------------------------------------------------


def _canon(spec) -> tuple:
    if spec is None:
        return None
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else
                 (tuple(e) if isinstance(e, tuple) else e) for e in spec)


def _jx_path(path) -> str:
    return jx_sh._path_str(path)


def _jx_flat(tree, fn) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {_jx_path(path): fn(leaf) for path, leaf in flat}


def _pt_flat(tree, fn) -> dict:
    return {path: fn(leaf) for path, leaf in sh.leaves_with_path(tree)}


_STRUCTS = (jx_steps.params_struct, jx_steps.cache_struct, steps.params_struct,
            steps.cache_struct)


@functools.lru_cache(maxsize=None)
def _jx_params_struct(name):
    return _STRUCTS[0](JX_ARCHS[name])


@functools.lru_cache(maxsize=None)
def _pt_params_struct(name):
    return _STRUCTS[2](ARCHS[name])


@functools.lru_cache(maxsize=None)
def _jx_cache_struct(name, shape_name):
    return _STRUCTS[1](JX_ARCHS[name], JX_SHAPES[shape_name])


@functools.lru_cache(maxsize=None)
def _pt_cache_struct(name, shape_name):
    return _STRUCTS[3](ARCHS[name], SHAPES[shape_name])


@pytest.fixture
def cached_structs(monkeypatch):
    """Both packages' structs made once per arch (and shape) for the module."""
    monkeypatch.setattr(jx_steps, "params_struct", lambda arch: _jx_params_struct(arch.name))
    monkeypatch.setattr(jx_steps, "cache_struct",
                        lambda arch, shape: _jx_cache_struct(arch.name, shape.name))
    monkeypatch.setattr(steps, "params_struct", lambda arch: _pt_params_struct(arch.name))
    monkeypatch.setattr(steps, "cache_struct",
                        lambda arch, shape: _pt_cache_struct(arch.name, shape.name))


def _meshes(key):
    sizes, names = MESHES[key]
    return sh.AbstractMesh(sizes, names), abstract_mesh(sizes, names)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", NAMES)
def test_param_specs_match_reference(name, mesh, cached_structs):
    pt, jx = _meshes(mesh)
    got = _pt_flat(sh.param_specs(steps.params_struct(ARCHS[name]), pt), _canon)
    want = _jx_flat(jx_sh.param_specs(jx_steps.params_struct(JX_ARCHS[name]), jx), _canon)
    assert got == want


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _shapes(tree, flat) -> dict:
    return flat(tree, lambda leaf: (tuple(leaf.shape), _dtype_name(leaf.dtype)))


def _sharding_specs(tree, flat) -> dict:
    return flat(tree, lambda ns: _canon(ns.spec))


def _jx_named_flat(tree, fn) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
    return {_jx_path(path): fn(leaf) for path, leaf in flat}


def _pt_named_flat(tree, fn) -> dict:
    out = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{prefix}/{k}" if prefix else str(k))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{prefix}/{i}" if prefix else str(i))
        else:
            out[prefix] = fn(node)

    walk(tree, "")
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("name", NAMES)
def test_cell_specs_match_reference(name, shape, mesh, cached_structs):
    pt, jx = _meshes(mesh)
    arch, jarch = ARCHS[name], JX_ARCHS[name]
    cell, jcell = SHAPES[shape], JX_SHAPES[shape]
    # input_specs: every input's shape and dtype
    got_in, want_in = steps.input_specs(arch, shape), jx_steps.input_specs(jarch, shape)
    assert sorted(got_in) == sorted(want_in)
    for key in got_in:
        assert _shapes(got_in[key], _pt_flat) == _jx_flat(
            want_in[key], lambda leaf: (tuple(leaf.shape), str(leaf.dtype))), key
    # batch, residual, MoE buffer, cache
    shapes = {k: tuple(v.shape) for k, v in got_in["batch"].items()}
    assert {k: _canon(v) for k, v in sh.data_batch_specs(shapes, pt).items()} == {
        k: _canon(v) for k, v in jx_sh.data_batch_specs(shapes, jx).items()}
    b, s = cell.global_batch, cell.seq_len
    assert _canon(sh.residual_spec(b, s, pt)) == _canon(jx_sh.residual_spec(b, s, jx))
    experts = arch.model.moe_experts or 16
    assert _canon(sh.moe_buffer_spec(experts, pt, b)) == _canon(
        jx_sh.moe_buffer_spec(experts, jx, b))
    cache = steps.cache_struct(arch, cell)
    assert _pt_flat(sh.cache_specs(cache, pt, s, b), _canon) == _jx_flat(
        jx_sh.cache_specs(jx_steps.cache_struct(jarch, jcell), jx, s, b), _canon)
    # model_constraints
    (resid, ep, attn), (jresid, jep, jattn) = (steps.model_constraints(arch, cell, pt),
                                               jx_steps.model_constraints(jarch, jcell, jx))
    assert _canon(resid.spec) == _canon(jresid.spec)
    assert (ep is None) == (jep is None)
    if ep is not None:
        assert _canon(ep.spec) == _canon(jep.spec)
    assert (attn is None) == (jattn is None)
    if attn is not None:
        assert sorted(attn) == sorted(jattn)
        for key in attn:
            if key == "moe_ep":
                assert attn[key][1:] == (tuple(jattn[key][1]), jattn[key][2])
            else:
                assert _canon(attn[key].spec) == _canon(jattn[key].spec), key
    # step_shardings
    got_io = steps.step_shardings(arch, shape, pt)
    want_io = jx_steps.step_shardings(jarch, shape, jx)
    assert _pt_named_flat(got_io, lambda ns: _canon(ns.spec)) == _jx_named_flat(
        want_io, lambda ns: _canon(ns.spec))


@pytest.mark.parametrize("switch", ["REPRO_NO_ATTN_SPECS", "REPRO_NO_MOE_EP"])
def test_model_constraints_switches_match_reference(switch, monkeypatch):
    monkeypatch.setenv(switch, "1")
    pt, jx = _meshes("2x2")
    for name in ("deepseek-v2-lite-16b", "zamba2-2.7b", "yi-9b"):
        _, _, attn = steps.model_constraints(ARCHS[name], SHAPES["train_4k"], pt)
        _, _, jattn = jx_steps.model_constraints(JX_ARCHS[name], JX_SHAPES["train_4k"], jx)
        assert (attn is None) == (jattn is None)
        if attn is not None:
            assert sorted(attn) == sorted(jattn)


def test_params_struct_is_meta_and_matches_init_params_shapes():
    cfg = ARCHS["deepseek-v2-lite-16b"].smoke
    arch = type(ARCHS["deepseek-v2-lite-16b"])(model=cfg, smoke=cfg)
    struct = steps.params_struct(arch)
    from repro_torch.models import model as M

    real = M.init_params(cfg, 0, device="cpu")
    assert _pt_flat(struct, lambda t: (tuple(t.shape), t.device.type)) == _pt_flat(
        real, lambda t: (tuple(t.shape), "meta"))
    opt = steps.opt_state_struct(struct)
    assert opt["step"].device.type == "meta" and np.all(
        [t.device.type == "meta" for _, t in sh.leaves_with_path(opt["m"])])
    assert torch.empty(0).device.type == "cpu"
