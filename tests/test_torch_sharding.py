"""The port's sharding rules (``runtime/sharding.py``) and cells
(``launch/specs.py``) against the JAX package's, in one process.

The rules read only a mesh's axis names and sizes, so both packages take
stand-ins for the production meshes: the JAX package's functions read
``mesh.axis_names`` and ``mesh.devices.shape``, the port's
``mesh.mesh_dim_names`` and ``mesh.shape``.  The JAX functions that wrap a
spec in a ``NamedSharding`` (which needs a real mesh) run with
``NamedSharding`` replaced by a function that returns the spec.

Every leaf of all ten architectures at published widths: the JAX leaves by
``jax.eval_shape`` of ``Model.init``, the port's parameters on ``meta``.
deepseek-v2-236b's ``eval_shape`` takes about 45 s on a CPU: the JAX leaves
are made once per module.
"""

import types

import numpy as np
import jax
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.configs import ARCHITECTURES as J_ARCHS, SHAPES as J_SHAPES
from repro.data.pipeline import make_batch_shapes as j_batch_shapes
from repro.launch import specs as j_specs
from repro.models.transformer import build_model as j_build
from repro.runtime import sharding as jsh

import repro_torch.configs as TC
from repro_torch import convert
from repro_torch.data.pipeline import make_batch_shapes as t_batch_shapes
from repro_torch.launch.specs import build_cell
from repro_torch.models.transformer import build_model as t_build
from repro_torch.runtime import sharding as tsh

ARCHS = sorted(J_ARCHS)
MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "2x4": ((2, 4), ("data", "model")),
    "pod2x4": ((2, 4), ("pod", "data")),
}


def j_mesh(name):
    shape, axes = MESHES[name]
    return types.SimpleNamespace(axis_names=axes, devices=np.empty(shape, object),
                                 shape=dict(zip(axes, shape)))


def t_mesh(name):
    shape, axes = MESHES[name]
    return types.SimpleNamespace(mesh_dim_names=axes, shape=shape)


def flat(tree) -> dict:
    """``{'/'-joined path: leaf}`` of a JAX tree."""
    return {jsh._path_str(p): x for p, x in jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}


@pytest.fixture(scope="module")
def jax_leaves():
    cache = {}

    def get(arch):
        if arch not in cache:
            model = j_build(J_ARCHS[arch])
            shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
            cache[arch] = {k: tuple(x.shape) for k, x in flat(shapes).items()}
        return cache[arch]

    return get


@pytest.fixture(scope="module")
def port_params():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = t_build(TC.get_config(arch), device="meta").init()
        return cache[arch]

    return get


@pytest.fixture
def specs_not_shardings(monkeypatch):
    """The JAX functions return bare specs (a stand-in mesh has no devices)."""
    for mod in (jsh, j_specs):
        monkeypatch.setattr(mod, "NamedSharding", lambda mesh, spec: spec)
    yield
    jsh.set_expert_sharding("ep_model")


def jax_spec(path, shape, mesh, *, fsdp, mode):
    jsh.set_expert_sharding(mode)
    try:
        return tuple(jsh.param_spec(path, shape, mesh, fsdp=fsdp))
    finally:
        jsh.set_expert_sharding("ep_model")


def padded(spec, rank):
    return tuple(spec) + (None,) * (rank - len(spec))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_spec_equals_jax_on_every_leaf(arch, mesh, jax_leaves, port_params):
    """The port's leaves are the JAX package's (paths and stacked shapes),
    ``param_spec`` is ``==`` JAX's on each, with FSDP on and off and both
    expert modes, and each parameter's spec with its stacked axes put back
    is its leaf's."""
    want = jax_leaves(arch)
    params = port_params(arch)
    shapes = convert.jax_leaf_shapes(params)
    assert {path: shape for path, shape in shapes.values()} == want
    jm, tm = j_mesh(mesh), t_mesh(mesh)
    for fsdp in (True, False):
        for mode in tsh.EXPERT_MODES:
            for path, shape in want.items():
                got = tsh.param_spec(path, shape, tm, fsdp=fsdp, expert_mode=mode)
                assert got == jax_spec(path, shape, jm, fsdp=fsdp, mode=mode), (path, fsdp, mode)
            per_param = tsh.param_specs(params, tm, fsdp=fsdp, expert_mode=mode)
            for name, spec in per_param.items():
                path, stacked = shapes[name]
                lead = len(stacked) - len(spec)
                full = padded(jax_spec(path, stacked, jm, fsdp=fsdp, mode=mode), len(stacked))
                if any(full[:lead]):
                    # FSDP took a stacked axis: only off the production
                    # meshes; the port replicates the layers along it
                    assert mesh in ("2x4", "pod2x4"), (name, full)
                    assert spec == full[lead:], name
                    continue
                assert (None,) * lead + spec == full, name


def test_xlstm_w_if_is_decided_on_the_stacked_leaf(port_params):
    """mlstm/w_if/w is (6, 7, 4096, 8): 1.38 M elements stacked, 32 768 a
    layer.  FSDP applies (stacked size >= 2^20) and shards d over "data";
    a rule applied to one layer's (4096, 8) would leave it replicated."""
    params = port_params("xlstm-1.3b")
    name = "mlstm.0.0.w_if.w"
    path, stacked = convert.jax_leaf_shapes(params)[name]
    assert (path, stacked) == ("mlstm/w_if/w", (6, 7, 4096, 8))
    assert tuple(params.get_parameter(name).shape) == (4096, 8)
    tm = t_mesh("16x16")
    assert tsh.param_spec(path, stacked, tm) == (None, None, "data", None)
    assert tsh.param_specs(params, tm)[name] == ("data", None)
    assert tsh.param_shardings(params, tm)[name] == (Shard(0), Replicate())
    assert tsh.param_spec(path, (4096, 8), tm) == (None, None)   # one layer's answer


def test_placements_follow_the_mesh_order():
    tm = t_mesh("2x16x16")
    assert tsh.placements((("pod", "data"), "model"), tm) == (Shard(0), Shard(0), Shard(1))
    assert tsh.placements((), tm) == (Replicate(),) * 3
    assert tsh.placements((None, "data"), tm) == (Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError):
        tsh.placements((("data", "pod"),), tm)
    with pytest.raises(ValueError):
        tsh.placements(("data", "data"), tm)
    with pytest.raises(ValueError):
        tsh.placements(("solve",), tm)
    assert tsh.logical_batch_spec(tm) == tuple(jsh.logical_batch_spec(j_mesh("2x16x16")))
    assert tsh.batch_axes(tm) == ("pod", "data")


def as_placements(spec_tree: dict, mesh) -> dict:
    return {k: tsh.placements(tuple(s), mesh) for k, s in flat(spec_tree).items()}


def port_placements(tree) -> dict:
    from repro_torch.checkpoint.store import flatten

    return dict(flatten(tree))


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_state_and_input_shardings_equal_jax(arch, mesh, specs_not_shardings):
    """Caches of ``init_cache`` and training batches at published widths,
    both ``prefer`` modes, ``shard_seq`` on and off."""
    jm, tm = j_mesh(mesh), t_mesh(mesh)
    j_model, t_model = j_build(J_ARCHS[arch]), t_build(TC.get_config(arch), device="meta")
    bsz, max_len = 32, 128
    j_cache = jax.eval_shape(lambda: j_model.init_cache(bsz, max_len))
    t_cache = t_model.init_cache(bsz, max_len)
    for prefer in ("largest", "last"):
        want = as_placements(jsh.state_shardings(j_cache, jm, batch_size=bsz, prefer=prefer), tm)
        got = port_placements(tsh.state_shardings(t_cache, tm, batch_size=bsz, prefer=prefer))
        assert got == want, prefer
    for shard_seq in (False, True):
        want = as_placements(jsh.input_shardings(
            j_batch_shapes(J_ARCHS[arch], 256, bsz), jm, shard_seq=shard_seq), tm)
        got = tsh.input_shardings(t_batch_shapes(TC.get_config(arch), 256, bsz), tm,
                                  shard_seq=shard_seq)
        assert got == want, shard_seq


def meta_leaves(tree):
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in meta_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in meta_leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def stripped(params, spec_tree, mesh) -> dict:
    """The JAX cell's parameter-tree specs per port parameter, stacked
    axes stripped, as placements."""
    specs = flat(spec_tree)
    out = {}
    for name, (path, stacked) in convert.jax_leaf_shapes(params).items():
        spec = padded(specs[path], len(stacked))
        out[name] = tsh.placements(spec[len(stacked) - params.get_parameter(name).ndim:], mesh)
    return out


@pytest.mark.parametrize("fsdp", [True, False, "zero1"])
@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
def test_build_cell_equals_jax_cell(mesh, fsdp, specs_not_shardings):
    """qwen2-7b at published widths: every argument of the three kinds is on
    ``meta`` (nothing allocated), the placements of parameters, moments,
    batch, cache and outputs equal the JAX cell's leaf for leaf, and each
    kind's step is the reference's (the serving steps run on DTensors in
    ``test_torch_sharded_serving.py``)."""
    jm, tm = j_mesh(mesh), t_mesh(mesh)
    for kind, shape_name in (("train", "train_4k"), ("prefill", "prefill_32k"),
                             ("decode", "decode_32k")):
        j_cell = j_specs.build_cell(J_ARCHS["qwen2-7b"], J_SHAPES[shape_name], jm, fsdp=fsdp)
        cell = build_cell(TC.get_config("qwen2-7b"), TC.SHAPES[shape_name], tm, fsdp=fsdp)
        assert cell.kind == j_cell.kind == kind
        leaves = meta_leaves(cell.arg_shapes)
        assert leaves and all(t.device.type == "meta" for t in leaves), kind
        params = cell.arg_shapes[0]
        assert cell.in_shardings[0] == stripped(params, j_cell.in_shardings[0], tm)
        assert cell.donate_argnums == j_cell.donate_argnums
        if kind == "train":
            j_opt = j_cell.in_shardings[1]
            for m in ("mu", "nu"):
                assert cell.in_shardings[1][m] == stripped(params, j_opt[m], tm), (m, fsdp)
            assert cell.in_shardings[1]["step"] == tsh.placements(tuple(j_opt["step"]), tm)
            assert cell.in_shardings[2] == as_placements(j_cell.in_shardings[2], tm)
            assert cell.out_shardings[2:] == tuple(
                tsh.placements(tuple(s), tm) for s in j_cell.out_shardings[2:])
        else:
            assert port_placements(cell.in_shardings[2]) == as_placements(
                j_cell.in_shardings[2], tm)
            assert cell.out_shardings[0] == tsh.placements(tuple(j_cell.out_shardings[0]), tm)
            assert cell.step_fn.__name__ == j_cell.step_fn.__name__ == f"{kind}_step"


@pytest.mark.parametrize("arch", ARCHS)
def test_build_cell_of_every_family_is_allocation_free(arch):
    """Reduced configs of every family: the three kinds build on ``meta``,
    each with its step: the training step (it runs on DTensors in
    ``test_torch_sharded_families.py``), the prefill and the decode step
    (``test_torch_sharded_serving.py``)."""
    tm = t_mesh("2x4")
    cfg = TC.reduce_config(TC.get_config(arch))
    for shape_name in ("train_4k", "prefill_32k", "decode_32k"):
        shape = TC.ShapeConfig(shape_name, TC.SHAPES[shape_name].kind, 64, 4)
        cell = build_cell(cfg, shape, tm)
        leaves = meta_leaves(cell.arg_shapes)
        assert leaves and all(t.device.type == "meta" for t in leaves)
        assert cell.step_fn.__name__ == f"{cell.kind}_step"
