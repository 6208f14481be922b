"""The port's sharding rules against the reference's.

For every assigned architecture at full width (the port's meta trees
against the reference's ``abstract_params`` / ``abstract_train_state`` /
``abstract_decode_cache`` / ``input_specs``), on the 4 x 4, 16 x 16 and
2 x 16 x 16 meshes:

* the param specs (``fsdp`` on and off), the train-state specs, the decode
  caches' specs (each applicable decode shape) and every shape's batch specs
  equal the reference's ``NamedSharding.spec`` leaf for leaf, and
  ``needs_fsdp`` agrees; the reference's meshes are built from aliased CPU
  devices, as ``tests/test_sharding_launch.py`` builds them;
* on a ``DeviceMesh`` over a fake process group of the mesh's size, every
  DTensor ``launch.sharding.distribute`` makes has the local shape of the
  reference's ``NamedSharding.shard_shape``, and its placements read back
  as its spec.
"""
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding

import repro.configs as jconfigs
import repro.launch.sharding as jshard
import repro.launch.specs as jspecs
from repro.models import abstract_params as j_abstract_params
from repro_torch.configs import ALL_SHAPES, ASSIGNED_ARCHS, get_config, shape_applicable
from repro_torch.launch import mesh as M
from repro_torch.launch import sharding as S
from repro_torch.launch import specs
from repro_torch.training import tree as T

MESHES = {"4x4": ((4, 4), ("data", "model")),
          "16x16": (M.POD_SHAPE, M.POD_AXES),
          "2x16x16": (M.MULTI_POD_SHAPE, M.MULTI_POD_AXES)}
DECODE_SHAPES = [s for s in ALL_SHAPES if s.kind == "decode"]


def _jkey(k) -> str:
    for attr in ("key", "idx", "name"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    raise TypeError(k)


def _jspecs(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, NamedSharding))
    return {"/" + "/".join(_jkey(k) for k in path): tuple(s.spec) for path, s in flat}


def _tspecs(tree) -> dict:
    return {p: tuple(s) for p, s in zip(T.paths(tree), T.leaves(tree))}


@functools.lru_cache(maxsize=None)
def _jmesh(name):
    shape, axes = MESHES[name]
    n = int(np.prod(shape))
    return JMesh(np.array(jax.devices() * n).reshape(shape), axes)


def _tmesh(name):
    return M.MeshShape(MESHES[name][1], MESHES[name][0])


@functools.lru_cache(maxsize=None)
def _ref_trees(arch):
    cfg = jconfigs.get_config(arch)
    return {"params": j_abstract_params(cfg), "state": jspecs.abstract_train_state(cfg),
            "caches": {s.name: jspecs.abstract_decode_cache(cfg, jconfigs.get_shape(s.name))
                       for s in DECODE_SHAPES},
            "batches": {s.name: jspecs.input_specs(cfg, jconfigs.get_shape(s.name))
                        for s in ALL_SHAPES}}


@functools.lru_cache(maxsize=None)
def _port_trees(arch):
    cfg = get_config(arch)
    return {"params": specs.abstract_params(cfg), "state": specs.abstract_train_state(cfg),
            "caches": {s.name: specs.abstract_decode_cache(cfg, s) for s in DECODE_SHAPES},
            "batches": {s.name: specs.input_specs(cfg, s) for s in ALL_SHAPES}}


CASES = [(a, m) for a in ASSIGNED_ARCHS for m in MESHES]


@pytest.mark.parametrize("arch,mesh", CASES)
def test_specs_equal_the_reference(arch, mesh):
    jm, tm = _jmesh(mesh), _tmesh(mesh)
    ref, port = _ref_trees(arch), _port_trees(arch)
    for fsdp in (True, False):
        assert (_tspecs(S.param_shardings(port["params"], tm, fsdp=fsdp))
                == _jspecs(jshard.param_shardings(ref["params"], jm, fsdp=fsdp)))
        assert (_tspecs(S.state_shardings(port["state"], tm, fsdp=fsdp))
                == _jspecs(jshard.state_shardings(ref["state"], jm, fsdp=fsdp)))
    for name in port["caches"]:
        assert (_tspecs(S.cache_shardings(port["caches"][name], tm))
                == _jspecs(jshard.cache_shardings(ref["caches"][name], jm)))
    for name in port["batches"]:
        assert (_tspecs(S.batch_shardings(port["batches"][name], tm))
                == _jspecs(jshard.batch_shardings(ref["batches"][name], jm)))
    assert S.needs_fsdp(get_config(arch), tm) == jshard.needs_fsdp(
        jconfigs.get_config(arch), jm)


@pytest.fixture(scope="module")
def fake_meshes():
    """One fake-group ``DeviceMesh`` a mesh size, built on demand; the
    default group is put back down after the module."""
    made = {}

    def get(name):
        shape, axes = MESHES[name]
        M.start_fake_group(int(np.prod(shape)))
        made[name] = M._mesh("cpu", shape, axes)
        return made[name]

    yield get
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("arch,mesh", CASES)
def test_local_shapes_equal_the_reference_shard_shapes(arch, mesh, fake_meshes):
    dm, jm = fake_meshes(mesh), _jmesh(mesh)
    cfg = get_config(arch)
    fsdp = S.needs_fsdp(cfg, dm)
    port = _port_trees(arch)
    trees = [(port["params"], S.param_shardings(port["params"], dm, fsdp=fsdp))]
    trees += [(c, S.cache_shardings(c, dm)) for name, c in port["caches"].items()
              if shape_applicable(cfg, next(s for s in DECODE_SHAPES if s.name == name))[0]]
    for tree, sp in trees:
        placed = S.distribute(tree, sp, dm)
        for t, d, s in zip(T.leaves(tree), T.leaves(placed), T.leaves(sp)):
            want = NamedSharding(jm, jax.sharding.PartitionSpec(*s)).shard_shape(tuple(t.shape))
            assert tuple(d.to_local().shape) == tuple(want)
            assert tuple(d.shape) == tuple(t.shape)
            split = [[a for a, p in zip(dm.mesh_dim_names, d.placements)
                      if p.is_shard() and p.dim == dim] for dim in range(t.dim())]
            want_axes = [[] if e is None else [e] if isinstance(e, str) else list(e)
                         for e in tuple(s) + (None,) * (t.dim() - len(s))]
            assert split == want_axes
