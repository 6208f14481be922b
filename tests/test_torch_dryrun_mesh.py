"""The port's pod dry run: cells on a ``DeviceMesh`` over a fake process
group, against the reference's probe.

* The reference probe's four cells (``tests/test_dryrun_integration.py``:
  gemma-2b ``decode_32k``, deepseek-v2-lite-16b ``decode_32k``,
  mamba2-780m ``long_500k``, minicpm-2b ``train_4k``) at full width on a
  fake 4 x 4 mesh, with the probe's own bounds: FLOPs > 0; gemma-2b's
  per-device decode FLOPs between expect / 4 and expect x 6, expect =
  2 * 2.5e9 * 128 / 16; minicpm-2b's train step issues collectives of more
  than 1e6 bytes; mamba2-780m's long-context step less than 1e9.
* Each cell's argument bytes are exactly the reference's: the sum over its
  arguments of ``NamedSharding(mesh, spec).shard_shape`` bytes under the
  reference's ``in_shardings``. No attention decode cell gathers its cache:
  its collectives do not change with the cache's length.
* On a mesh of one rank a cell issues no collective, and its FLOPs, bytes
  and argument bytes are the one-card (``h100x1``) cell's.
* The sweep writes one record a (cell, pod mesh), in the reference's keys,
  skipped exactly where ``shape_applicable`` skips (gemma-2b's decode
  shapes, on both meshes; the whole sweep is ``python -m
  repro_torch.launch.dryrun --both-meshes``).
"""
import json

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
from repro_torch.configs import ALL_SHAPES, ShapeSpec, get_config, shape_applicable
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as M

PROBE = [("gemma-2b", "decode_32k"), ("deepseek-v2-lite-16b", "decode_32k"),
         ("mamba2-780m", "long_500k"), ("minicpm-2b", "train_4k")]


@pytest.fixture(scope="module")
def meshes():
    made = {}

    def get(shape):
        if shape not in made:
            M.start_fake_group(int(np.prod(shape)))
            made.clear()
            made[shape] = M._mesh("cpu", shape, M.POD_AXES)
        return made[shape]

    yield get
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def probe(meshes):
    mesh = meshes((4, 4))
    return {cell: dryrun.build_cell(*cell, mesh=mesh) for cell in PROBE}


def _ref_arg_bytes(arch, shape_name, mesh_shape):
    """The reference's per-device argument bytes: its abstract arguments
    under its ``in_shardings`` (``build_lowered``'s), summed shard by shard."""
    cfg, shape = jconfigs.get_config(arch), jconfigs.get_shape(shape_name)
    n = int(np.prod(mesh_shape))
    jm = JMesh(np.array(jax.devices() * n).reshape(mesh_shape), M.POD_AXES)
    fsdp = jshard.needs_fsdp(cfg, jm)
    inp = jspecs.input_specs(cfg, shape)
    if shape.kind == "train":
        state = jspecs.abstract_train_state(cfg)
        pairs = [(state, jshard.state_shardings(state, jm, fsdp=fsdp)),
                 (inp, jshard.batch_shardings(inp, jm))]
    else:
        params = j_abstract_params(cfg)
        cache = (jspecs.abstract_decode_cache if shape.kind == "decode"
                 else jspecs.abstract_prefill_cache)(cfg, shape)
        pairs = [(params, jshard.param_shardings(params, jm, fsdp=fsdp)),
                 (cache, jshard.cache_shardings(cache, jm)),
                 (inp, jshard.batch_shardings(inp, jm))]
    total = 0
    for tree, sh in pairs:
        leaves = jax.tree.leaves(tree)
        shardings = jax.tree.leaves(sh, is_leaf=lambda x: isinstance(x, NamedSharding))
        for x, s in zip(leaves, shardings):
            total += int(np.prod(s.shard_shape(x.shape), dtype=np.int64)) * x.dtype.itemsize
    return total


def test_probe_cells_count_flops(probe):
    assert len(probe) == 4
    for cell, (counter, _) in probe.items():
        assert counter.flops > 0, cell


def test_decode_flops_scale_sane(probe):
    counter, _ = probe[("gemma-2b", "decode_32k")]
    expect = 2 * 2.5e9 * 128 / 16
    assert expect / 4 < counter.flops < expect * 6


def test_training_emits_gradient_collectives(probe):
    coll = probe[("minicpm-2b", "train_4k")][1]["collectives"]
    assert coll.total_count > 0 and coll.total_bytes > 1e6
    assert coll.bytes_by_op.get("reduce-scatter", 0) + coll.bytes_by_op.get("all-reduce", 0) > 0


def test_long_context_ssm_cell(probe):
    assert probe[("mamba2-780m", "long_500k")][1]["collectives"].total_bytes < 1e9


@pytest.mark.parametrize("cell", PROBE, ids=["|".join(c) for c in PROBE])
def test_argument_bytes_equal_the_reference_shard_shapes(probe, cell):
    assert probe[cell][1]["argument_bytes"] == _ref_arg_bytes(*cell, (4, 4))


@pytest.mark.parametrize("cell", PROBE[:2], ids=["|".join(c) for c in PROBE[:2]])
def test_decode_cells_never_gather_a_cache(meshes, probe, cell):
    """The attention decode cells split their caches' sequence over
    ``model``: the same step over a cache half as long issues the same
    collectives, byte for byte (a gathered cache would halve them)."""
    shape = next(s for s in ALL_SHAPES if s.name == cell[1])
    half = ShapeSpec("decode_16k", shape.seq_len // 2, shape.global_batch, "decode")
    _, meta = dryrun.build_cell(cell[0], half, mesh=meshes((4, 4)))
    assert meta["collectives"].schedule == probe[cell][1]["collectives"].schedule


@pytest.mark.parametrize("cell", PROBE, ids=["|".join(c) for c in PROBE])
def test_mesh_of_one_is_the_one_card_cell(meshes, cell):
    mesh = meshes((1, 1))
    dryrun.build_cell(*cell)                     # warm the per-device constant caches
    one, one_meta = dryrun.build_cell(*cell)
    got, meta = dryrun.build_cell(*cell, mesh=mesh)
    assert meta["collectives"].total_count == 0
    assert got.flops == one.flops
    assert got.bytes == one.bytes
    assert meta["argument_bytes"] == one_meta["argument_bytes"]
    assert {k: v["calls"] for k, v in got.kernels.items()} == {
        k: v["calls"] for k, v in one.kernels.items()}


def test_pod_sweep_records(tmp_path, meshes):
    """gemma-2b's decode shapes on both pod meshes: the reference's record
    keys, ``long_500k`` skipped as ``shape_applicable`` says, ``decode_32k``
    ok with collective figures and ``n_devices`` 256 / 512."""
    shapes = ["decode_32k", "long_500k"]
    recs = dryrun.sweep(["gemma-2b"], shapes, out_dir=str(tmp_path), meshes=(False, True),
                        log=lambda line: None)
    assert len(recs) == 2 * len(shapes)
    assert [r["applicable"] for r in recs] == [True, True, False, False]
    cfg = get_config("gemma-2b")
    for rec in recs:
        ok, _ = shape_applicable(cfg, next(s for s in ALL_SHAPES if s.name == rec["shape"]))
        assert rec["applicable"] == ok
        assert rec["n_devices"] == {"h100x16x16": 256, "h100x2x16x16": 512}[rec["mesh"]]
        if not ok:
            assert "skip_reason" in rec
            continue
        assert rec["ok"], rec.get("error")
        for key in ("hlo_flops_per_device", "hlo_bytes_per_device", "memory_analysis",
                    "collective_bytes_per_device", "collective_count",
                    "collective_bytes_by_op", "collective_count_by_op", "fsdp",
                    "local_map_sites"):
            assert key in rec, key
        assert rec["collective_count"] == sum(rec["collective_count_by_op"].values()) > 0
        assert json.loads(json.dumps(rec)) == rec
