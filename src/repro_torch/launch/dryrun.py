"""One-card dry run: what every (architecture x input shape) cell costs on
one H100, read off its step run on ``device="meta"`` tensors.

Counterpart of ``repro.launch.dryrun``. Where the reference lowers and
compiles each cell's step for a TPU pod and reads XLA's cost and memory
analyses, this runs the same step (``make_train_step`` with remat, or
``prefill``, or ``decode_step``) on meta tensors, which carry shapes and
dtypes and no storage, under ``launch.cost.CostCounter``. The hand-written
kernels launch nothing on meta: each wrapper adds its ``kernels.cost``
count instead. So a cell of any size -- deepseek-v2-236b's ~472 GB of
weights included -- is counted on a CPU in seconds.

    python -m repro_torch.launch.dryrun [--arch A] [--shape S] [--out DIR] [--force]
                                        [--multi-pod | --both-meshes]
                                        [--cells ARCH:SHAPE ...]

writes ``{out}/{arch}__{shape}__h100x1.json`` per cell, in the reference's
record keys, so ``benchmarks/roofline_report.load_cells`` reads it
unchanged: argument and output bytes are the unique storages of the step's
inputs and results; ``temp_size_in_bytes`` is the counter's peak of live
storage (an estimate, marked so in ``memory_analysis_source``); the
collective fields are 0 (one card). ``counts_from`` names the dispatch
counter, and ``kernels`` holds each hand-written kernel's calls, bytes and
operations. Resumable: a cell whose record exists is read back unless
``--force``. Exits non-zero if any cell fails.

The pod cells (``--multi-pod``: 2 x 16 x 16, ``--both-meshes``: 16 x 16
and 2 x 16 x 16; the reference's ``pod2x16x16`` / ``pod16x16``) run
the same step on one process over a FAKE process group of 256 or 512 ranks
(``launch.mesh.start_fake_group``): params, caches, train states and inputs
are meta DTensors laid out by ``launch/sharding.py``'s rules (FSDP where
``needs_fsdp``), DTensor's propagation plays GSPMD's part, and the step
runs under ``CostCounter`` (its per-device ops: rank 0's shards) and
``CollectiveCounter`` (the collectives rank 0 issues, in program order).
Each writes ``{arch}__{shape}__h100x16x16.json`` / ``__h100x2x16x16.json``
with the reference's keys: per-device FLOPs and bytes, the local shards'
argument bytes, collective bytes and counts by op, ``n_devices``,
``fsdp``, plus ``local_map_sites`` (the functions run per shard under
``local_map``) and ``collective_max_bytes`` (the largest one operand).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
from typing import Any, Dict, Tuple

import torch

from repro_torch import dtensor as dtm
from repro_torch.configs import (
    ALL_SHAPES,
    ASSIGNED_ARCHS,
    ShapeSpec,
    get_config,
    get_shape,
    shape_applicable,
)
from repro_torch.core.workload import model_flops_per_token
from repro_torch.launch import sharding as S
from repro_torch.launch.cost import CollectiveCounter, CostCounter
from repro_torch.launch.mesh import (
    H100X1,
    make_production_mesh,
    pod_mesh_record,
    start_fake_group,
)
from repro_torch.launch.specs import (
    abstract_decode_cache,
    abstract_params,
    abstract_prefill_cache,
    abstract_train_state,
    input_specs,
)
from repro_torch.models import decode_step, prefill
from repro_torch.models.config import ModelConfig
from repro_torch.training import tree as T
from repro_torch.training.optimizer import AdamW, wsd_schedule
from repro_torch.training.train import make_train_step

DEFAULT_OUT = "results/dryrun"
COUNTS_FROM = ("torch dispatch counter over a meta-tensor step (launch/cost.py): matmul "
               "FLOPs by torch.utils.flop_counter, bytes of every op's inputs and outputs "
               "(unfused), hand-written kernels by kernels/cost.py")
POD_COUNTS_FROM = ("; per device: rank 0's ops on its shards of meta DTensors over a fake "
                   "process group, collectives by launch/cost.py::CollectiveCounter")
TEMP_SOURCE = ("estimate: peak bytes of live storages allocated by the step (freed when "
               "Python drops them; no caching allocator), outputs included")


def _tensors(tree) -> list:
    """The tensor leaves; a DTensor's local shard in its place."""
    return [t.to_local() if dtm.is_dtensor(t) else t
            for t in T.leaves(tree) if isinstance(t, torch.Tensor)]


def storage_bytes(tree) -> int:
    """Bytes of the distinct storages under ``tree`` (a view counts once; a
    DTensor counts its local shard)."""
    seen = {}
    for t in _tensors(tree):
        st = t.untyped_storage()
        seen[id(st)] = st.nbytes()
    return sum(seen.values())


def cell_args(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """The step's arguments on meta, by name, as the reference lowers them:
    train (state, batch); prefill (params, inputs, cache, enc_states: None
    without media tokens); decode (params, token, cache, lengths)."""
    specs = input_specs(cfg, shape)
    if shape.kind == "train":
        return {"state": abstract_train_state(cfg, AdamW()), "batch": specs}
    if shape.kind == "prefill":
        return {"params": abstract_params(cfg), "inputs": specs["inputs"],
                "cache": abstract_prefill_cache(cfg, shape),
                "enc_states": specs.get("enc_states")}
    if shape.kind == "decode":
        return {"params": abstract_params(cfg), "token": specs["token"],
                "cache": abstract_decode_cache(cfg, shape), "lengths": specs["lengths"]}
    raise ValueError(shape.kind)


def distribute_cell_args(a: Dict[str, Any], mesh, *, fsdp: bool):
    """``cell_args`` laid out on ``mesh`` by the rules, as the reference's
    ``in_shardings``: params (or the train state) by ``param_shardings`` /
    ``state_shardings``, caches by ``cache_shardings``, inputs by
    ``batch_shardings``."""
    out = {}
    for k, v in a.items():
        if v is None:
            out[k] = None
        elif k == "state":
            out[k] = S.distribute(v, S.state_shardings(v, mesh, fsdp=fsdp), mesh)
        elif k == "params":
            out[k] = S.distribute(v, S.param_shardings(v, mesh, fsdp=fsdp), mesh)
        elif k == "cache":
            out[k] = S.distribute(v, S.cache_shardings(v, mesh), mesh)
        else:
            out[k] = S.distribute(v, S.batch_shardings(v, mesh), mesh)
    return out


def build_cell(arch: str, shape, *, cfg: ModelConfig | None = None, mesh=None
               ) -> Tuple[CostCounter, Dict[str, Any]]:
    """Run one cell's step on meta tensors under a ``CostCounter`` -> (the
    counter, meta). ``shape`` is a ``ShapeSpec`` or the name of one of
    ``ALL_SHAPES``; ``cfg`` overrides ``get_config(arch)`` (tests pass a
    reduced config). The train step is the reference's: ``make_train_step``
    with remat, one microbatch, ``AdamW()`` and ``wsd_schedule(3e-4, 100,
    10_000, 1_000)``. meta: cfg, shape, tokens_per_step, argument_bytes,
    output_bytes.

    With a ``mesh`` (a ``DeviceMesh`` over a fake group) the arguments are
    DTensors laid out by the rules and the step runs under a
    ``CollectiveCounter`` too; every count is then rank 0's, and meta adds
    fsdp, collectives (its ``CollectiveStats``) and local_map_sites."""
    cfg = cfg if cfg is not None else get_config(arch)
    shape = shape if isinstance(shape, ShapeSpec) else get_shape(shape)
    a = cell_args(cfg, shape)
    fsdp = None
    if mesh is not None:
        fsdp = S.needs_fsdp(cfg, mesh)
        a = distribute_cell_args(a, mesh, fsdp=fsdp)
    if shape.kind == "train":
        step = make_train_step(cfg, AdamW(), wsd_schedule(3e-4, 100, 10_000, 1_000),
                               remat=True, microbatches=1)
        run = lambda: step(a["state"], a["batch"])
        tokens = shape.global_batch * shape.seq_len
    elif shape.kind == "prefill":
        run = lambda: prefill(a["params"], cfg, a["inputs"], a["cache"],
                              enc_states=a["enc_states"])
        tokens = shape.global_batch * shape.seq_len
    else:
        run = lambda: decode_step(a["params"], cfg, a["token"], a["cache"], a["lengths"])
        tokens = shape.global_batch
    counter = CostCounter()
    counter.exclude(_tensors(a))
    collectives = CollectiveCounter()
    dtm.SITES.clear()
    with contextlib.nullcontext() if shape.kind == "train" else torch.no_grad(), counter, \
            collectives if mesh is not None else contextlib.nullcontext():
        out = run()
    meta = {"cfg": cfg, "shape": shape, "tokens_per_step": tokens,
            "argument_bytes": storage_bytes(a), "output_bytes": storage_bytes(out)}
    if mesh is not None:
        meta.update(fsdp=fsdp, collectives=collectives.stats(),
                    local_map_sites=sorted(dtm.SITES))
    return counter, meta


def cell_path(out_dir: str, arch: str, shape_name: str, mesh_name: str = H100X1.name) -> str:
    return os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_name}.json")


def pod_mesh(multi_pod: bool):
    """The production mesh over a fake group of its size, on this process."""
    start_fake_group(pod_mesh_record(multi_pod).n_devices)
    return make_production_mesh(multi_pod=multi_pod)


def run_cell(arch: str, shape_name: str, *, out_dir: str = DEFAULT_OUT,
             force: bool = False, multi_pod: bool | None = None) -> Dict[str, Any]:
    """One cell's record, written to ``cell_path`` (read back if it exists
    and not ``force``). ``multi_pod`` None: the one-card cell; False / True:
    the 16 x 16 / 2 x 16 x 16 pod cell."""
    os.makedirs(out_dir, exist_ok=True)
    rec_mesh = H100X1 if multi_pod is None else pod_mesh_record(multi_pod)
    path = cell_path(out_dir, arch, shape_name, rec_mesh.name)
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    ok, reason = shape_applicable(cfg, shape)
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": rec_mesh.name,
        "n_devices": rec_mesh.n_devices, "applicable": ok, "unrolled_accounting": False,
    }
    if not ok:
        rec["skip_reason"] = reason
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        return rec
    try:
        t0 = time.time()
        mesh = None if multi_pod is None else pod_mesh(multi_pod)
        counter, meta = build_cell(arch, shape, mesh=mesh)
        counts = counter.record()
        tokens = meta["tokens_per_step"]
        mf = model_flops_per_token(cfg)
        rec.update({
            "ok": True,
            "t_trace_s": round(time.time() - t0, 2),
            "counts_from": COUNTS_FROM,
            "tokens_per_step": tokens,
            "hlo_flops_per_device": float(counts["flops"]),
            "hlo_bytes_per_device": float(counts["bytes"]),
            "flops_by_op": counts["flops_by_op"],
            "memory_analysis": {
                "argument_size_in_bytes": meta["argument_bytes"],
                "output_size_in_bytes": meta["output_bytes"],
                "temp_size_in_bytes": counts["peak_bytes"],
            },
            "memory_analysis_source": {"temp_size_in_bytes": TEMP_SOURCE},
            "kernels": counts["kernels"],
            "collective_bytes_per_device": 0,
            "collective_count": 0,
            "collective_bytes_by_op": {},
            "collective_count_by_op": {},
            "model_flops_per_token": mf,
        })
        if mesh is not None:
            coll = meta["collectives"]
            rec.update({
                "fsdp": meta["fsdp"],
                "collective_bytes_per_device": coll.total_bytes,
                "collective_count": coll.total_count,
                "collective_bytes_by_op": coll.bytes_by_op,
                "collective_count_by_op": coll.count_by_op,
                "collective_max_bytes": max((b for _, b in coll.schedule), default=0),
                "local_map_sites": meta["local_map_sites"],
                "counts_from": COUNTS_FROM + POD_COUNTS_FROM,
            })
        # train = 6 N_active tokens (forward and backward); inference 2 N_active tokens
        rec["model_flops_per_step"] = mf * tokens * (1.0 if shape.kind == "train" else 1.0 / 3.0)
    except Exception as e:  # noqa: BLE001 -- a failed cell is recorded, the sweep goes on
        rec.update({"ok": False, "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-4000:]})
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def sweep(archs=None, shapes=None, *, out_dir: str = DEFAULT_OUT, force: bool = False,
          meshes=(None,), log=print) -> list:
    """Every (arch, shape, mesh) cell -> its record; ``log`` gets one line a
    cell. ``meshes``: None (one card), False (16 x 16), True (2 x 16 x 16)."""
    recs = []
    for arch in archs or ASSIGNED_ARCHS:
        for shape_name in shapes or [s.name for s in ALL_SHAPES]:
            for mp in meshes:
                rec = run_cell(arch, shape_name, out_dir=out_dir, force=force, multi_pod=mp)
                recs.append(rec)
                log(cell_line(rec))
    return recs


def cell_line(rec: Dict[str, Any]) -> str:
    """One log line for a record."""
    head = f"{rec['arch']} {rec['shape']} {rec['mesh']}"
    if not rec.get("applicable", True):
        return f"[SKIP] {head}: {rec.get('skip_reason')}"
    if not rec.get("ok"):
        return f"[FAIL] {head}: {rec.get('error')}"
    ma = rec["memory_analysis"]
    line = (f"[OK] {head}: trace {rec['t_trace_s']}s flops {rec['hlo_flops_per_device']:.3e} "
            f"bytes {rec['hlo_bytes_per_device']:.3e} args "
            f"{ma['argument_size_in_bytes'] / 1e9:.2f} GB temp~ "
            f"{ma['temp_size_in_bytes'] / 1e9:.2f} GB kernels "
            + json.dumps({k: v["calls"] for k, v in rec["kernels"].items()}))
    if rec["n_devices"] > 1:
        line += (f" coll {rec['collective_bytes_per_device'] / 1e6:.1f} MB "
                 f"{json.dumps(rec['collective_count_by_op'])}")
    return line


def main() -> None:
    ap = argparse.ArgumentParser(description="dry run on meta tensors: one card or a pod")
    ap.add_argument("--arch", default=None, help="architecture id (default: all assigned)")
    ap.add_argument("--shape", default=None, help="shape name (default: all)")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--multi-pod", action="store_true", help="the 2 x 16 x 16 mesh")
    ap.add_argument("--both-meshes", action="store_true", help="both pod meshes")
    ap.add_argument("--cells", nargs="+", metavar="ARCH:SHAPE",
                    help="only these cells (in place of --arch / --shape)")
    args = ap.parse_args()
    meshes = [False, True] if args.both_meshes else [True] if args.multi_pod else [None]
    if args.cells:
        recs = []
        for cell in args.cells:
            arch, shape = cell.split(":")
            recs += sweep([arch], [shape], out_dir=args.out, force=args.force, meshes=meshes)
    else:
        recs = sweep([args.arch] if args.arch else None,
                     [args.shape] if args.shape else None,
                     out_dir=args.out, force=args.force, meshes=meshes)
    n_fail = sum(1 for r in recs if r.get("applicable", True) and not r.get("ok"))
    if n_fail:
        raise SystemExit(f"{n_fail} cells failed")


if __name__ == "__main__":
    main()
