"""The JAX-free modules the port copies agree with their originals.

Each copy keeps the original's path and names with only its import lines
changed (checked on the text), and behaves the same on the same inputs:
every registry config field for field, the analytic workload / DVFS /
policy functions on several archs and levers, the block allocator under one
random operation sequence, the prefix index under another, and
``make_prompts`` byte for byte. ``training/data.py`` (``PackedLMStream``,
``make_prompts``), ``training/fault.py`` and ``training/__init__.py`` are
whole-file copies.
"""
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest

import repro.configs as jcfg
import repro.core.dvfs as jdvfs
import repro.core.energy as jenergy
import repro.core.policy as jpolicy
import repro.core.workload as jwork
import repro.hw.chips as jchips
import repro.serving.paged_cache as jpaged
import repro.serving.prefix as jprefix
import repro.training.data as jdata
import repro_torch.configs as tcfg
import repro_torch.core.dvfs as tdvfs
import repro_torch.core.energy as tenergy
import repro_torch.core.policy as tpolicy
import repro_torch.core.workload as twork
import repro_torch.hw.chips as tchips
import repro_torch.serving.paged_cache as tpaged
import repro_torch.serving.prefix as tprefix
import repro_torch.training.data as tdata

SRC = Path(__file__).resolve().parents[1] / "src"
VERBATIM = [
    "models/config.py", "hw/chips.py",
    "core/workload.py", "core/energy.py", "core/dvfs.py", "core/policy.py",
    "core/metering.py", "core/clock.py", "core/latency.py",
    "serving/paged_cache.py", "serving/controller.py",
    "core/traces.py", "serving/spec.py", "serving/router.py", "serving/autoscaler.py",
    "serving/prefix.py",
    "core/pareto.py", "core/crossover.py", "core/characterize.py", "core/hypotheses.py",
    "hw/roofline.py", "core/__init__.py",
    "configs/__init__.py", "configs/registry.py", "configs/shapes.py",
    "configs/paper_models.py", "configs/gemma_2b.py", "configs/gemma2_9b.py",
    "configs/mamba2_780m.py", "configs/minicpm_2b.py", "configs/musicgen_large.py",
    "configs/nemotron_4_15b.py", "configs/llama_3_2_vision_11b.py",
    "configs/deepseek_v2_236b.py", "configs/deepseek_v2_lite_16b.py",
    "configs/zamba2_1_2b.py",
    "training/data.py", "training/fault.py", "training/__init__.py",
    "launch/hlo_stats.py",
]
_IMPORT = re.compile(r"^\s*(from|import)\s+repro(_torch)?[.\s]")
ARCHS = ["gemma-2b", "qwen3-4b", "minicpm-2b", "mamba2-780m", "deepseek-v2-lite-16b"]


@pytest.mark.parametrize("rel", VERBATIM)
def test_copy_differs_only_in_import_lines(rel):
    orig = (SRC / "repro" / rel).read_text().splitlines()
    copy = (SRC / "repro_torch" / rel).read_text().splitlines()
    assert len(orig) == len(copy)
    for a, b in zip(orig, copy):
        if a != b:
            assert _IMPORT.match(a) and _IMPORT.match(b), (a, b)
            assert a.replace("repro.", "repro_torch.") == b, (a, b)


@pytest.mark.parametrize("arch", jcfg.list_archs())
def test_registry_configs_equal(arch):
    assert dataclasses.asdict(tcfg.get_config(arch)) == dataclasses.asdict(jcfg.get_config(arch))
    assert (dataclasses.asdict(tcfg.reduced_config(arch))
            == dataclasses.asdict(jcfg.reduced_config(arch)))


def _levers(mod):
    return [mod.Default(), mod.ClockLock(990.0), mod.ClockLock(1410.0), mod.PowerCap(400.0)]


@pytest.mark.parametrize("arch", ARCHS)
def test_workloads_resolve_and_best_clock_equal(arch):
    jc, tc = jcfg.get_config(arch), tcfg.get_config(arch)
    jm, tm = jenergy.EnergyModel(jchips.H200_SXM), tenergy.EnergyModel(tchips.H200_SXM)
    for batch, ctx in ((1, 512), (8, 1024), (32, 4096)):
        jw, tw = jwork.decode_workload(jc, batch, ctx), twork.decode_workload(tc, batch, ctx)
        assert dataclasses.asdict(jw) == dataclasses.asdict(tw)
        jp, tp = jwork.prefill_workload(jc, 1, ctx), twork.prefill_workload(tc, 1, ctx)
        assert dataclasses.asdict(jp) == dataclasses.asdict(tp)
        for jl, tl in zip(_levers(jdvfs), _levers(tdvfs)):
            assert (dataclasses.asdict(jdvfs.resolve(jm, jw, jl))
                    == dataclasses.asdict(tdvfs.resolve(tm, tw, tl)))
        assert (dataclasses.asdict(jpolicy.best_clock(jm, jw))
                == dataclasses.asdict(tpolicy.best_clock(tm, tw)))


def _drive_allocator(mod, seed):
    """A random alloc/free/retain/release/defrag sequence; returns every
    observable the allocator reports along the way."""
    rng = np.random.default_rng(seed)
    a = mod.BlockAllocator(24, 16)
    owned = {}
    log = []
    for step in range(200):
        op = rng.integers(0, 5)
        owner = int(rng.integers(0, 6))
        if op == 0:
            n = int(rng.integers(1, 4))
            if a.can_alloc(n):
                owned.setdefault(owner, []).extend(a.alloc(n, owner))
        elif op == 1:
            blk = a.alloc_one(owner)
            if blk is not None:
                owned.setdefault(owner, []).append(blk)
        elif op == 2 and owned.get(owner):
            a.free(owned.pop(owner), owner)
        elif op == 3 and owned.get(owner):
            other = (owner + 1) % 6
            blk = owned[owner][0]
            a.retain(blk, other)
            owned.setdefault(other, []).append(blk)
        elif op == 4:
            mapping = a.defrag()
            owned = {o: [mapping.get(b, b) for b in bs] for o, bs in owned.items()}
            log.append(sorted(mapping.items()))
        a.assert_invariants()
        log.append((a.free_blocks, a.used_blocks, a.blocks_for_tokens(step),
                    sorted((o, sorted(a.owned_by(o))) for o in range(6))))
    return log


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_block_allocator_behaves_the_same(seed):
    assert _drive_allocator(jpaged, seed) == _drive_allocator(tpaged, seed)
    assert tpaged.NULL_PAGE == jpaged.NULL_PAGE == 0


@pytest.mark.parametrize("arch,n,lo,hi,seed", [
    ("gemma-2b", 8, 64, 512, 0), ("gemma-2b", 6, 5, 40, 1), ("qwen3-4b", 5, 8, 48, 3),
])
def test_make_prompts_bytes_equal(arch, n, lo, hi, seed):
    cfg = jcfg.get_config(arch)
    jp = jdata.make_prompts(cfg, n, lo, hi, seed=seed)
    tp = tdata.make_prompts(tcfg.get_config(arch), n, lo, hi, seed=seed)
    assert [p.tobytes() for p in jp] == [p.tobytes() for p in tp]
    assert all(p.dtype == np.int32 for p in tp)


def _drive_prefix_index(paged, prefix, seed):
    """Random register / match / peek / evict / remap operations on a
    ``PrefixIndex`` over a ``BlockAllocator``; every observable along the
    way."""
    rng = np.random.default_rng(seed)
    alloc = paged.BlockAllocator(40, 4)
    index = prefix.PrefixIndex(alloc)
    stems = [rng.integers(1, 9, size=12) for _ in range(3)]
    log = []
    for step in range(60):
        op = rng.integers(0, 4)
        toks = np.concatenate([stems[rng.integers(0, 3)], rng.integers(1, 9, size=6)])
        if op == 0 and alloc.can_alloc(5):
            blocks = alloc.alloc(5, owner=step)
            n = int(rng.integers(4, 19))
            log.append(("reg", index.register(toks[:n], blocks, n)))
            alloc.free(blocks, owner=step)
        elif op == 1:
            hit = index.match(toks)
            log.append(("match", None if hit is None else dataclasses.astuple(hit)))
        elif op == 2:
            log.append(("peek", index.peek(toks), index.reclaimable_blocks()))
        else:
            log.append(("evict", index.evict_one(), index.held_blocks))
        if step % 17 == 16:
            mapping = alloc.defrag()
            log.append(("remap", index.remap(mapping), sorted(mapping.items())))
        log.append((alloc.free_blocks, sorted(index.blocks())))
    return log


@pytest.mark.parametrize("seed", [0, 1])
def test_prefix_index_behaves_the_same(seed):
    assert (_drive_prefix_index(jpaged, jprefix, seed)
            == _drive_prefix_index(tpaged, tprefix, seed))
