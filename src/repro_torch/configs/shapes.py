"""Assigned input-shape set (applies to every LM-family architecture).

    train_4k     seq 4,096   global_batch 256   -> lowers train_step
    prefill_32k  seq 32,768  global_batch 32    -> lowers prefill_step
    decode_32k   seq 32,768  global_batch 128   -> lowers serve_step (1 new
                                                   token, cache of seq_len)
    long_500k    seq 524,288 global_batch 1     -> serve_step; sub-quadratic
                                                   archs only (SSM/hybrid)
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


TRAIN_4K = ShapeSpec("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524288, 1, "decode")

ALL_SHAPES: Tuple[ShapeSpec, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def get_shape(name: str) -> ShapeSpec:
    for s in ALL_SHAPES:
        if s.name == name:
            return s
    raise KeyError(f"unknown shape {name!r}; have {[s.name for s in ALL_SHAPES]}")


def shape_applicable(cfg, shape: ShapeSpec) -> Tuple[bool, str]:
    """(runs?, reason). long_500k only for sub-quadratic archs (DESIGN.md
    §Arch-applicability); decode shapes skip encoder-only archs (none in
    this pool)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "full-attention arch: 500k decode needs sub-quadratic attention"
    return True, ""
