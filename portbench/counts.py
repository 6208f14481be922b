"""The yardstick's frozen counts: the operations and bytes that a kernel call
or a model step must do, from the shapes of its inputs alone, and the peaks
of the card they are held against.

The kernel counts are copies of ``repro_torch/kernels/cost.py`` as it stood
when this benchmark was defined; a model step's counts are in
``stepcounts/<arch>.py``, written from a configuration's shapes. None reads
the program, so a change to the program cannot move the yardstick. Bytes:
every input read once and every output written once; operations: a
multiply-add counts two.
"""
from __future__ import annotations

import importlib
import math
from typing import Iterable, NamedTuple

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core peak, HBM3 bandwidth
PEAK_OPS = {"float32": 67e12, "tfloat32": 495e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12


class Cost(NamedTuple):
    bytes: int
    ops: int
    dtype: str


def bound_s(cost: Cost) -> float:
    """The least time the card could take: the larger of bytes over the HBM
    rate and operations over the peak of their type."""
    return max(cost.bytes / HBM_BYTES_PER_S, cost.ops / PEAK_OPS[cost.dtype])


def paged_decode_attention(b, h, kv, dk, dv, elem, keys, pages) -> Cost:
    """Kernel 2, paged GQA decode: q (B,H,Dk), the K/V rows of ``keys``,
    valid_len, ``pages`` table entries and the output; 2 H (Dk + Dv)
    operations a key."""
    nbytes = (b * h * dk * elem + keys * kv * (dk + dv) * elem + 4 * b
              + b * h * dv * elem + 4 * pages)
    return Cost(nbytes, 2 * keys * (h // kv) * kv * (dk + dv),
                "bfloat16" if elem == 2 else "float32")


def n_layers(cfg: dict) -> int:
    return sum(len(s["unit"]) * s["n_units"] for s in cfg["stages"])


def kernel2_call(cfg: dict, lengths: Iterable[int], block_size: int) -> Cost:
    """One layer's kernel-2 call of a decode step whose live rows hold
    ``lengths`` cached tokens each (each row attends lengths + 1 keys)."""
    ls = list(lengths)
    keys = sum(n + 1 for n in ls)
    pages = sum(math.ceil((n + 1) / block_size) for n in ls)
    return paged_decode_attention(len(ls), cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"],
                                  cfg["head_dim"], 2, keys, pages)


def step_counts(arch: str):
    """The module of ``stepcounts/<arch>.py``: ``decode_step(cfg, lengths)``
    and ``prefill(cfg, prompt_len)``, each a ``Cost``."""
    return importlib.import_module(f"portbench.stepcounts.{arch}")
