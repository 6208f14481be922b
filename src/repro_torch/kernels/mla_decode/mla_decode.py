"""MLA latent-decode wrappers: the CUDA kernels of ``csrc/mla_decode.cu``
on a CUDA tensor, the plain PyTorch versions of ``ref.py`` on a CPU tensor.

Counterparts of the Pallas kernels ``repro.kernels.mla_decode.mla_decode``
``mla_latent_decode`` and ``mla_paged_latent_decode``. On a CUDA tensor a
wrapper launches its kernel or raises; there is no fallback. Each wrapper
counts its kernel launches in ``<wrapper>.launches`` (the CPU path does not
count). On a meta tensor (the dry run) a wrapper launches nothing and
counts no launch: it returns an empty meta output and adds its
``kernels.cost`` count to the active counter.

Contract (as the oracles): ``valid_len >= 1``; keys ``kpos < valid_len``
are attended; the result is (B, H, rank) in q's dtype. ``ckv`` and ``kr``
stay separate operands in the dense form too (the Pallas wrapper
concatenates them, copying the cache on every call). The bf16 kernels,
dense and paged, run both products on the tensor cores and round the
softmax probabilities once to bf16 for P.V, as the JAX model casts them to
the cache dtype; the fp32 kernels (the first design, on the CUDA cores)
keep them fp32.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import cost
from repro_torch.kernels.common import check_launch, cuda_operand
from repro_torch.kernels.mla_decode.ref import (
    mla_latent_decode_ref,
    mla_paged_latent_decode_ref,
)

MAX_HEADS = 128
MAX_RANK = 512
MAX_ROPE = 64
HEAD_GROUPS = (16, 8, 4)   # query heads per CTA, as instantiated in the source
TARGET_CTAS = 528          # four per SM of an H100 (two resident at a time)
TILE_KEYS = 32             # keys per tile of the kernel (TK in the source)
# the bf16 tensor-core kernel, dense and paged (tc::mla_tc_split_kernel)
TC_HEAD_GROUPS = (24, 16, 8)   # query heads per CTA: three, two or one n8 tile
TC_STEP = 32               # keys a step of its 4-warp CTA
TC_TARGET_CTAS = 132       # one per SM
TC_MIN_SPLIT_KEYS = 64

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 10
             + [ctypes.c_float, ctypes.c_void_p])
_LAUNCHERS = {}


def head_group(h: int, groups=HEAD_GROUPS) -> int:
    """Heads per CTA: the group of ``groups`` (HEAD_GROUPS, or TC_HEAD_GROUPS
    for the tensor-core kernel) that pads ``h`` least (the larger on a tie,
    which reads each key fewer times)."""
    return min(groups, key=lambda g: (-(-h // g) * g, -g))


def split_plan(ctas: int, extent: int, *, target: int = TARGET_CTAS,
               min_keys: int = TILE_KEYS, tile: int = TILE_KEYS):
    """(n_split, split_len) for ``ctas`` (batch, head-group) pairs over
    ``extent`` keys: enough splits to give the card about ``target`` CTAs,
    none shorter than ``min_keys`` keys (unless the extent is), each a whole
    number of ``tile``-key tiles."""
    n_split = max(1, min(-(-extent // min_keys), -(-target // ctas)))
    split_len = -(-extent // n_split)
    split_len = -(-split_len // tile) * tile
    return -(-extent // split_len), split_len


def tc_split_plan(ctas: int, extent: int):
    """``split_plan`` of the tensor-core kernel: whole TC_STEP-key steps, at
    least TC_MIN_SPLIT_KEYS keys, about TC_TARGET_CTAS CTAs in all."""
    return split_plan(ctas, extent, target=TC_TARGET_CTAS, min_keys=TC_MIN_SPLIT_KEYS,
                      tile=TC_STEP)


class Plan(NamedTuple):
    kernel: str          # the split kernel the C launcher runs for the dtype
    head_group: int      # query heads a CTA
    n_split: int
    split_len: int


def plan(dtype: torch.dtype, b: int, h: int, extent: int) -> Plan:
    """The split kernel and plan of a call over ``b`` requests of ``h``
    heads and ``extent`` keys (dense L, or paged nb * bs): bf16, dense or
    paged, runs ``mla_tc_split_kernel`` (TC_HEAD_GROUPS, whole TC_STEP-key
    steps); fp32 the first design, ``mla_split_kernel``."""
    if dtype == torch.bfloat16:
        hg = head_group(h, TC_HEAD_GROUPS)
        return Plan("mla_tc_split_kernel", hg, *tc_split_plan(b * -(-h // hg), extent))
    hg = head_group(h)
    return Plan("mla_split_kernel", hg, *split_plan(b * -(-h // hg), extent))


def _launcher(name: str, dtype: torch.dtype):
    """The C launcher ``<name>_<f32|bf16>``, built and bound on first use."""
    fn = _LAUNCHERS.get((name, dtype))
    if fn is None:
        from repro_torch.kernels.build import library

        fn = getattr(library("mla_decode"), f"{name}_{_SUFFIX[dtype]}")
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _LAUNCHERS[(name, dtype)] = fn
    return fn


def _launch(name, q_lat, q_rope, ckv, kr, valid_len, block_tables, extent, bs, nb, scale):
    if q_lat.dim() != 3 or q_rope.dim() != 3:
        raise ValueError(f"{name}: q_lat and q_rope must be (B, H, D)")
    b, h, rank = q_lat.shape
    rope = q_rope.shape[-1]
    if q_lat.dtype not in _SUFFIX:
        raise TypeError(f"{name}: dtype {q_lat.dtype} not supported (fp32, bf16)")
    for t, what in ((q_rope, "q_rope"), (ckv, "ckv"), (kr, "kr")):
        if t.dtype != q_lat.dtype:
            raise TypeError(f"{name}: {what} dtype {t.dtype} != q_lat dtype {q_lat.dtype}")
    if q_rope.shape[:2] != (b, h):
        raise ValueError(f"{name}: q_rope {tuple(q_rope.shape)} and q_lat "
                         f"{tuple(q_lat.shape)} differ in (B, H)")
    if not 1 <= h <= MAX_HEADS:
        raise ValueError(f"{name}: H={h} must be in [1, {MAX_HEADS}]")
    vec = 16 // q_lat.element_size()
    for d, what, most in ((rank, "rank", MAX_RANK), (rope, "rope", MAX_ROPE)):
        if d < vec or d > most or d % vec:
            raise ValueError(f"{name}: {what}={d} must be a multiple of {vec} "
                             f"and at most {most}")
    if ckv.dim() != 3 or ckv.shape[-1] != rank or kr.shape != ckv.shape[:-1] + (rope,):
        raise ValueError(f"{name}: ckv {tuple(ckv.shape)} and kr {tuple(kr.shape)} must "
                         f"be (.., .., {rank}) and (.., .., {rope}) over the same rows")
    if valid_len.shape != (b,):
        raise ValueError(f"{name}: valid_len shape {tuple(valid_len.shape)} != ({b},)")
    operands = [cuda_operand(t, what, name, q_lat.device, align=16)
                for t, what in ((q_lat, "q_lat"), (q_rope, "q_rope"), (ckv, "ckv"), (kr, "kr"))]
    operands.append(cuda_operand(valid_len, "valid_len", name, q_lat.device, torch.int32))
    operands.append(0 if block_tables is None else cuda_operand(
        block_tables, "block_tables", name, q_lat.device, torch.int32))

    _, hg, n_split, split_len = plan(q_lat.dtype, b, h, extent)
    out = torch.empty((b, h, rank), dtype=q_lat.dtype, device=q_lat.device)
    if n_split > 1:
        part_m = torch.empty((b * n_split * h,), dtype=torch.float32, device=q_lat.device)
        part_l = torch.empty_like(part_m)
        part_acc = torch.empty((b * n_split * h * rank,), dtype=torch.float32,
                               device=q_lat.device)
        scratch = [part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr()]
    else:
        scratch = [0, 0, 0]
    stream = torch.cuda.current_stream(q_lat.device).cuda_stream
    rc = _launcher(name, q_lat.dtype)(
        *operands, out.data_ptr(), *scratch, b, h, rank, rope, extent, bs, nb,
        split_len, n_split, hg, float(scale), stream)
    check_launch(rc, name)
    return out


def mla_latent_decode(q_lat, q_rope, ckv, kr, valid_len, *, scale: float) -> torch.Tensor:
    """q_lat (B,H,rank), q_rope (B,H,rope), ckv (B,L,rank), kr (B,L,rope),
    valid_len (B,) int32 -> (B,H,rank): the latent context of each query row
    over its keys ``< valid_len``."""
    if q_lat.device.type == "cpu":
        return mla_latent_decode_ref(q_lat, q_rope, ckv, kr, valid_len, scale)
    if q_lat.device.type == "meta":
        b, h, rank = q_lat.shape
        keys, _ = cost.meta_keys(b, ckv.shape[1])
        cost.record("mla_latent_decode", cost.mla_latent_decode(
            b, h, rank, q_rope.shape[-1], q_lat.element_size(), keys))
        return q_lat.new_empty((b, h, rank))
    if ckv.shape[0] != q_lat.shape[0]:
        raise ValueError("mla_latent_decode: cache batch != q batch")
    out = _launch("mla_latent_decode", q_lat, q_rope, ckv, kr, valid_len, None,
                  ckv.shape[1], 0, 0, scale)
    mla_latent_decode.launches += 1
    return out


def mla_paged_latent_decode(q_lat, q_rope, ckv_pages, kr_pages, block_tables, valid_len, *,
                            scale: float) -> torch.Tensor:
    """q_lat (B,H,rank), q_rope (B,H,rope), pages (P,bs,rank|rope),
    block_tables (B,nb) int32, valid_len (B,) -> (B,H,rank). The kernel reads
    the table itself and touches only entries below ``ceil(valid_len / bs)``;
    page 0 is the null page."""
    if q_lat.device.type == "cpu":
        return mla_paged_latent_decode_ref(q_lat, q_rope, ckv_pages, kr_pages, block_tables,
                                           valid_len, scale)
    if block_tables.dim() != 2 or block_tables.shape[0] != q_lat.shape[0]:
        raise ValueError("mla_paged_latent_decode: block_tables must be (B, nb) for q's B")
    nb = block_tables.shape[1]
    bs = ckv_pages.shape[1]
    if q_lat.device.type == "meta":
        b, h, rank = q_lat.shape
        keys, pages = cost.meta_keys(b, nb * bs, bs=bs)
        cost.record("mla_paged_latent_decode", cost.mla_paged_latent_decode(
            b, h, rank, q_rope.shape[-1], q_lat.element_size(), keys, pages))
        return q_lat.new_empty((b, h, rank))
    out = _launch("mla_paged_latent_decode", q_lat, q_rope, ckv_pages, kr_pages, valid_len,
                  block_tables, nb * bs, bs, nb, scale)
    mla_paged_latent_decode.launches += 1
    return out


mla_latent_decode.launches = 0
mla_paged_latent_decode.launches = 0
