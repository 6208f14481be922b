"""Flash-decode wrappers: the CUDA kernels of ``csrc/decode_attn.cu`` on a
CUDA tensor, the plain PyTorch versions of ``ref.py`` on a CPU tensor.

Counterparts of the Pallas kernels ``repro.kernels.decode_attn.decode_attn``
``decode_attention`` and ``paged_decode_attention``. On a CUDA tensor a
wrapper launches its kernel or raises; there is no fallback. Each wrapper
counts its kernel launches in ``<wrapper>.launches`` (the CPU path does not
count). On a meta tensor (the dry run) a wrapper launches nothing and
counts no launch: it returns an empty meta output and adds its
``kernels.cost`` count to the active counter (shape inference, not a
fallback).

Contract (as the oracles): ``valid_len >= 1``; keys ``kpos < valid_len``
are attended, and with ``window > 0`` only those ``kpos >= valid_len -
window``; with ``softcap > 0`` each score is ``softcap * tanh(scale * q.k /
softcap)`` (the model's logit softcap and sliding window, which the Pallas
kernels leave to jnp around them); the result has q's dtype. The bf16
kernels, dense and paged, run both products on the tensor cores and round
the softmax probabilities once to bf16 for P.V, as the JAX model casts them
to the value dtype; the fp32 kernels (the first design, on the CUDA cores)
keep them fp32.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import cost
from repro_torch.kernels.common import check_launch, cuda_operand
from repro_torch.kernels.decode_attn.ref import (
    decode_attention_ref,
    paged_decode_attention_ref,
)

MAX_HEAD_DIM = 256
MAX_GROUP = 16
TARGET_CTAS = 528          # four per SM of an H100
MIN_SPLIT_KEYS = 32        # two rounds of 4 keys for each warp of a 4-warp CTA
# the bf16 tensor-core kernel, dense and paged (tc_split_kernel)
TC_TILE = 64               # keys its 4-warp CTA takes a round, 16 a warp
TC_TARGET_CTAS = 132       # one per SM: at D = 256 its shared memory holds one
TC_MIN_SPLIT_KEYS = 64     # at least one tile a split

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 10
             + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_LAUNCHERS = {}


def split_plan(bkv: int, extent: int):
    """(n_split, split_len) for ``bkv`` (batch, kv-head) pairs over
    ``extent`` keys: enough splits to give the card about TARGET_CTAS CTAs,
    none shorter than MIN_SPLIT_KEYS keys."""
    n_split = max(1, min(extent // MIN_SPLIT_KEYS, -(-TARGET_CTAS // bkv)))
    split_len = -(-extent // n_split)
    return -(-extent // split_len), split_len


def tc_split_plan(bkv: int, extent: int):
    """(n_split, split_len) of the bf16 tensor-core kernel: splits of whole
    TC_TILE-key tiles, at least TC_MIN_SPLIT_KEYS keys, about TC_TARGET_CTAS
    CTAs in all."""
    n_split = max(1, min(-(-extent // TC_MIN_SPLIT_KEYS), -(-TC_TARGET_CTAS // bkv)))
    split_len = -(-extent // n_split)
    split_len = -(-split_len // TC_TILE) * TC_TILE
    return -(-extent // split_len), split_len


class Plan(NamedTuple):
    kernel: str          # the split kernel the C launcher runs for the dtype
    n_split: int
    split_len: int


def plan(dtype: torch.dtype, bkv: int, extent: int) -> Plan:
    """The split kernel and plan of a call over ``bkv`` (batch, kv-head)
    pairs and ``extent`` keys (dense L, or paged nb * bs): bf16, dense or
    paged, runs ``tc_split_kernel`` in splits of whole TC_TILE-key tiles;
    fp32 the first design, ``split_kernel``."""
    if dtype == torch.bfloat16:
        return Plan("tc_split_kernel", *tc_split_plan(bkv, extent))
    return Plan("split_kernel", *split_plan(bkv, extent))


def _launcher(name: str, dtype: torch.dtype):
    """The C launcher ``<name>_<f32|bf16>``, built and bound on first use."""
    fn = _LAUNCHERS.get((name, dtype))
    if fn is None:
        from repro_torch.kernels.build import library

        fn = getattr(library("decode_attn"), f"{name}_{_SUFFIX[dtype]}")
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _LAUNCHERS[(name, dtype)] = fn
    return fn


def _launch(name, q, k, v, valid_len, block_tables, extent, bs, nb, scale, softcap, window):
    b, h, dk = q.shape
    kv, dv = k.shape[2], v.shape[-1]
    if q.dtype not in _SUFFIX:
        raise TypeError(f"{name}: dtype {q.dtype} not supported (fp32, bf16)")
    for t, what in ((k, "k"), (v, "v")):
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: {what} dtype {t.dtype} != q dtype {q.dtype}")
    if h % kv or h // kv > MAX_GROUP:
        raise ValueError(f"{name}: H={h} must be KV={kv} times a group of at "
                         f"most {MAX_GROUP}")
    vec = 16 // q.element_size()
    for d, what in ((dk, "Dk"), (dv, "Dv")):
        if d > MAX_HEAD_DIM or d % vec:
            raise ValueError(f"{name}: {what}={d} must be a multiple of {vec} "
                             f"and at most {MAX_HEAD_DIM}")
    if k.shape[:-1] != v.shape[:-1]:
        raise ValueError(f"{name}: k {tuple(k.shape)} and v {tuple(v.shape)} differ "
                         "outside the head dim")
    if softcap < 0 or window < 0:
        raise ValueError(f"{name}: softcap={softcap} and window={window} must be >= 0")
    if valid_len.shape != (b,):
        raise ValueError(f"{name}: valid_len shape {tuple(valid_len.shape)} != ({b},)")
    operands = [cuda_operand(t, what, name, q.device, dtype, align=16)
                for t, what, dtype in ((q, "q", None), (k, "k", None), (v, "v", None))]
    operands.append(cuda_operand(valid_len, "valid_len", name, q.device, torch.int32))
    operands.append(0 if block_tables is None else cuda_operand(
        block_tables, "block_tables", name, q.device, torch.int32))

    g = h // kv
    _, n_split, split_len = plan(q.dtype, b * kv, extent)
    out = torch.empty((b, h, dv), dtype=q.dtype, device=q.device)
    if n_split > 1:
        part_m = torch.empty((b * kv * n_split * g,), dtype=torch.float32, device=q.device)
        part_l = torch.empty_like(part_m)
        part_acc = torch.empty((b * kv * n_split * g * dv,), dtype=torch.float32,
                               device=q.device)
        scratch = [part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr()]
    else:
        scratch = [0, 0, 0]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _launcher(name, q.dtype)(
        *operands, out.data_ptr(), *scratch, b, h, kv, dk, dv, extent, bs, nb,
        split_len, n_split, float(scale), float(softcap), int(window), stream)
    check_launch(rc, name)
    return out


def decode_attention(q, k, v, valid_len, *, scale: float, softcap: float = 0.0,
                     window: int = 0) -> torch.Tensor:
    """q (B,H,Dk), k (B,L,KV,Dk), v (B,L,KV,Dv), valid_len (B,) int32 ->
    (B,H,Dv): attention of each query row over its keys ``< valid_len``
    (the last ``window`` of them when ``window > 0``)."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, valid_len, scale, softcap=softcap, window=window)
    if q.device.type == "meta":
        b, h, dk = q.shape
        keys, _ = cost.meta_keys(b, k.shape[1], window)
        cost.record("decode_attention", cost.decode_attention(
            b, h, k.shape[2], dk, v.shape[-1], q.element_size(), keys))
        return q.new_empty((b, h, v.shape[-1]))
    if k.shape[0] != q.shape[0]:
        raise ValueError("decode_attention: cache batch != q batch")
    out = _launch("decode_attention", q, k, v, valid_len, None,
                  k.shape[1], 0, 0, scale, softcap, window)
    decode_attention.launches += 1
    return out


def paged_decode_attention(q, k_pages, v_pages, block_tables, valid_len, *,
                           scale: float, softcap: float = 0.0,
                           window: int = 0) -> torch.Tensor:
    """q (B,H,Dk), pages (P,bs,KV,D), block_tables (B,nb) int32, valid_len
    (B,) -> (B,H,Dv). The kernel reads the table itself and touches only
    entries below ``ceil(valid_len / bs)``; page 0 is the null page."""
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_pages, v_pages, block_tables,
                                          valid_len, scale, softcap=softcap, window=window)
    nb = block_tables.shape[1]
    bs = k_pages.shape[1]
    if q.device.type == "meta":
        b, h, dk = q.shape
        keys, pages = cost.meta_keys(b, nb * bs, window, bs)
        cost.record("paged_decode_attention", cost.paged_decode_attention(
            b, h, k_pages.shape[2], dk, v_pages.shape[-1], q.element_size(), keys, pages))
        return q.new_empty((b, h, v_pages.shape[-1]))
    if block_tables.shape[0] != q.shape[0]:
        raise ValueError("paged_decode_attention: block_tables batch != q batch")
    out = _launch("paged_decode_attention", q, k_pages, v_pages, valid_len,
                  block_tables, nb * bs, bs, nb, scale, softcap, window)
    paged_decode_attention.launches += 1
    return out


decode_attention.launches = 0
paged_decode_attention.launches = 0
