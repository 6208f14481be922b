"""Causal prefill attention: the CUDA kernel of ``csrc/prefill_attn.cu`` on
a CUDA tensor, the plain PyTorch version of ``ref.py`` on a CPU tensor.

No Pallas kernel has this function: the kernel is the counterpart of the
JAX package's blocked jnp attention, ``repro.models.flash.flash_attention``.
On a CUDA tensor the wrapper launches the kernel or raises; there is no
fallback. It counts its launches in ``prefill_attention.launches`` (the CPU
path does not count). On a meta tensor (the dry run) it launches nothing
and counts no launch: it returns an empty meta output and adds its
``kernels.cost`` count to the active counter.

The kernel takes bf16 q (B,S,H,D), k and v (B,L,KV,D), contiguous, with
D in ``HEAD_DIMS`` and H a multiple of KV; query position ``i`` attends
keys ``kpos <= i`` (below L), the last ``window`` of them when ``window >
0``, with each score ``softcap * tanh(scale * q.k / softcap)`` when
``softcap > 0``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import cost
from repro_torch.kernels.common import check_launch, cuda_operand
from repro_torch.kernels.prefill_attn.ref import prefill_attention_ref

HEAD_DIMS = (64, 128, 256)   # the kernel's instantiations

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float] * 2 + [
    ctypes.c_int, ctypes.c_void_p]
_LAUNCHER = []


def _launcher():
    """The C launcher ``prefill_attention_bf16``, built and bound on first use."""
    if not _LAUNCHER:
        from repro_torch.kernels.build import library

        fn = library("prefill_attn").prefill_attention_bf16
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _LAUNCHER.append(fn)
    return _LAUNCHER[0]


def prefill_attention(q, k, v, *, scale: float, softcap: float = 0.0,
                      window: int = 0) -> torch.Tensor:
    """q (B,S,H,D), k and v (B,L,KV,D) -> (B,S,H,D): causal grouped
    attention of every query position over its keys."""
    if q.device.type == "cpu":
        return prefill_attention_ref(q, k, v, scale, softcap=softcap, window=window)
    b, s, h, d = q.shape
    l, kv = k.shape[1], k.shape[2]
    if q.device.type == "meta":
        cost.record("prefill_attention", cost.prefill_attention(
            b, s, l, h, kv, d, v.shape[-1], q.element_size(), window))
        return q.new_empty((b, s, h, v.shape[-1]))
    name = "prefill_attention"
    for t, what in ((q, "q"), (k, "k"), (v, "v")):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: {what} dtype {t.dtype}, expected torch.bfloat16")
    if d not in HEAD_DIMS or k.shape[-1] != d or v.shape[-1] != d:
        raise ValueError(f"{name}: head dims q {d}, k {k.shape[-1]}, v {v.shape[-1]} must "
                         f"be equal and one of {HEAD_DIMS}")
    if k.shape != v.shape or k.shape[0] != b or kv == 0 or h % kv:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: k and v must match, batch equal, H a "
                         "multiple of KV")
    if softcap < 0 or window < 0:
        raise ValueError(f"{name}: softcap={softcap} and window={window} must be >= 0")
    ptrs = [cuda_operand(t, what, name, q.device, align=16)
            for t, what in ((q, "q"), (k, "k"), (v, "v"))]
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _launcher()(*ptrs, out.data_ptr(), b, s, l, h, kv, d, float(scale), float(softcap),
                     int(window), stream)
    check_launch(rc, name)
    prefill_attention.launches += 1
    return out


prefill_attention.launches = 0
