"""Gated-delta-rule scan backward wrapper: the CUDA kernels of
``csrc/gdn_scan_bwd.cu`` on a CUDA tensor, the plain reverse scan
``ref.gdn_scan_bwd_ref`` on a CPU tensor.

The Pallas kernel ``repro.kernels.gdn.gdn.gdn_scan`` has no backward (the
JAX package differentiates its jnp scan); the port's forward on the card is
a kernel, so its gradient is one too. ``gdn.GdnScan`` calls it. On a CUDA
tensor the wrapper launches its kernels or raises; there is no fallback. It
counts its launches in ``gdn_scan_bwd.launches``, one a call (the CPU path
does not count).

The kernels take the chunked (WY) form of ``ref.gdn_scan_bwd_chunked_ref``
on the tensor cores, every product on fp16 hi + lo operands (its
``rounding="f16x3"``), for fp32 and bf16 inputs alike: a prep kernel over
every chunk, the forward and reverse chains side by side, and a kernel over
every chunk that writes each gradient once, in its final form.

Contract: the forward's inputs (``gdn.gdn_scan``'s contract), dy (B,S,H,K)
in q's dtype and dfinal (B,H,K,K) fp32 or None (a zero cotangent) ->
(dq, dk, dv, dbeta, dalpha), each in its input's dtype. No float atomics:
two calls give the same bits.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.common import check_launch, cuda_operand
from repro_torch.kernels.gdn.gdn import HEAD_DIMS, _check
from repro_torch.kernels.gdn.ref import gdn_scan_bwd_ref

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_ARGTYPES = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_LAUNCHERS = {}


def _bind(name: str, argtypes, restype):
    fn = _LAUNCHERS.get(name)
    if fn is None:
        from repro_torch.kernels.build import library

        fn = getattr(library("gdn_scan_bwd"), name)
        fn.argtypes = argtypes
        fn.restype = restype
        _LAUNCHERS[name] = fn
    return fn


def gdn_scan_bwd(q, k, v, beta, alpha, dy, dfinal=None):
    """The forward's inputs, dy (B,S,H,K) and dfinal (B,H,K,K) or None ->
    (dq, dk, dv, dbeta, dalpha), each in its input's dtype."""
    _check(q, k, v, beta, alpha)
    bsz, s, h, kd = q.shape
    if dy.shape != q.shape or dy.dtype != q.dtype:
        raise ValueError(f"gdn_scan_bwd: dy {tuple(dy.shape)} {dy.dtype} must match q "
                         f"{tuple(q.shape)} {q.dtype}")
    if dfinal is not None and (dfinal.shape != (bsz, h, kd, kd)
                               or dfinal.dtype != torch.float32):
        raise ValueError(f"gdn_scan_bwd: dfinal {tuple(dfinal.shape)} {dfinal.dtype} must be "
                         f"({bsz}, {h}, {kd}, {kd}) torch.float32")
    if q.device.type == "cpu":
        grads = gdn_scan_bwd_ref(q, k, v, beta, alpha, dy, dfinal)
        return tuple(g.to(t.dtype) for g, t in zip(grads, (q, k, v, beta, alpha)))
    if kd not in HEAD_DIMS:
        raise ValueError(f"gdn_scan_bwd: K={kd} must be one of {HEAD_DIMS}")
    dev = q.device
    # q, k, v and dy are read 16 bytes at a time (dy's rows by TMA copies)
    operands = [cuda_operand(t, what, "gdn_scan_bwd", dev, align=16 if t.dim() == 4 else 4)
                for t, what in ((q, "q"), (k, "k"), (v, "v"), (beta, "beta"),
                                (alpha, "alpha"), (dy, "dy"))]
    operands.append(None if dfinal is None
                    else cuda_operand(dfinal, "dfinal", "gdn_scan_bwd", dev))
    scratch_bytes = _bind("gdn_scan_bwd_scratch_bytes", [ctypes.c_int] * 4,
                          ctypes.c_longlong)(bsz, s, h, kd)
    # each chunk's entry state and exit cotangent, U and dU, the operand images
    scratch = torch.empty((scratch_bytes,), dtype=torch.uint8, device=dev)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dbeta = torch.empty((bsz, s, h), dtype=torch.float32, device=dev)
    dalpha = torch.empty_like(dbeta)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _bind(f"gdn_scan_bwd_{_SUFFIX[q.dtype]}", _ARGTYPES, ctypes.c_int)(
        *operands, scratch.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        dbeta.data_ptr(), dalpha.data_ptr(), bsz, s, h, kd, stream)
    check_launch(rc, "gdn_scan_bwd")
    gdn_scan_bwd.launches += 1
    return dq, dk, dv, dbeta, dalpha


gdn_scan_bwd.launches = 0
