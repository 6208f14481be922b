"""Gated-delta-rule scan wrapper: the CUDA kernels of ``csrc/gdn_scan.cu``
(the chunked form of the delta rule on the tensor cores: a prep kernel over
every chunk, then the chain across chunks) on a CUDA tensor, the plain
PyTorch version of ``ref.py`` on a CPU tensor.

Counterpart of the Pallas kernel ``repro.kernels.gdn.gdn.gdn_scan``. On a
CUDA tensor the wrapper launches its kernel or raises; there is no
fallback. It counts its launches in ``gdn_scan.launches`` (the CPU path does
not count). On a meta tensor (the dry run) it launches nothing and counts
no launch: it returns empty meta outputs and adds its ``kernels.cost``
count to the active counter.

``gdn_scan`` is differentiable: it runs through the autograd Function
``GdnScan``, whose backward is the backward kernel of ``gdn_bwd.py`` on a
CUDA tensor and its plain twin ``ref.gdn_scan_bwd_ref`` on a CPU tensor.
Under ``torch.no_grad`` it is the forward alone.

Contract (as the Pallas kernel): q, k, v (B,S,H,K) in one dtype (fp32, as
the model calls it, or bf16), beta and alpha (B,S,H) fp32, S a multiple of
``CHUNK`` (``ops.gdn_prefill`` pads); returns y (B,S,H,K) in q's dtype and
the final state (B,H,K,K) fp32. The kernel takes K in ``HEAD_DIMS``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import cost
from repro_torch.kernels.common import check_launch, cuda_operand
from repro_torch.kernels.gdn.ref import gdn_scan_ref

CHUNK = 32                    # tokens per chunk of the kernels (C in the source)
HEAD_DIMS = (16, 32, 64, 128)

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_LAUNCHERS = {}


def _scratch_bytes(bsz: int, s: int, h: int, kd: int) -> int:
    """Bytes of the chain operands the prep kernel writes (the source's
    ``gdn_scan_scratch_bytes``)."""
    fn = _LAUNCHERS.get("scratch")
    if fn is None:
        from repro_torch.kernels.build import library

        fn = library("gdn_scan").gdn_scan_scratch_bytes
        fn.argtypes = [ctypes.c_int] * 4
        fn.restype = ctypes.c_longlong
        _LAUNCHERS["scratch"] = fn
    return fn(bsz, s, h, kd)


def _launcher(dtype: torch.dtype):
    """The C launcher ``gdn_scan_<f32|bf16>``, built and bound on first use."""
    fn = _LAUNCHERS.get(dtype)
    if fn is None:
        from repro_torch.kernels.build import library

        fn = getattr(library("gdn_scan"), f"gdn_scan_{_SUFFIX[dtype]}")
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _LAUNCHERS[dtype] = fn
    return fn


def _check(q, k, v, beta, alpha) -> None:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"gdn_scan: q, k, v must be (B,S,H,K) alike, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if beta.shape != q.shape[:3] or alpha.shape != q.shape[:3]:
        raise ValueError(f"gdn_scan: beta {tuple(beta.shape)} and alpha "
                         f"{tuple(alpha.shape)} must be {tuple(q.shape[:3])}")
    if q.shape[1] % CHUNK:
        raise ValueError(f"gdn_scan: S={q.shape[1]} not a multiple of the chunk {CHUNK} "
                         f"(ops.gdn_prefill pads)")
    if q.dtype not in _SUFFIX:
        raise TypeError(f"gdn_scan: dtype {q.dtype} not supported (fp32, bf16)")
    for t, what in ((k, "k"), (v, "v")):
        if t.dtype != q.dtype:
            raise TypeError(f"gdn_scan: {what} dtype {t.dtype} != q dtype {q.dtype}")
    for t, what in ((beta, "beta"), (alpha, "alpha")):
        if t.dtype != torch.float32:
            raise TypeError(f"gdn_scan: {what} dtype {t.dtype}, expected torch.float32")


def gdn_scan(q, k, v, beta, alpha):
    """q, k, v (B,S,H,K), beta, alpha (B,S,H) -> (y (B,S,H,K) in q's dtype,
    final state (B,H,K,K) fp32), differentiable in every input."""
    _check(q, k, v, beta, alpha)
    return GdnScan.apply(q, k, v, beta, alpha)


class GdnScan(torch.autograd.Function):
    """The scan with its gradient. The forward saves only its inputs (under
    remat nothing larger stays alive); the backward recomputes the states.
    A cotangent autograd does not pass (the final state unused) costs
    nothing, and a gradient no input needs is returned as None."""

    @staticmethod
    def forward(ctx, q, k, v, beta, alpha):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(q, k, v, beta, alpha)
        return _forward(q, k, v, beta, alpha)

    @staticmethod
    def backward(ctx, dy, dfinal):
        from repro_torch.kernels.gdn.gdn_bwd import gdn_scan_bwd

        if dy is None and dfinal is None:
            return (None,) * 5
        q, k, v, beta, alpha = ctx.saved_tensors
        dy = torch.zeros_like(q) if dy is None else dy.contiguous()
        grads = gdn_scan_bwd(q, k, v, beta, alpha, dy,
                             None if dfinal is None else dfinal.contiguous())
        return tuple(g if need else None for g, need in zip(grads, ctx.needs_input_grad))


def _forward(q, k, v, beta, alpha):
    if q.device.type == "cpu":
        y, fs = gdn_scan_ref(q, k, v, beta, alpha)
        return y.to(q.dtype), fs
    bsz, s, h, kd = q.shape
    if q.device.type == "meta":
        cost.record("gdn_scan", cost.gdn_scan(bsz, s, h, kd, q.element_size()))
        return torch.empty_like(q), q.new_empty((bsz, h, kd, kd), dtype=torch.float32)
    if kd not in HEAD_DIMS:
        raise ValueError(f"gdn_scan: K={kd} must be one of {HEAD_DIMS}")
    dev = q.device
    # q, k, v rows are copied 16 bytes at a time, beta and alpha 4
    operands = [cuda_operand(t, what, "gdn_scan", dev, align=16) for t, what in
                ((q, "q"), (k, "k"), (v, "v"))]
    operands += [cuda_operand(t, what, "gdn_scan", dev) for t, what in
                 ((beta, "beta"), (alpha, "alpha"))]
    y = torch.empty_like(q)
    fs = torch.empty((bsz, h, kd, kd), dtype=torch.float32, device=dev)
    scratch = torch.empty((_scratch_bytes(bsz, s, h, kd),), dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _launcher(q.dtype)(*operands, y.data_ptr(), fs.data_ptr(), scratch.data_ptr(),
                            bsz, s, h, kd, stream)
    check_launch(rc, "gdn_scan")
    gdn_scan.launches += 1
    return y, fs


gdn_scan.launches = 0
