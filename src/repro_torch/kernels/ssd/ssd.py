"""SSD scan wrapper: the CUDA kernels of ``csrc/ssd_scan.cu`` on a CUDA
tensor, the plain PyTorch version of ``ref.py`` on a CPU tensor.

Counterpart of the Pallas kernel ``repro.kernels.ssd.ssd.ssd_scan``. On a
CUDA tensor the wrapper launches its kernel or raises; there is no
fallback. It counts its calls in ``ssd_scan.launches`` (the CPU path does
not count). On a meta tensor (the dry run) it launches nothing and counts
no launch: it returns empty meta outputs and adds its ``kernels.cost``
count to the active counter. bf16 runs the tensor-core kernel (``ssd_tc_kernel``, one
launch); fp32 the CUDA-core kernels (a c.b pass, then the scan).

``ssd_scan`` is differentiable: it runs through the autograd Function
``SsdScan``, whose backward is the backward kernel of ``ssd_bwd.py`` on a
CUDA tensor and its plain twin ``ref.ssd_scan_bwd_ref`` on a CPU tensor.
Under ``torch.no_grad`` it is the forward alone.

Contract (as the Pallas kernel): x (B,S,H,P) and b, c (B,S,N) in one dtype
(fp32 or bf16), dt (B,S,H) and a (H,) fp32, S a multiple of ``CHUNK``
(``ops.ssd_prefill`` pads); returns y (B,S,H,P) in x's dtype and the final
state (B,H,P,N) fp32. The kernels take P a multiple of ``ROWS_PER_CTA`` and
N in ``STATE_DIMS``. Beyond the Pallas kernel, b and c may also come as
(B,S,G,N), G groups of B/C (``ssm_groups``; H a multiple of G): head h
reads group ``h // (H / G)``, as the reference model's jnp scan does. Each
CTA of the kernels then loads its own head's group; G = 1 is the same
launch as a (B,S,N) b and c.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import cost
from repro_torch.kernels.common import check_launch, cuda_operand
from repro_torch.kernels.ssd.ref import ssd_scan_ref

CHUNK = 64                    # tokens per chunk of the kernels (Q in the source)
ROWS_PER_CTA = 32             # state rows per CTA (PS in the source; bf16: 64 where it divides P)
STATE_DIMS = (16, 32, 64, 128)

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_LAUNCHERS = {}


def _launcher(dtype: torch.dtype):
    """The C launcher ``ssd_scan_<f32|bf16>``, built and bound on first use."""
    fn = _LAUNCHERS.get(dtype)
    if fn is None:
        from repro_torch.kernels.build import library

        fn = getattr(library("ssd_scan"), f"ssd_scan_{_SUFFIX[dtype]}")
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _LAUNCHERS[dtype] = fn
    return fn


def groups(b) -> int:
    """The B/C groups of a (B,S,N) (one) or (B,S,G,N) b."""
    return 1 if b.dim() == 3 else b.shape[2]


def _check(x, dt, a, b, c) -> None:
    if x.dim() != 4 or dt.dim() != 3 or a.dim() != 1 or b.dim() not in (3, 4) \
            or c.dim() != b.dim():
        raise ValueError("ssd_scan: x (B,S,H,P), dt (B,S,H), a (H,), b and c (B,S,N) or "
                         "(B,S,G,N)")
    bsz, s, h, _ = x.shape
    if dt.shape != (bsz, s, h) or a.shape != (h,):
        raise ValueError(f"ssd_scan: dt {tuple(dt.shape)} / a {tuple(a.shape)} do not "
                         f"match x {tuple(x.shape)}")
    if b.shape[:2] != (bsz, s) or c.shape != b.shape or h % groups(b):
        raise ValueError(f"ssd_scan: b {tuple(b.shape)} and c {tuple(c.shape)} must be "
                         f"({bsz}, {s}, N) or ({bsz}, {s}, G, N) with G dividing H={h}")
    if s % CHUNK:
        raise ValueError(f"ssd_scan: S={s} not a multiple of the chunk {CHUNK} "
                         f"(ops.ssd_prefill pads)")
    if x.dtype not in _SUFFIX:
        raise TypeError(f"ssd_scan: dtype {x.dtype} not supported (fp32, bf16)")
    for t, what in ((b, "b"), (c, "c")):
        if t.dtype != x.dtype:
            raise TypeError(f"ssd_scan: {what} dtype {t.dtype} != x dtype {x.dtype}")
    for t, what in ((dt, "dt"), (a, "a")):
        if t.dtype != torch.float32:
            raise TypeError(f"ssd_scan: {what} dtype {t.dtype}, expected torch.float32")


def ssd_scan(x, dt, a, b, c):
    """x (B,S,H,P), dt (B,S,H), a (H,), b, c (B,S,N) or (B,S,G,N) -> (y
    (B,S,H,P) in x's dtype, final state (B,H,P,N) fp32), differentiable in
    every input."""
    _check(x, dt, a, b, c)
    return SsdScan.apply(x, dt, a, b, c)


class SsdScan(torch.autograd.Function):
    """The scan with its gradient. The forward saves only its inputs (under
    remat nothing larger stays alive); the backward recomputes the states.
    A cotangent autograd does not pass (the final state unused) costs
    nothing, and a gradient no input needs is returned as None."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, a, b, c)
        return _forward(x, dt, a, b, c)

    @staticmethod
    def backward(ctx, dy, dfinal):
        from repro_torch.kernels.ssd.ssd_bwd import ssd_scan_bwd

        if dy is None and dfinal is None:
            return (None,) * 5
        x, dt, a, b, c = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        grads = ssd_scan_bwd(x, dt, a, b, c, dy,
                             None if dfinal is None else dfinal.contiguous())
        return tuple(g if need else None for g, need in zip(grads, ctx.needs_input_grad))


def _forward(x, dt, a, b, c):
    if x.device.type == "cpu":
        y, fs = ssd_scan_ref(x, dt, a, b, c)
        return y.to(x.dtype), fs
    bsz, s, h, p = x.shape
    n, g = b.shape[-1], groups(b)
    if x.device.type == "meta":
        cost.record("ssd_scan", cost.ssd_scan(bsz, s, h, p, n, x.element_size(), g=g))
        return torch.empty_like(x), x.new_empty((bsz, h, p, n), dtype=torch.float32)
    if p % ROWS_PER_CTA or n not in STATE_DIMS:
        raise ValueError(f"ssd_scan: P={p} must be a multiple of {ROWS_PER_CTA} and "
                         f"N={n} one of {STATE_DIMS}")
    bf16 = x.dtype == torch.bfloat16
    dev = x.device
    # the bf16 kernel stages 16-byte rows of x, b and c; the fp32 kernels
    # read one element at a time
    operands = [cuda_operand(t, what, "ssd_scan", dev,
                             align=16 if bf16 and what in ("x", "b", "c") else t.element_size())
                for t, what in ((x, "x"), (dt, "dt"), (a, "a"), (b, "b"), (c, "c"))]
    cb = None if bf16 else torch.empty((bsz, g, s // CHUNK, CHUNK, CHUNK),
                                       dtype=torch.float32, device=dev)
    y = torch.empty_like(x)
    fs = torch.empty((bsz, h, p, n), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _launcher(x.dtype)(*operands, 0 if cb is None else cb.data_ptr(), y.data_ptr(),
                            fs.data_ptr(), bsz, s, h, p, n, g, stream)
    check_launch(rc, "ssd_scan")
    ssd_scan.launches += 1
    return y, fs


ssd_scan.launches = 0
