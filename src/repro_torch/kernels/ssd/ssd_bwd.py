"""SSD scan backward wrapper: the CUDA kernel of ``csrc/ssd_scan_bwd.cu`` on a
CUDA tensor, the plain reverse scan ``ref.ssd_scan_bwd_ref`` on a CPU tensor.

The Pallas kernel ``repro.kernels.ssd.ssd.ssd_scan`` has no backward (the
JAX package differentiates its jnp scan); the port's forward on the card is
a kernel, so its gradient is one too. ``ssd.SsdScan`` calls it. On a CUDA
tensor the wrapper launches its kernel or raises; there is no fallback. It
counts its launches in ``ssd_scan_bwd.launches`` (the CPU path does not
count). On a meta tensor (the dry run) it launches nothing and counts no
launch: it returns empty meta gradients and adds its ``kernels.cost`` count
to the active counter.

bf16 runs the tensor-core kernel (``ssd_bwd_tc_kernel``), fp32 the
CUDA-core one (``ssd_bwd_kernel``); one launch each.

Contract: the forward's inputs (``ssd.ssd_scan``'s contract), dy (B,S,H,P)
in x's dtype and dfinal (B,H,P,N) fp32 or None (a zero cotangent) ->
(dx, ddt, da, db, dc), each in its input's dtype. The kernels sum in fp32
and write fp32 partials over blocks of state rows (``_rows_per_cta``:
ddt, da, db, dc), which are summed here in a fixed order: two calls give
the same bits. With G groups of B/C (b, c (B,S,G,N)) the db and dc
partials of each head are summed within its group.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import cost
from repro_torch.kernels.common import check_launch, cuda_operand
from repro_torch.kernels.ssd.ref import ssd_scan_bwd_ref
from repro_torch.kernels.ssd.ssd import CHUNK, ROWS_PER_CTA, STATE_DIMS, _check, groups

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_ARGTYPES = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_LAUNCHERS = {}


def _launcher(dtype: torch.dtype):
    """The C launcher ``ssd_scan_bwd_<f32|bf16>``, built and bound on first use."""
    fn = _LAUNCHERS.get(dtype)
    if fn is None:
        from repro_torch.kernels.build import library

        fn = getattr(library("ssd_scan_bwd"), f"ssd_scan_bwd_{_SUFFIX[dtype]}")
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _LAUNCHERS[dtype] = fn
    return fn


def _rows_per_cta(dtype: torch.dtype, p: int) -> int:
    """State rows a CTA of the kernel for ``dtype`` takes (PS in the source):
    the bf16 kernel 64 where 64 divides P, else ``ROWS_PER_CTA``."""
    return 64 if dtype == torch.bfloat16 and p % 64 == 0 else ROWS_PER_CTA


def ssd_scan_bwd(x, dt, a, b, c, dy, dfinal=None):
    """The forward's inputs, dy (B,S,H,P) and dfinal (B,H,P,N) or None ->
    (dx, ddt, da, db, dc), each in its input's dtype."""
    _check(x, dt, a, b, c)
    bsz, s, h, p = x.shape
    n, g = b.shape[-1], groups(b)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"ssd_scan_bwd: dy {tuple(dy.shape)} {dy.dtype} must match x "
                         f"{tuple(x.shape)} {x.dtype}")
    if dfinal is not None and (dfinal.shape != (bsz, h, p, n) or dfinal.dtype != torch.float32):
        raise ValueError(f"ssd_scan_bwd: dfinal {tuple(dfinal.shape)} {dfinal.dtype} must be "
                         f"({bsz}, {h}, {p}, {n}) torch.float32")
    if x.device.type == "cpu":
        grads = ssd_scan_bwd_ref(x, dt, a, b, c, dy, dfinal)
        return tuple(g.to(t.dtype) for g, t in zip(grads, (x, dt, a, b, c)))
    if x.device.type == "meta":
        cost.record("ssd_scan_bwd", cost.ssd_scan_bwd(bsz, s, h, p, n, x.element_size(), g=g))
        return tuple(torch.empty_like(t) for t in (x, dt, a, b, c))
    if p % ROWS_PER_CTA or n not in STATE_DIMS:
        raise ValueError(f"ssd_scan_bwd: P={p} must be a multiple of {ROWS_PER_CTA} and "
                         f"N={n} one of {STATE_DIMS}")
    dev = x.device
    bf16 = x.dtype == torch.bfloat16
    # the bf16 kernel stages 16-byte rows of x, b, c and dy and reads dfinal
    # in pairs; the fp32 kernel reads one element at a time
    operands = [cuda_operand(t, what, "ssd_scan_bwd", dev,
                             align=16 if bf16 and what in ("x", "b", "c", "dy")
                             else t.element_size())
                for t, what in ((x, "x"), (dt, "dt"), (a, "a"), (b, "b"), (c, "c"), (dy, "dy"))]
    operands.append(None if dfinal is None else cuda_operand(
        dfinal, "dfinal", "ssd_scan_bwd", dev, align=8 if bf16 else 4))
    npb = p // _rows_per_cta(x.dtype, p)
    f32 = dict(dtype=torch.float32, device=dev)
    # the state entering each chunk, in x's dtype
    hs = torch.empty((bsz, h, s // CHUNK, p, n), dtype=x.dtype, device=dev)
    dx = torch.empty_like(x)
    ddt = torch.empty((bsz, s, h, npb), **f32)
    da = torch.empty((bsz, h, npb), **f32)
    db = torch.empty((bsz, s, h * npb, n), **f32)
    dc = torch.empty_like(db)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _launcher(x.dtype)(*operands, hs.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
                            da.data_ptr(), db.data_ptr(), dc.data_ptr(), bsz, s, h, p, n, g,
                            stream)
    check_launch(rc, "ssd_scan_bwd")
    ssd_scan_bwd.launches += 1
    if b.dim() == 4:    # each head's partials (h * npb columns) summed within its group
        db, dc = (t.view(bsz, s, g, (h // g) * npb, n).sum(3) for t in (db, dc))
    else:
        db, dc = db.sum(2), dc.sum(2)
    return dx, ddt.sum(-1), da.sum((0, 2)), db.to(b.dtype), dc.to(c.dtype)


ssd_scan_bwd.launches = 0
