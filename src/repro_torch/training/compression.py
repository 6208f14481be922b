"""Gradient compression: int8 quantisation with error feedback.

Counterpart of ``repro.training.compression``: gradients are quantised to
int8 (per-leaf absmax scaling) and the quantisation error is carried in an
error-feedback buffer added to the next step's gradient (EF-SGD). As in
the reference's pjit mode, the train step applies it to the accumulated
gradient (on DTensors: after the data axes' reduction, where GSPMD's
all-reduce leaves it), keeping the maths contract. Rounding is half to even
(``torch.round``, as ``jnp.round``), so the int8 codes equal the
reference's.

``compressed_psum(x, group)`` is the reference's int8 exchange inside
``shard_map``: quantise locally, share the largest scale (all-reduce MAX),
requantise against it, reduce the codes as int32 (all-reduce SUM) and
dequantise: 1 byte an element on the wire plus one fp32 scale.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.training import tree as T


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (int8 values, fp32 scale). absmax scaling, symmetric."""
    x32 = x.to(torch.float32)
    scale = torch.clamp(x32.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_with_feedback(grads: Any, error_buf: Any) -> Tuple[Any, Any]:
    """Quantise (grads + carried error); return (dequantised grads, new error).

    The returned gradient is what the optimiser sees; the new error buffer is
    (input - quantised) and is added back next step.
    """

    def one(g, e):
        g32 = g.to(torch.float32) + e
        q, scale = quantize_int8(g32)
        deq = dequantize_int8(q, scale)
        return deq.to(g.dtype), g32 - deq

    outs = [one(g, e) for g, e in zip(T.leaves(grads), T.leaves(error_buf))]
    return (T.unflatten(grads, [o[0] for o in outs]),
            T.unflatten(grads, [o[1] for o in outs]))


def init_error_buffer(grads_like: Any) -> Any:
    return T.map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
                 grads_like)


def compressed_psum(x: torch.Tensor, group) -> torch.Tensor:
    """int8-quantised sum of ``x`` over ``group``: a process group, a 1-D
    ``DeviceMesh`` or ``(mesh, mesh_dim)``, as ``torch.distributed``'s
    functional collectives take it. Every rank returns the same fp32 sum.

    Quantises locally, reduces the int8 payload as int32, dequantises with
    the max scale. The conservative scale (the max over ranks) keeps the
    estimate unbiased up to rounding."""
    from torch.distributed import _functional_collectives as funcol

    _, scale = quantize_int8(x)
    scale_max = funcol.all_reduce(scale.reshape(1), "max", group).reshape(())
    # requantise against the shared scale so the sum is exact in int32
    x32 = x.to(torch.float32)
    q_shared = torch.clamp(torch.round(x32 / scale_max), -127, 127).to(torch.int32)
    total = funcol.all_reduce(q_shared, "sum", group)
    return total.to(torch.float32) * scale_max
