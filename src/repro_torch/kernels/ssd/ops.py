"""The SSD prefill around the scan kernel.

Counterpart of ``repro.kernels.ssd.ops.ssd_prefill``: pad the time axis to
the kernel's chunk with dt = 0 rows (exact no-ops: decay 1, weight 0), run
the scan, slice y back. ``plain=True`` runs the kernel's plain version on
the unpadded inputs instead.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd.ref import ssd_scan_ref
from repro_torch.kernels.ssd.ssd import CHUNK, ssd_scan


def ssd_prefill(
    x: torch.Tensor,    # (B, S, H, P)
    dt: torch.Tensor,   # (B, S, H) fp32
    a: torch.Tensor,    # (H,) fp32
    b: torch.Tensor,    # (B, S, N) or (B, S, G, N)
    c: torch.Tensor,    # like b
    *,
    plain: bool = False,
):
    """-> (y (B,S,H,P) in x's dtype, final state (B,H,P,N) fp32). A grouped
    b/c (B,S,G,N) goes to the scan as it is (head h reads group h // (H/G));
    G = 1 as (B,S,N)."""
    if b.dim() == 4 and b.shape[2] == 1:
        b, c = b[:, :, 0], c[:, :, 0]
    s = x.shape[1]
    if plain:
        y, fs = ssd_scan_ref(x, dt, a, b, c)
        return y.to(x.dtype), fs
    pad = (-s) % CHUNK
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        tail = (0, 0) * (b.dim() - 2) + (0, pad)
        b = F.pad(b, tail)
        c = F.pad(c, tail)
    y, fs = ssd_scan(x.contiguous(), dt.contiguous(), a.contiguous(), b.contiguous(),
                     c.contiguous())
    return y[:, :s], fs
