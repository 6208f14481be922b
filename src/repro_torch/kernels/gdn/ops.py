"""The GDN prefill around the scan kernel.

Counterpart of ``repro.kernels.gdn.ops.gdn_prefill``: pad the time axis to
the kernel's chunk with beta = 0, alpha = 1 rows (exact no-ops: the state is
left alone), run the scan, slice y back. ``plain=True`` runs the kernel's
plain version on the unpadded inputs instead.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.gdn.gdn import CHUNK, gdn_scan
from repro_torch.kernels.gdn.ref import gdn_scan_ref


def gdn_prefill(
    q: torch.Tensor,       # (B, S, H, K)
    k: torch.Tensor,
    v: torch.Tensor,
    beta: torch.Tensor,    # (B, S, H) fp32
    alpha: torch.Tensor,
    *,
    plain: bool = False,
):
    """-> (y (B,S,H,K) in q's dtype, final state (B,H,K,K) fp32)."""
    s = q.shape[1]
    if plain:
        y, fs = gdn_scan_ref(q, k, v, beta, alpha)
        return y.to(q.dtype), fs
    pad = (-s) % CHUNK
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        beta = F.pad(beta, (0, 0, 0, pad))
        alpha = F.pad(alpha, (0, 0, 0, pad), value=1.0)
    y, fs = gdn_scan(q.contiguous(), k.contiguous(), v.contiguous(), beta.contiguous(),
                     alpha.contiguous())
    return y[:, :s], fs
