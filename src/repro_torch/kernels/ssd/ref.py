"""Plain PyTorch version of the SSD scan kernel.

Transcription of ``repro.kernels.ssd.ref``: the sequential Mamba2
recurrence, one token at a time, one B/C group shared by all heads,

    h_t = h_{t-1} * exp(dt_t * a) + dt_t * x_t (outer) b_t ;  y_t = h_t . c_t

in fp32. The CPU path and the kernel's comparisons on the card use it;
nothing on the main path calls it when a card is present.
"""
from __future__ import annotations

from typing import Tuple

import torch


def ssd_scan_ref(
    x: torch.Tensor,     # (B, S, H, P)
    dt: torch.Tensor,    # (B, S, H) — positive
    a: torch.Tensor,     # (H,)      — negative decay rates
    b: torch.Tensor,     # (B, S, N) — single group
    c: torch.Tensor,     # (B, S, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> y (B, S, H, P) fp32, final state (B, H, P, N) fp32."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    x, dt, b, c = (t.float() for t in (x, dt, b, c))
    a = a.float()
    state = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        decay = torch.exp(dt[:, t] * a[None, :])                        # (B,H)
        upd = (dt[:, t, :, None] * x[:, t])[..., None] * b[:, t, None, None, :]
        state = state * decay[:, :, None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", state, c[:, t]))
    return torch.stack(ys, dim=1), state
