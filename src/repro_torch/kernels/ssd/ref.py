"""Plain PyTorch version of the SSD scan kernel.

Transcription of ``repro.kernels.ssd.ref``: the sequential Mamba2
recurrence, one token at a time, one B/C group shared by all heads,

    h_t = h_{t-1} * exp(dt_t * a) + dt_t * x_t (outer) b_t ;  y_t = h_t . c_t

in fp32. The CPU path and the kernel's comparisons on the card use it;
nothing on the main path calls it when a card is present.

``ssd_scan_bwd_ref`` is the plain version of the backward kernel
(``csrc/ssd_scan_bwd.cu``): the reverse scan that gives every input's
gradient, the twin of ``torch.autograd`` through ``ssd_scan_ref``.
"""
from __future__ import annotations

from typing import Optional, Tuple

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


def ssd_scan_bwd_ref(
    x: torch.Tensor,     # (B, S, H, P)
    dt: torch.Tensor,    # (B, S, H)
    a: torch.Tensor,     # (H,)
    b: torch.Tensor,     # (B, S, N)
    c: torch.Tensor,     # (B, S, N)
    dy: torch.Tensor,    # (B, S, H, P): the cotangent of y
    dfinal: Optional[torch.Tensor] = None,   # (B, H, P, N): of the final state, or 0
) -> Tuple[torch.Tensor, ...]:
    """The reverse scan of ``ssd_scan_ref``: -> (dx, ddt, da, db, dc), each
    in fp32 and its input's shape. The state cotangent runs backwards,

        G_t = exp(dt_{t+1} a) G_{t+1} + dy_t c_t^T ,  G_{S-1} = dfinal + dy c^T,

    and with the recomputed states h_t of the forward, per token
    dx_t = dt_t G_t b_t, dc_t = sum_h h_t^T dy_t, db_t = sum_h dt_t G_t^T x_t,
    r_t = exp(dt_t a) <G_t, h_{t-1}>, ddt_t = a r_t + x_t . G_t b_t and
    da = sum_t dt_t r_t (b and c sum over heads: one group)."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    x, dt, b, c, dy = (t.float() for t in (x, dt, b, c, dy))
    a = a.float()
    decay = torch.exp(dt * a)                                         # (B,S,H)
    state = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    states = [state]
    for t in range(s):
        upd = (dt[:, t, :, None] * x[:, t])[..., None] * b[:, t, None, None, :]
        state = state * decay[:, t, :, None, None] + upd
        states.append(state)
    g = (torch.zeros_like(state) if dfinal is None else dfinal.float().clone())
    dx, ddt, db, dc = (torch.empty_like(t) for t in (x, dt, b, c))
    da = torch.zeros_like(a)
    for t in reversed(range(s)):
        if t < s - 1:
            g = g * decay[:, t + 1, :, None, None]
        g = g + dy[:, t, :, :, None] * c[:, t, None, None, :]
        gb = torch.einsum("bhpn,bn->bhp", g, b[:, t])
        dx[:, t] = dt[:, t, :, None] * gb
        dc[:, t] = torch.einsum("bhpn,bhp->bn", states[t + 1], dy[:, t])
        db[:, t] = torch.einsum("bhpn,bhp,bh->bn", g, x[:, t], dt[:, t])
        r = decay[:, t] * torch.einsum("bhpn,bhpn->bh", g, states[t])
        ddt[:, t] = a * r + torch.einsum("bhp,bhp->bh", x[:, t], gb)
        da = da + (dt[:, t] * r).sum(0)
    return dx, ddt, da, db, dc
