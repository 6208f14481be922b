"""Plain PyTorch version of the gated-delta-rule scan kernel.

Transcription of ``repro.kernels.gdn.ref``: token by token over the (K, K)
fp32 state of each (batch, head),

    S_t = alpha_t (S_{t-1} - beta_t k_t (k_t^T S_{t-1})) + beta_t k_t v_t^T
    y_t = S_t^T q_t

The CPU path and the kernel's comparisons on the card use it; nothing on the
main path calls it when a card is present.
"""
from __future__ import annotations

from typing import Tuple

import torch


def gdn_scan_ref(
    q: torch.Tensor,       # (B, S, H, K)
    k: torch.Tensor,       # (B, S, H, K)
    v: torch.Tensor,       # (B, S, H, K)
    beta: torch.Tensor,    # (B, S, H)
    alpha: torch.Tensor,   # (B, S, H)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> y (B, S, H, K) fp32, final state (B, H, K, K) fp32."""
    q, k, v, beta, alpha = (t.float() for t in (q, k, v, beta, alpha))
    bsz, s, h, kd = q.shape
    state = torch.zeros((bsz, h, kd, kd), dtype=torch.float32, device=q.device)
    ys = []
    for t in range(s):
        kt, bt, at = k[:, t], beta[:, t, :, None, None], alpha[:, t, :, None, None]
        ks = torch.einsum("bhk,bhkv->bhv", kt, state)
        state = at * (state - bt * (kt[..., :, None] * ks[..., None, :])) \
            + bt * (kt[..., :, None] * v[:, t, :, None, :])
        ys.append(torch.einsum("bhkv,bhk->bhv", state, q[:, t]))
    return torch.stack(ys, dim=1), state
