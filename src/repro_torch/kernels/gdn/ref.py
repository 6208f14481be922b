"""Plain PyTorch version of the gated-delta-rule scan kernel.

Transcription of ``repro.kernels.gdn.ref``: token by token over the (K, K)
fp32 state of each (batch, head),

    S_t = alpha_t (S_{t-1} - beta_t k_t (k_t^T S_{t-1})) + beta_t k_t v_t^T
    y_t = S_t^T q_t

The CPU path and the kernel's comparisons on the card use it; nothing on the
main path calls it when a card is present.

``gdn_chunked_ref`` computes the same function in the chunked (WY /
UT-transform) form that the CUDA kernel evaluates; it is unused on the main
path and exists so that the kernel's algebra can be checked on the CPU.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

# log(alpha) is floored here (as in the kernel) so that an alpha that
# underflowed to 0 gives a decay of e^-80, not a NaN from -inf - -inf
LOG_ALPHA_MIN = -80.0


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


def gdn_chunked_ref(
    q: torch.Tensor,       # (B, S, H, K)
    k: torch.Tensor,
    v: torch.Tensor,
    beta: torch.Tensor,    # (B, S, H)
    alpha: torch.Tensor,
    chunk: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked form, in fp32: -> y (B, S, H, K), final state (B, H, K, K).

    Per chunk of C tokens entering with state S0 (rows are key dims), with
    gamma_t the cumulative sum of log alpha inside the chunk, g_t =
    exp(gamma_t) and Gamma_ti = exp(gamma_t - gamma_i) for i <= t (else 0):

        (I + L) U = diag(beta) (V - diag(g) K S0),  L_ti = beta_t Gamma_ti k_t.k_i (i < t)
        U = U~ - W S0,  U~ = T V,  W = T diag(g) K,  T = (I + L)^-1 diag(beta)
        Y = diag(g) Q S0 + (Q K^T . Gamma) U
        S_C = g_C S0 + (diag(Gamma_C.) K)^T U

    U~, W and the masked Q K^T do not depend on S0, so only three products a
    chunk form the chain across chunks. S is padded to a chunk multiple with
    beta = 0, alpha = 1 rows (exact no-ops) and y sliced back.
    """
    q, k, v, beta, alpha = (t.float() for t in (q, k, v, beta, alpha))
    bsz, s, h, kd = q.shape
    pad = (-s) % chunk
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        beta = F.pad(beta, (0, 0, 0, pad))
        alpha = F.pad(alpha, (0, 0, 0, pad), value=1.0)
    nz = q.shape[1] // chunk
    # (B, H, Z, C, K) and (B, H, Z, C)
    q, k, v = (t.reshape(bsz, nz, chunk, h, kd).permute(0, 3, 1, 2, 4) for t in (q, k, v))
    beta, alpha = (t.reshape(bsz, nz, chunk, h).permute(0, 3, 1, 2) for t in (beta, alpha))
    gam = torch.cumsum(torch.log(alpha).clamp(min=LOG_ALPHA_MIN), dim=-1)
    g = torch.exp(gam)
    causal = torch.ones(chunk, chunk, dtype=torch.bool, device=q.device).tril()
    diff = gam[..., :, None] - gam[..., None, :]
    gamma = torch.exp(torch.where(causal, diff, torch.full_like(diff, -torch.inf)))
    eye = torch.eye(chunk, device=q.device)
    lower = beta[..., :, None] * gamma * (k @ k.transpose(-1, -2)) * (1 - eye)
    a = eye + lower
    u_t = torch.linalg.solve_triangular(a, beta[..., None] * v, upper=False,
                                        unitriangular=True)
    w = torch.linalg.solve_triangular(a, (beta * g)[..., None] * k, upper=False,
                                      unitriangular=True)
    m = (q @ k.transpose(-1, -2)) * gamma
    qg = g[..., None] * q
    kd_last = gamma[..., -1, :, None] * k
    state = torch.zeros((bsz, h, kd, kd), dtype=torch.float32, device=q.device)
    ys = []
    for z in range(nz):
        u = u_t[:, :, z] - w[:, :, z] @ state
        ys.append(qg[:, :, z] @ state + m[:, :, z] @ u)
        state = g[:, :, z, -1, None, None] * state + kd_last[:, :, z].transpose(-1, -2) @ u
    y = torch.stack(ys, dim=2).reshape(bsz, h, nz * chunk, kd).permute(0, 2, 1, 3)
    return y[:, :s].contiguous(), state
