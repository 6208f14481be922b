"""Plain PyTorch version of the gated-delta-rule scan kernel.

Transcription of ``repro.kernels.gdn.ref``: token by token over the (K, K)
fp32 state of each (batch, head),

    S_t = alpha_t (S_{t-1} - beta_t k_t (k_t^T S_{t-1})) + beta_t k_t v_t^T
    y_t = S_t^T q_t

The CPU path and the kernel's comparisons on the card use it; nothing on the
main path calls it when a card is present.

``gdn_scan_bwd_ref`` is the plain version of the backward kernel
(``csrc/gdn_scan_bwd.cu``): the reverse scan that gives every input's
gradient, the twin of ``torch.autograd`` through ``gdn_scan_ref``.

``gdn_chunked_ref`` computes the same function in the chunked (WY /
UT-transform) form that the CUDA kernel evaluates; it is unused on the main
path and exists so that the kernel's algebra can be checked on the CPU.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

# log(alpha) is floored here (as in the kernel) so that an alpha that
# underflowed to 0 gives a decay of e^-80, not a NaN from -inf - -inf
LOG_ALPHA_MIN = -80.0
ALPHA_MIN = math.exp(LOG_ALPHA_MIN)


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



def gdn_scan_bwd_ref(
    q: torch.Tensor,       # (B, S, H, K)
    k: torch.Tensor,
    v: torch.Tensor,
    beta: torch.Tensor,    # (B, S, H)
    alpha: torch.Tensor,
    dy: torch.Tensor,      # (B, S, H, K): the cotangent of y
    dfinal: Optional[torch.Tensor] = None,   # (B, H, K, K): of the final state, or 0
) -> Tuple[torch.Tensor, ...]:
    """The reverse scan of ``gdn_scan_ref``: -> (dq, dk, dv, dbeta, dalpha),
    each in fp32 and its input's shape. The state cotangent runs backwards,

        dS_{t-1} = alpha_t (dS_t - beta_t k_t (k_t^T dS_t)) + q_{t-1} dy_{t-1}^T,

    from dfinal + q dy^T at the last token, and with the recomputed states,
    g = dS_t^T k_t, ks = S_{t-1}^T k_t and w = v_t - alpha_t ks, per token
    dq_t = S_t dy_t, dv_t = beta_t g, dbeta_t = g . w,
    dk_t = beta_t dS_t w - alpha_t beta_t S_{t-1} g and
    dalpha_t = <dS_t, S_{t-1} - beta_t k_t ks^T>.

    As the CUDA kernels floor log(alpha) at LOG_ALPHA_MIN, an alpha below
    exp(LOG_ALPHA_MIN) runs the recurrence at that floor and gets a zero
    dalpha, the floor's derivative; above it this is autograd through
    ``gdn_scan_ref`` exactly."""
    q, k, v, beta, alpha, dy = (t.float() for t in (q, k, v, beta, alpha, dy))
    floored = alpha < ALPHA_MIN
    alpha = torch.where(floored, torch.full_like(alpha, ALPHA_MIN), alpha)
    bsz, s, h, kd = q.shape
    state = torch.zeros((bsz, h, kd, kd), dtype=torch.float32, device=q.device)
    states, kss = [state], []
    for t in range(s):
        kt, bt, at = k[:, t], beta[:, t, :, None, None], alpha[:, t, :, None, None]
        ks = torch.einsum("bhk,bhkv->bhv", kt, state)
        state = at * (state - bt * (kt[..., :, None] * ks[..., None, :])) \
            + bt * (kt[..., :, None] * v[:, t, :, None, :])
        states.append(state)
        kss.append(ks)
    ds = torch.zeros_like(state) if dfinal is None else dfinal.float().clone()
    dq, dk, dv, dbeta, dalpha = (torch.empty_like(t) for t in (q, k, v, beta, alpha))
    for t in reversed(range(s)):
        kt, ks = k[:, t], kss[t]
        bt, at = beta[:, t, :, None], alpha[:, t, :, None]
        ds = ds + q[:, t, :, :, None] * dy[:, t, :, None, :]
        dq[:, t] = torch.einsum("bhkv,bhv->bhk", states[t + 1], dy[:, t])
        g = torch.einsum("bhk,bhkv->bhv", kt, ds)
        w = v[:, t] - at * ks
        dv[:, t] = bt * g
        dbeta[:, t] = (g * w).sum(-1)
        dk[:, t] = bt * torch.einsum("bhkv,bhv->bhk", ds, w) \
            - at * bt * torch.einsum("bhkv,bhv->bhk", states[t], g)
        pre = states[t] - bt[..., None] * (kt[..., :, None] * ks[..., None, :])
        dalpha[:, t] = (ds * pre).sum((-1, -2))
        ds = at[..., None] * (ds - bt[..., None] * (kt[..., :, None] * g[..., None, :]))
    return dq, dk, dv, dbeta, torch.where(floored, torch.zeros_like(dalpha), dalpha)


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
