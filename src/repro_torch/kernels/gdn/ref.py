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
UT-transform) form that the CUDA kernel evaluates, and
``gdn_scan_bwd_chunked_ref`` its gradient in the chunked form that the
backward kernels evaluate; neither lies on the main path: they exist so that
the kernels' algebra and rounding can be checked on the CPU.
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


def _f16x3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernels' mma.sync takes it: both fp32 operands split into
    fp16 hi + lo, and hi.hi + hi.lo + lo.hi summed in fp32."""
    ah, bh = a.half().float(), b.half().float()
    al, bl = (a - ah).half().float(), (b - bh).half().float()
    return ah @ bh + ah @ bl + al @ bh


def cotangent_scale(dy: torch.Tensor, dfinal: Optional[torch.Tensor]) -> torch.Tensor:
    """(B, H): the power of two that brings max(|dy|, |dfinal|) of each
    (batch, head) into [0.5, 1), 1 where that is 0 or not finite. The
    backward kernels scale the cotangents by it (every gradient is linear in
    them) so that their fp16 hi + lo splits stay in fp16's normal range, and
    scale the gradients back."""
    m = dy.float().abs().amax(dim=(1, 3))
    if dfinal is not None:
        m = torch.maximum(m, dfinal.float().abs().amax(dim=(-1, -2)))
    _, ex = torch.frexp(m)
    one = torch.ones_like(m)
    return torch.where((m > 0) & torch.isfinite(m), torch.ldexp(one, -ex.clamp(-125, 125)), one)


def gdn_scan_bwd_chunked_ref(
    q: torch.Tensor,       # (B, S, H, K)
    k: torch.Tensor,
    v: torch.Tensor,
    beta: torch.Tensor,    # (B, S, H)
    alpha: torch.Tensor,
    dy: torch.Tensor,      # (B, S, H, K)
    dfinal: Optional[torch.Tensor] = None,   # (B, H, K, K), or 0
    *,
    rounding: Optional[str] = None,
    chunk: int = 32,
) -> Tuple[torch.Tensor, ...]:
    """``gdn_scan_bwd_ref``'s gradients in the chunked form that the backward
    kernels evaluate (the header of ``csrc/gdn_scan_bwd.cu``): -> (dq, dk,
    dv, dbeta, dalpha) in fp32. In ``gdn_chunked_ref``'s notation, with A =
    I + L, dS the cotangent of a chunk's exit state (dfinal at the last
    chunk) and S0 its entry state, per chunk:

        dU = M^T dY + K~ dS;   dS0 = g_C dS + (diag(g) Q)^T dY - W^T dU
        dM = dY U^T, dK~ = U dS^T, d(gQ) = dY S0^T, dW = -dU S0^T,
        dg_C += <dS, S0>;   A^T Zu = dU, A^T Zw = dW (back substitution)
        dV = diag(beta) Zu, dbeta += rowsum(Zu.V) + g rowsum(Zw.K),
        dK += diag(beta g) Zw, dg += beta rowsum(Zw.K)
        dA = -(Zu U~^T + Zw W^T) (strictly lower): dbeta_t += sum_i dA_ti
        Gamma_ti k_t.k_i, with D = dA . beta Gamma: dK += D K + D^T K,
        dGamma += dA . beta K K^T
        E = dM . Gamma: dQ = E K + diag(g) d(gQ), dK += E^T Q,
        dGamma += dM . Q K^T, dg += rowsum(d(gQ).Q)
        dK += diag(Gamma_C.) dK~, dGamma_C,i += rowsum(dK~.K)_i
        P = dGamma . Gamma: dgamma = rowsum(P) - colsum(P) + dg g,
        dlog alpha = the reverse cumsum of dgamma in the chunk,
        dalpha = dlog alpha / alpha, 0 below the floor.

    The cotangents are scaled by ``cotangent_scale`` and the gradients back,
    as the kernels do. ``rounding="f16x3"`` takes every product as the
    kernels do (``_f16x3``); ``"bf16"`` is the kernels' path for bf16
    inputs: q, k, v and dy rounded to bf16, the same products, and dq, dk
    and dv rounded to bf16 as the kernels write them. The solves and every
    sum outside the products stay fp32 in both. S is padded to the chunk
    with beta = 0, alpha = 1 rows, as ``ops.gdn_prefill`` pads."""
    if rounding not in (None, "f16x3", "bf16"):
        raise ValueError(f"gdn_scan_bwd_chunked_ref: rounding {rounding!r} is not None, "
                         f"'f16x3' or 'bf16'")
    q, k, v, dy = (t.float() for t in (q, k, v, dy))
    if rounding == "bf16":
        q, k, v, dy = (t.bfloat16().float() for t in (q, k, v, dy))
    beta, alpha = beta.float(), alpha.float()
    mm = _f16x3 if rounding else torch.matmul
    tr = lambda t: t.transpose(-1, -2)
    bsz, s, h, kd = q.shape
    scale = cotangent_scale(dy, dfinal)                                  # (B, H)
    pad = (-s) % chunk
    if pad:
        q, k, v, dy = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v, dy))
        beta = F.pad(beta, (0, 0, 0, pad))
        alpha = F.pad(alpha, (0, 0, 0, pad), value=1.0)
    nz = q.shape[1] // chunk
    # (B, H, Z, C, K) and (B, H, Z, C)
    q, k, v, dy = (t.reshape(bsz, nz, chunk, h, kd).permute(0, 3, 1, 2, 4) for t in (q, k, v, dy))
    beta, alpha = (t.reshape(bsz, nz, chunk, h).permute(0, 3, 1, 2) for t in (beta, alpha))
    dy = dy * scale[:, :, None, None, None]
    floored = alpha < ALPHA_MIN
    gam = torch.cumsum(torch.log(alpha).clamp(min=LOG_ALPHA_MIN), dim=-1)
    g = torch.exp(gam)
    causal = torch.ones(chunk, chunk, dtype=torch.bool, device=q.device).tril()
    strict = causal.tril(-1)
    diff = gam[..., :, None] - gam[..., None, :]
    gamma = torch.where(causal, torch.exp(torch.where(causal, diff, 0.0)), 0.0)
    kk, qk = mm(k, tr(k)), mm(q, tr(k))
    a = torch.eye(chunk, device=q.device) + torch.where(strict, beta[..., :, None] * gamma * kk, 0.0)
    u_t = torch.linalg.solve_triangular(a, beta[..., None] * v, upper=False, unitriangular=True)
    w = torch.linalg.solve_triangular(a, (beta * g)[..., None] * k, upper=False,
                                      unitriangular=True)
    m = qk * gamma
    qg = g[..., None] * q
    g_c = g[..., -1, None, None]                                         # (B, H, Z, 1, 1)
    k_t = gamma[..., -1, :, None] * k                                    # diag(Gamma_C.) K
    # the forward chain: each chunk's entry state S0 and U
    state = torch.zeros((bsz, h, kd, kd), dtype=torch.float32, device=q.device)
    s0, u = [], []
    for z in range(nz):
        s0.append(state)
        u.append(u_t[:, :, z] - mm(w[:, :, z], state))
        state = g_c[:, :, z] * state + mm(tr(k_t[:, :, z]), u[-1])
    s0, u = torch.stack(s0, 2), torch.stack(u, 2)
    # the reverse chain: each chunk's exit cotangent dS and dU
    ds = (torch.zeros_like(state) if dfinal is None
          else dfinal.float() * scale[:, :, None, None])
    dsx, du = [None] * nz, [None] * nz
    for z in reversed(range(nz)):
        dyz = dy[:, :, z]
        dsx[z] = ds
        du[z] = mm(tr(m[:, :, z]), dyz) + mm(k_t[:, :, z], ds)
        ds = g_c[:, :, z] * ds + mm(tr(qg[:, :, z]), dyz) - mm(tr(w[:, :, z]), du[z])
    dsx, du = torch.stack(dsx, 2), torch.stack(du, 2)
    # every chunk at once
    dm = mm(dy, tr(u))
    dkt = mm(u, tr(dsx))
    dqg = mm(dy, tr(s0))
    dw = -mm(du, tr(s0))
    zu = torch.linalg.solve_triangular(tr(a), du, upper=True, unitriangular=True)
    zw = torch.linalg.solve_triangular(tr(a), dw, upper=True, unitriangular=True)
    r_zk = (zw * k).sum(-1)
    da = torch.where(strict, -(mm(zu, tr(u_t)) + mm(zw, tr(w))), 0.0)
    dd = da * beta[..., :, None] * gamma
    e = dm * gamma
    dq = mm(e, k) + g[..., None] * dqg
    dk = (beta * g)[..., None] * zw + mm(dd, k) + mm(tr(dd), k) + mm(tr(e), q) \
        + gamma[..., -1, :, None] * dkt
    dv = beta[..., None] * zu
    dbeta = (zu * v).sum(-1) + g * r_zk + (da * gamma * kk).sum(-1)
    p = (torch.where(causal, dm * qk, 0.0) + da * beta[..., :, None] * kk) * gamma
    p[..., -1, :] += (dkt * k).sum(-1) * gamma[..., -1, :]
    dg = beta * r_zk + (dqg * q).sum(-1)
    dg[..., -1] += (dsx * s0).sum((-1, -2))
    dgam = p.sum(-1) - p.sum(-2) + dg * g
    dlog = dgam.flip(-1).cumsum(-1).flip(-1)
    dalpha = torch.where(floored, 0.0, dlog / alpha)
    inv = 1.0 / scale
    back = lambda t: (t * inv[:, :, None, None, None]).permute(0, 2, 3, 1, 4).reshape(
        bsz, nz * chunk, h, kd)[:, :s]
    gate = lambda t: (t * inv[:, :, None, None]).permute(0, 2, 3, 1).reshape(
        bsz, nz * chunk, h)[:, :s]
    dq, dk, dv = (back(t) for t in (dq, dk, dv))
    if rounding == "bf16":
        dq, dk, dv = (t.bfloat16().float() for t in (dq, dk, dv))
    return dq, dk, dv, gate(dbeta), gate(dalpha)
