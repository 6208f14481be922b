"""Plain PyTorch version of the SSD scan kernel.

Transcription of ``repro.kernels.ssd.ref``: the sequential Mamba2
recurrence, one token at a time, one B/C group shared by all heads,

    h_t = h_{t-1} * exp(dt_t * a) + dt_t * x_t (outer) b_t ;  y_t = h_t . c_t

in fp32. The CPU path and the kernel's comparisons on the card use it;
nothing on the main path calls it when a card is present.

``ssd_scan_bwd_ref`` is the plain version of the backward kernel
(``csrc/ssd_scan_bwd.cu``): the reverse scan that gives every input's
gradient, the twin of ``torch.autograd`` through ``ssd_scan_ref``.
``ssd_scan_bwd_chunked_ref`` writes out the per-chunk closed form that the
kernel evaluates instead, with the bf16 kernel's rounding points as an
option; it lies on no path and serves the tests.

Each takes b and c as (B, S, N), one group, or (B, S, G, N), G groups of
B/C with head h reading group ``h // (H / G)`` (the reference model's
``rep``). With groups, ``ssd_scan_ref`` and ``ssd_scan_bwd_ref`` give each
head its group's row (one scan over the sequence whatever G is) and sum db
and dc within each group; ``ssd_scan_bwd_chunked_ref`` runs its one-group
form on each group's heads.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def _per_head(t: torch.Tensor, h: int) -> torch.Tensor:
    """A grouped b or c (B, S, G, N) as each head's row (B, S, H, N)."""
    g = t.shape[2]
    if h % g:
        raise ValueError(f"ssd scan: H={h} not a multiple of the {g} B/C groups")
    return t.repeat_interleave(h // g, dim=2)


def _by_group(fn, x, dt, a, b, c, dy=None, dfinal=None, **kw):
    """``fn`` (a one-group scan or its backward) on each of the G groups of
    a grouped b / c (B, S, G, N): the heads ``[k rep, (k + 1) rep)`` with
    group k's b and c. -> the per-group outputs, in group order."""
    g, h = b.shape[2], x.shape[2]
    if h % g:
        raise ValueError(f"ssd scan: H={h} not a multiple of the {g} B/C groups")
    rep = h // g
    outs = []
    for k in range(g):
        sl = slice(k * rep, (k + 1) * rep)
        extra = () if dy is None else (dy[:, :, sl],
                                       None if dfinal is None else dfinal[:, sl])
        outs.append(fn(x[:, :, sl], dt[:, :, sl], a[sl], b[:, :, k], c[:, :, k], *extra, **kw))
    return outs


def _join_bwd(outs):
    """Per-group (dx, ddt, da, db, dc) -> the whole gradients, db and dc
    (B, S, G, N)."""
    dx, ddt, da, db, dc = zip(*outs)
    return (torch.cat(dx, 2), torch.cat(ddt, 2), torch.cat(da, 0), torch.stack(db, 2),
            torch.stack(dc, 2))


def ssd_scan_ref(
    x: torch.Tensor,     # (B, S, H, P)
    dt: torch.Tensor,    # (B, S, H) — positive
    a: torch.Tensor,     # (H,)      — negative decay rates
    b: torch.Tensor,     # (B, S, N) — single group, or (B, S, G, N)
    c: torch.Tensor,     # like b
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> y (B, S, H, P) fp32, final state (B, H, P, N) fp32."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    grouped = b.dim() == 4
    if grouped:
        b, c = (_per_head(t, h) for t in (b, c))
    x, dt, b, c = (t.float() for t in (x, dt, b, c))
    a = a.float()
    state = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        decay = torch.exp(dt[:, t] * a[None, :])                        # (B,H)
        bt = b[:, t, :, None, :] if grouped else b[:, t, None, None, :]
        upd = (dt[:, t, :, None] * x[:, t])[..., None] * bt
        state = state * decay[:, :, None, None] + upd
        ys.append(torch.einsum("bhpn,bhn->bhp" if grouped else "bhpn,bn->bhp", state, c[:, t]))
    return torch.stack(ys, dim=1), state


def ssd_scan_bwd_ref(
    x: torch.Tensor,     # (B, S, H, P)
    dt: torch.Tensor,    # (B, S, H)
    a: torch.Tensor,     # (H,)
    b: torch.Tensor,     # (B, S, N), or (B, S, G, N)
    c: torch.Tensor,     # like b
    dy: torch.Tensor,    # (B, S, H, P): the cotangent of y
    dfinal: Optional[torch.Tensor] = None,   # (B, H, P, N): of the final state, or 0
) -> Tuple[torch.Tensor, ...]:
    """The reverse scan of ``ssd_scan_ref``: -> (dx, ddt, da, db, dc), each
    in fp32 and its input's shape. The state cotangent runs backwards,

        G_t = exp(dt_{t+1} a) G_{t+1} + dy_t c_t^T ,  G_{S-1} = dfinal + dy c^T,

    and with the recomputed states h_t of the forward, per token
    dx_t = dt_t G_t b_t, dc_t = sum_h h_t^T dy_t, db_t = sum_h dt_t G_t^T x_t,
    r_t = exp(dt_t a) <G_t, h_{t-1}>, ddt_t = a r_t + x_t . G_t b_t and
    da = sum_t dt_t r_t (b and c sum over the heads of their group)."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    groups = b.shape[2] if b.dim() == 4 else 0
    if groups:
        b, c = (_per_head(t, h) for t in (b, c))
    # per head ("h" in b and c's subscripts) or one group shared by all
    bs = "bhn" if groups else "bn"
    row = (lambda t, i: t[:, i, :, None, :]) if groups else (lambda t, i: t[:, i, None, None, :])
    x, dt, b, c, dy = (t.float() for t in (x, dt, b, c, dy))
    a = a.float()
    decay = torch.exp(dt * a)                                         # (B,S,H)
    state = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    states = [state]
    for t in range(s):
        upd = (dt[:, t, :, None] * x[:, t])[..., None] * row(b, t)
        state = state * decay[:, t, :, None, None] + upd
        states.append(state)
    g = (torch.zeros_like(state) if dfinal is None else dfinal.float().clone())
    dx, ddt, db, dc = (torch.empty_like(t) for t in (x, dt, b, c))
    da = torch.zeros_like(a)
    for t in reversed(range(s)):
        if t < s - 1:
            g = g * decay[:, t + 1, :, None, None]
        g = g + dy[:, t, :, :, None] * row(c, t)
        gb = torch.einsum(f"bhpn,{bs}->bhp", g, b[:, t])
        dx[:, t] = dt[:, t, :, None] * gb
        dc[:, t] = torch.einsum(f"bhpn,bhp->{bs}", states[t + 1], dy[:, t])
        db[:, t] = torch.einsum(f"bhpn,bhp,bh->{bs}", g, x[:, t], dt[:, t])
        r = decay[:, t] * torch.einsum("bhpn,bhpn->bh", g, states[t])
        ddt[:, t] = a * r + torch.einsum("bhp,bhp->bh", x[:, t], gb)
        da = da + (dt[:, t] * r).sum(0)
    if groups:      # each head's db / dc summed within its group
        db, dc = (t.view(bsz, s, groups, h // groups, n).sum(3) for t in (db, dc))
    return dx, ddt, da, db, dc


def ssd_scan_bwd_chunked_ref(
    x: torch.Tensor,     # (B, S, H, P)
    dt: torch.Tensor,    # (B, S, H)
    a: torch.Tensor,     # (H,)
    b: torch.Tensor,     # (B, S, N), or (B, S, G, N)
    c: torch.Tensor,     # like b
    dy: torch.Tensor,    # (B, S, H, P)
    dfinal: Optional[torch.Tensor] = None,   # (B, H, P, N), or 0
    *,
    bf16: bool = False,
    chunk: int = 64,
) -> Tuple[torch.Tensor, ...]:
    """``ssd_scan_bwd_ref``'s gradients by the kernel's per-chunk closed
    form (the header of ``csrc/ssd_scan_bwd.cu``): -> (dx, ddt, da, db, dc)
    in fp32. S is padded to the chunk with dt = 0 rows, as ``ssd_prefill``
    pads. A first pass over the chunks keeps the state entering each; the
    second walks them backwards with dH, the state's cotangent at the
    chunk's end. Per chunk, with cum the inclusive cumsum of dt a, e_i =
    exp(cum_i), u_j = exp(cum_Q - cum_j), w_j = u_j dt_j, L_ij =
    exp(cum_i - cum_j) (j <= i, else 0), CB = C B^T and dM = dY X^T:

        M = CB.L.dt_j,  Pm = dM.L.dt_j,  K = dM.CB.L
        dX = M^T dY + diag(w) B dH^T      v_j = x_j . (dH b_j)
        dC = Pm B + diag(e) dY H0         q_i = dy_i . (H0 c_i)
        dB = Pm^T C + diag(w) X dH
        dcum_i = sum_j K_ij dt_j - dt_i sum_i' K_i'i + e_i q_i - w_i v_i
                 (+ e_Q <dH, H0> + sum_j w_j v_j at i = Q - 1)
        ddt_j = sum_i K_ij + u_j v_j + a sum_{i >= j} dcum_i
        da += sum_i dcum_i sum_{k <= i} dt_k
        dH <- e_Q dH + dY^T diag(e) C

    (b and c sum over the heads of their group). With ``bf16`` it rounds where the
    bf16 kernel does: x, b, c and dy (its inputs), each product's operands
    that are not inputs (M, Pm, dH, e dY and, in the first pass, w X), the
    entry states (kept in bf16 between the passes), and dx, db and dc (its
    outputs); the rest stays fp32."""
    if b.dim() == 4:
        return _join_bwd(_by_group(ssd_scan_bwd_chunked_ref, x, dt, a, b, c, dy, dfinal,
                                   bf16=bf16, chunk=chunk))
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    rnd = (lambda t: t.to(torch.bfloat16).float()) if bf16 else (lambda t: t)
    x, b, c, dy = (rnd(t.float()) for t in (x, b, c, dy))
    dt, a = dt.float(), a.float()
    pad = (-s) % chunk
    if pad:
        x, dy = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, dy))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        b, c = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (b, c))
    q = chunk
    nc = x.shape[1] // q
    tril = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))

    def chunk_of(z):
        sl = slice(z * q, (z + 1) * q)
        dtz = dt[:, sl]                                                # (B,Q,H)
        cs = dtz.cumsum(1)
        cum = cs * a
        e = torch.exp(cum)
        u = torch.exp(cum[:, -1:] - cum)
        expo = cum.transpose(1, 2)[..., :, None] - cum.transpose(1, 2)[..., None, :]
        lmat = torch.where(tril, torch.exp(torch.where(tril, expo, 0.0)), 0.0)   # (B,H,Q,Q)
        return sl, dtz, cs, e, u, u * dtz, lmat

    state = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    entry = []
    for z in range(nc):
        sl, dtz, _, e, _, w, _ = chunk_of(z)
        entry.append(rnd(state))
        state = state * e[:, -1, :, None, None] + torch.einsum(
            "bjhp,bjn->bhpn", rnd(w[..., None] * x[:, sl]), b[:, sl])
    dh = (torch.zeros_like(state) if dfinal is None else dfinal.float().clone())
    dx, ddt, db, dc = (torch.empty_like(t) for t in (x, dt, b, c))
    da = torch.zeros_like(a)
    for z in reversed(range(nc)):
        sl, dtz, cs, e, u, w, lmat = chunk_of(z)
        xz, bz, cz, dyz, h0 = x[:, sl], b[:, sl], c[:, sl], dy[:, sl], entry[z]
        dtj = dtz.transpose(1, 2)[:, :, None, :]                      # (B,H,1,Q)
        cb = torch.einsum("bin,bjn->bij", cz, bz)[:, None]
        dm = torch.einsum("bihp,bjhp->bhij", dyz, xz)
        m, pm, k = rnd(cb * lmat * dtj), rnd(dm * lmat * dtj), dm * cb * lmat
        dhr = rnd(dh)
        bdh = torch.einsum("bjn,bhpn->bjhp", bz, dhr)
        dx[:, sl] = torch.einsum("bhij,bihp->bjhp", m, dyz) + w[..., None] * bdh
        v = (xz * bdh).sum(-1)                                        # (B,Q,H)
        dyh0 = torch.einsum("bihp,bhpn->bihn", dyz, h0)
        qv = (cz[:, :, None] * dyh0).sum(-1)
        dc[:, sl] = (torch.einsum("bhij,bjn->bihn", pm, bz) + e[..., None] * dyh0).sum(2)
        db[:, sl] = (torch.einsum("bhij,bin->bjhn", pm, cz)
                     + w[..., None] * torch.einsum("bjhp,bhpn->bjhn", xz, dhr)).sum(2)
        row_k = torch.einsum("bhij,bhj->bih", k, dtz.transpose(1, 2))
        col_k = k.sum(2).transpose(1, 2)
        e_q = e[:, -1]                                                # (B,H)
        dcum = row_k - dtz * col_k + e * qv - w * v
        dcum[:, -1] += e_q * (dh * h0).sum((-1, -2)) + (w * v).sum(1)
        ddt[:, sl] = col_k + u * v + a * dcum.flip(1).cumsum(1).flip(1)
        da = da + (dcum * cs).sum((0, 1))
        dh = dh * e_q[..., None, None] + torch.einsum(
            "bihp,bin->bhpn", rnd(e[..., None] * dyz), cz)
    return (rnd(dx[:, :s]), ddt[:, :s], da, rnd(db[:, :s]), rnd(dc[:, :s]))
