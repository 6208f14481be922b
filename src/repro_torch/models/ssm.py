"""Mamba2 / SSD block.

Counterpart of ``repro.models.ssm``. Prefill runs the chunked SSD scan of
``repro_torch.kernels.ssd`` (the hand-written CUDA kernel on a card, its
plain version on the CPU or with ``plain=True``), where the JAX model runs
its jnp ``ssd_chunked``; decode is the O(1) recurrent step ``ssd_step`` in
plain PyTorch, as the JAX model computes it outside any Pallas kernel.

State cache: ``{"ssm": (B, H, P, N) fp32, "conv": (B, K-1, conv_dim)}`` in
the compute dtype, constant size. Prefill and decode write it IN PLACE.

At bf16 the scan returns y in x's dtype, as the Pallas kernel writes it;
the JAX model keeps the chunked y in fp32 until ``d_skip * x`` is added, so
the port rounds y to bf16 once more. At fp32 the two agree to rounding.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import dtensor as dtm
from repro_torch.kernels.ssd import ssd_prefill
from repro_torch.models.layers import normal_init, rmsnorm


def _dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    heads = cfg.ssm_heads
    p = d_inner // heads
    n = cfg.ssm_state
    g = cfg.ssm_groups
    conv_dim = d_inner + 2 * g * n
    return d_inner, heads, p, n, g, conv_dim


def init_ssm(generator, cfg, dtype, device, lead=()) -> Dict:
    """``a_log``, ``d_skip`` and ``dt_bias`` are fp32 at every param dtype,
    as in the JAX init."""
    d = cfg.d_model
    d_inner, heads, p, n, g, conv_dim = _dims(cfg)
    proj_dim = 2 * d_inner + 2 * g * n + heads  # [z, x, B, C, dt]
    f32 = dict(dtype=torch.float32, device=device)
    a_log = torch.log(torch.linspace(1.0, 16.0, heads, **f32))
    return {
        "w_in": normal_init(lead + (d, proj_dim), generator, 1.0 / np.sqrt(d), dtype, device),
        "conv_w": normal_init(lead + (cfg.ssm_conv_kernel, conv_dim), generator, 0.2, dtype,
                              device),
        "conv_b": torch.zeros(lead + (conv_dim,), dtype=dtype, device=device),
        "a_log": a_log.expand(lead + (heads,)).clone(),
        "d_skip": torch.ones(lead + (heads,), **f32),
        "dt_bias": torch.zeros(lead + (heads,), **f32),
        "norm": {"scale": torch.zeros(lead + (d_inner,), dtype=dtype, device=device)},
        "w_out": normal_init(lead + (d_inner, d), generator, 1.0 / np.sqrt(d_inner), dtype,
                             device),
    }


def _split_proj(cfg, proj):
    d_inner, heads, p, n, g, _ = _dims(cfg)
    return torch.split(proj, [d_inner, d_inner, g * n, g * n, heads], dim=-1)


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor]):
    """Depthwise causal conv1d as the reference's window sum. u: (B,S,C),
    w: (K,C). Returns (silu(y), new_state (B, K-1, C)). On DTensors it runs
    per shard (``local_map`` site ``ssm.conv``: batch over the data axes,
    channels over ``model``), so neither it nor its gradient ever splits the
    sequence."""
    if dtm.is_dtensor(u):
        return _causal_conv_sharded(u, w, b, state)
    k = w.shape[0]
    if state is None:
        pad = dtm.lift(torch.zeros((u.shape[0], k - 1, u.shape[2]), dtype=u.dtype,
                                   device=u.device), u)
    else:
        pad = state.to(u.dtype)
    full = torch.cat([pad, u], dim=1)                     # (B, S+K-1, C)
    y = sum(full[:, j:j + u.shape[1], :] * w[j] for j in range(k)) + b
    return F.silu(y), full[:, full.shape[1] - (k - 1):, :]


def _causal_conv_sharded(u, w, b, state):
    mesh, (bsz, _, c) = u.device_mesh, u.shape
    act = dtm.axis_layout(mesh, batch=(0, bsz), heads=(2, c))
    wl = dtm.axis_layout(mesh, heads=(1, c))
    bl = dtm.axis_layout(mesh, heads=(0, c))
    if state is None:
        fn = lambda ul, wl_, bl_: _causal_conv(ul, wl_, bl_, None)
        batch = dtm.shard_dim_axes_of(act, 0)
        return dtm.site("ssm.conv", fn, out_placements=(act, act),
                        in_placements=(act, wl, bl), mesh=mesh,
                        in_grad_placements=(act, dtm.partial_over(wl, batch),
                                            dtm.partial_over(bl, batch)))(u, w, b)
    return dtm.site("ssm.conv", _causal_conv, out_placements=(act, act),
                    in_placements=(act, wl, bl, act), mesh=mesh)(u, w, b, state)


def _ssd_scan(x, dt, a, b, c, plain: bool):
    """The SSD scan (``kernels.ssd.ssd_prefill``). On DTensors it runs per
    shard (``local_map`` site ``ssd.scan``: batch over the data axes, heads
    over ``model``); it needs no communication, and its backward kernel
    runs on the same shards."""
    if not dtm.is_dtensor(x):
        return ssd_prefill(x, dt, a, b, c, plain=plain)
    mesh, bsz, h = x.device_mesh, x.shape[0], x.shape[2]
    lay = lambda bd, hd: dtm.axis_layout(mesh, batch=None if bd is None else (bd, bsz),
                                         heads=None if hd is None else (hd, h))
    if b.shape[2] > 1:
        # G > 1 groups: each head's own B / C row, so that a shard of the
        # heads holds its groups (autograd sums the copies back per group)
        rep = h // b.shape[2]
        b, c = (t.repeat_interleave(rep, dim=2) for t in (b, c))
        ins = (lay(0, 2), lay(0, 2), lay(None, 0), lay(0, 2), lay(0, 2))
    else:
        ins = (lay(0, 2), lay(0, 2), lay(None, 0), lay(0, None), lay(0, None))
    batch, heads = dtm.shard_dim_axes_of(ins[0], 0), dtm.shard_dim_axes_of(ins[0], 2)
    # gradients: A's partial over the batch's axes, a shared B / C's over
    # the heads'
    grads = ins[:2] + (dtm.partial_over(ins[2], batch),) + tuple(
        p if b.shape[2] > 1 else dtm.partial_over(p, heads) for p in ins[3:])
    fn = dtm.site("ssd.scan", lambda *t: ssd_prefill(*t, plain=plain),
                  out_placements=(lay(0, 2), lay(0, 1)), in_placements=ins, mesh=mesh,
                  in_grad_placements=grads)
    return fn(x, dt, a, b, c)


def ssd_step(x, dt, a, b, c, state):
    """Single-token recurrent step (decode).

    x: (B,H,P), dt: (B,H), b,c: (B,G,N), state: (B,H,P,N) fp32.
    -> y (B,H,P) fp32, new state. On DTensors it runs per shard
    (``local_map`` site ``ssm.step``: batch over the data axes, heads over
    ``model``; no communication)."""
    if dtm.is_dtensor(state):
        mesh, (bsz, h) = state.device_mesh, state.shape[:2]
        lay = lambda hd: dtm.axis_layout(mesh, batch=None if hd == 0 else (0, bsz),
                                         heads=None if hd is None else (hd, h))
        bc = lay(None)
        if b.shape[1] > 1:      # G > 1 groups: each head's own row, split as the heads
            b, c = (t.repeat_interleave(h // b.shape[1], dim=1) for t in (b, c))
            bc = lay(1)
        return dtm.site("ssm.step", ssd_step, out_placements=(lay(1), lay(1)),
                        in_placements=(lay(1), lay(1), lay(0), bc, bc, lay(1)),
                        mesh=mesh)(x, dt, a, b, c, state)
    rep = x.shape[1] // b.shape[1]
    bh = b.repeat_interleave(rep, dim=1).float()          # (B,H,N)
    ch = c.repeat_interleave(rep, dim=1).float()
    dt32 = dt.float()
    decay = torch.exp(dt32 * a[None, :])                  # (B,H)
    upd = (dt32[:, :, None] * x.float())[..., None] * bh[:, :, None, :]
    new_state = state * decay[:, :, None, None] + upd
    y = torch.einsum("bhpn,bhn->bhp", new_state, ch)
    return y, new_state


def _gates(params, x, cfg):
    """In-projection of x (B,S,d) -> z, the conv input [x; B; C], dt (fp32)."""
    # on DTensors the in-projection is gathered whole before it is split
    # (splitting a dim sharded over ``model`` reshards along the sequence)
    z, xs, b, c, dtp = _split_proj(cfg, dtm.constrain_batch(x @ params["w_in"]))
    return z, torch.cat([xs, b, c], dim=-1), F.softplus(dtp.float() + params["dt_bias"])


def _finish(params, y, xs, z, x, cfg):
    """y (B,S,H,P) + d_skip * x in fp32 -> gated RMSNorm -> out-projection."""
    bsz, s = x.shape[0], x.shape[1]
    d_inner = y.shape[2] * y.shape[3]
    y = y.float() + params["d_skip"][None, None, :, None] * xs.float()
    y = y.reshape(bsz, s, d_inner).to(x.dtype)
    y = rmsnorm(params["norm"], y * F.silu(z), cfg.rms_eps)
    return y @ params["w_out"]


def ssm_prefill(params: Dict, x: torch.Tensor, cfg, *, cache: Optional[Dict] = None,
                plain: bool = False) -> Tuple[torch.Tensor, Optional[Dict]]:
    """The whole (padded) prompt; the final SSM and conv states are written
    into ``cache`` in place. ``plain=True`` scans with the kernel's plain
    version."""
    bsz, s, _ = x.shape
    d_inner, heads, p, n, g, conv_dim = _dims(cfg)
    z, conv_in, dtv = _gates(params, x, cfg)
    conv_out, conv_state = _causal_conv(conv_in, params["conv_w"], params["conv_b"], None)
    xs, b, c = torch.split(conv_out, [d_inner, g * n, g * n], dim=-1)
    xs = xs.reshape(bsz, s, heads, p)
    y, final_state = _ssd_scan(xs, dtv, -torch.exp(params["a_log"]),
                               b.reshape(bsz, s, g, n), c.reshape(bsz, s, g, n), plain)
    out = _finish(params, y, xs, z, x, cfg)
    if cache is not None:
        cache["ssm"].copy_(final_state)
        cache["conv"].copy_(conv_state)
    return out, cache


def ssm_decode(params: Dict, x: torch.Tensor, cache: Dict, cfg
               ) -> Tuple[torch.Tensor, Dict]:
    """One token (B, 1, d) for every row; the states update in place."""
    bsz = x.shape[0]
    d_inner, heads, p, n, g, conv_dim = _dims(cfg)
    z, conv_in, dtv = _gates(params, x, cfg)                  # conv_in (B,1,conv_dim)
    conv_out, conv_state = _causal_conv(conv_in, params["conv_w"], params["conv_b"],
                                        cache["conv"])
    xs, b, c = torch.split(conv_out[:, 0], [d_inner, g * n, g * n], dim=-1)
    xs = xs.reshape(bsz, heads, p)
    y, new_state = ssd_step(xs, dtv[:, 0], -torch.exp(params["a_log"]),
                            b.reshape(bsz, g, n), c.reshape(bsz, g, n), cache["ssm"])
    out = _finish(params, y[:, None], xs[:, None], z, x, cfg)
    cache["ssm"].copy_(new_state)
    cache["conv"].copy_(conv_state)
    return out, cache
