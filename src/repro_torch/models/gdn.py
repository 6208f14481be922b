"""Gated DeltaNet (GDN) block.

Counterpart of ``repro.models.gdn``. Per head the state S (K x V, fp32)
follows the gated delta rule

    S_t = alpha_t (S_{t-1} - beta_t k_t (k_t^T S_{t-1})) + beta_t k_t v_t^T
    y_t = S_t^T q_t

Prefill runs the scan of ``repro_torch.kernels.gdn`` (the hand-written CUDA
kernel on a card, its plain version on the CPU or with ``plain=True``),
where the JAX model runs its unfused jnp scan; decode is the single step
``gdn_step`` in plain PyTorch, as the JAX model computes it outside any
Pallas kernel. State cache: ``{"gdn": (B, H, K, K) fp32}``, written IN
PLACE.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import dtensor as dtm
from repro_torch.kernels.gdn import gdn_prefill as gdn_scan_prefill
from repro_torch.models.attention import _project
from repro_torch.models.layers import normal_init, rmsnorm


def _dims(cfg):
    h, k = cfg.gdn_heads, cfg.gdn_head_dim
    return h, k, h * k


def init_gdn(generator, cfg, dtype, device, lead=()) -> Dict:
    d = cfg.d_model
    h, k, inner = _dims(cfg)
    s = 1.0 / np.sqrt(d)
    return {
        "wq": normal_init(lead + (d, h, k), generator, s, dtype, device),
        "wk": normal_init(lead + (d, h, k), generator, s, dtype, device),
        "wv": normal_init(lead + (d, h, k), generator, s, dtype, device),
        "w_beta": normal_init(lead + (d, h), generator, s, dtype, device),
        "w_alpha": normal_init(lead + (d, h), generator, s, dtype, device),
        "w_gate": normal_init(lead + (d, h, k), generator, s, dtype, device),
        "norm": {"scale": torch.zeros(lead + (inner,), dtype=dtype, device=device)},
        "w_out": normal_init(lead + (inner, d), generator, 1.0 / np.sqrt(inner), dtype,
                             device),
    }


def _l2norm(x, eps=1e-6):
    return x * torch.rsqrt(x.square().sum(dim=-1, keepdim=True) + eps)


def _qkv_gates(params, x, cfg):
    """-> q, k (L2-normalised), v (B,S,H,K) fp32; beta, alpha (B,S,H) fp32."""
    q = _l2norm(_project(x, params["wq"]).float())
    k = _l2norm(_project(x, params["wk"]).float())
    v = _project(x, params["wv"]).float()
    beta = torch.sigmoid((x @ params["w_beta"]).float())
    # decay gate in (0,1), biased toward 1 (slow forgetting) at init
    alpha = torch.sigmoid((x @ params["w_alpha"]).float() + 4.0)
    return q, k, v, beta, alpha


def gdn_step(q, k, v, beta, alpha, state):
    """Single decode step. q,k,v: (B,H,K); beta,alpha: (B,H); state (B,H,K,K)."""
    ks = torch.einsum("bhk,bhkv->bhv", k, state)
    b4, a4 = beta[..., None, None], alpha[..., None, None]
    state = a4 * (state - b4 * (k[..., :, None] * ks[..., None, :])) \
        + b4 * (k[..., :, None] * v[..., None, :])
    y = torch.einsum("bhkv,bhk->bhv", state, q)
    return y, state


def _finish(params, y, x, cfg):
    bsz, s = y.shape[0], y.shape[1]
    y = y.to(x.dtype) * F.silu(_project(x, params["w_gate"]))
    y = rmsnorm(params["norm"], y.reshape(bsz, s, -1), cfg.rms_eps)
    return y @ params["w_out"]


def _gdn_scan(q, k, v, beta, alpha, *, plain: bool):
    """The gated-delta-rule scan (``kernels.gdn.gdn_prefill``). On DTensors
    it runs per shard (``local_map`` site ``gdn.scan``: batch over the data
    axes, heads over ``model``); it needs no communication, and its
    backward kernels run on the same shards."""
    if not dtm.is_dtensor(q):
        return gdn_scan_prefill(q, k, v, beta, alpha, plain=plain)
    mesh, bsz, h = q.device_mesh, q.shape[0], q.shape[2]
    lay = lambda hd: dtm.axis_layout(mesh, batch=(0, bsz), heads=(hd, h))
    fn = dtm.site("gdn.scan", lambda *t: gdn_scan_prefill(*t, plain=plain),
                  out_placements=(lay(2), lay(1)),
                  in_placements=(lay(2),) * 5, mesh=mesh)
    return fn(q, k, v, beta, alpha)


def gdn_prefill(params: Dict, x: torch.Tensor, cfg, *, cache: Optional[Dict] = None,
                plain: bool = False) -> Tuple[torch.Tensor, Optional[Dict]]:
    """The whole (padded) prompt; the final state is written into ``cache``
    in place. ``plain=True`` scans with the kernel's plain version."""
    y, final = _gdn_scan(*_qkv_gates(params, x, cfg), plain=plain)
    out = _finish(params, y, x, cfg)
    if cache is not None:
        cache["gdn"].copy_(final)
    return out, cache


def gdn_decode(params: Dict, x: torch.Tensor, cache: Dict, cfg) -> Tuple[torch.Tensor, Dict]:
    """One token (B, 1, d) for every row; the state updates in place."""
    q, k, v, beta, alpha = _qkv_gates(params, x, cfg)
    y, new_state = gdn_step(q[:, 0], k[:, 0], v[:, 0], beta[:, 0], alpha[:, 0], cache["gdn"])
    out = _finish(params, y[:, None], x, cfg)
    cache["gdn"].copy_(new_state)
    return out, cache
