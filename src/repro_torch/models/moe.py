"""Mixture-of-Experts MLP (DeepSeek-V2 style: shared + routed top-k).

Counterpart of ``repro.models.moe``, with the reference's capacity
dispatch: a softmax router in fp32, top-k experts per token, each (token,
slot) entry ranked within its expert by a one-hot cumsum in (token, slot)
order, entries ranked at or past the capacity dropped, the routed experts'
products batched over the expert axis, the gathered outputs weighted by the
top-k gates, plus the shared experts' swiglu MLP. The Switch-style
load-balance loss is ``load_balance_loss`` over the router's output: the
serving model never uses it, as the reference's model drops it.

Every expert multiplies its whole ``(capacity, d)`` buffer, so a step
streams all experts' weights whatever the router picks, as the reference's
formulation does. Built to be captured in a CUDA graph: no host sync, no
data-dependent shape, and no atomics. Each (expert, rank) slot of the
dispatch buffer is written at most once (dropped entries go to a spare
overflow row, never multiplied); a dropped entry gathers some row of its
expert's output and weighs it by 0, and the combine sums each token's k
weighted outputs in slot order, the order in which the reference's
scatter-add over tokens accumulates them.

The expert products are plain ``torch.bmm``: the reference computes them
with jnp einsums, outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import dtensor as dtm
from repro_torch.models.layers import init_mlp, mlp, normal_init


def init_moe(generator, cfg, dtype, device, lead=()) -> Dict:
    """``router`` (d, E) fp32 at every param dtype, as the JAX init makes
    it; the routed experts' ``w_gate`` / ``w_up`` (E, d, ff) and ``w_down``
    (E, ff, d); ``shared`` a swiglu MLP of width ``n_shared_experts *
    moe_d_ff``."""
    d, e, ff = cfg.d_model, cfg.n_routed_experts, cfg.moe_d_ff
    s_in, s_out = 1.0 / np.sqrt(d), 1.0 / np.sqrt(ff)
    p = {
        "router": normal_init(lead + (d, e), generator, s_in, torch.float32, device),
        "w_gate": normal_init(lead + (e, d, ff), generator, s_in, dtype, device),
        "w_up": normal_init(lead + (e, d, ff), generator, s_in, dtype, device),
        "w_down": normal_init(lead + (e, ff, d), generator, s_out, dtype, device),
    }
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(generator, d, cfg.n_shared_experts * ff, "swiglu", dtype,
                               device, lead)
    return p


def _capacity(cfg, n_tokens: int) -> int:
    per = n_tokens * cfg.moe_top_k / cfg.n_routed_experts
    return max(8, int(np.ceil(per * cfg.moe_capacity_factor)))


def route(params: Dict, xf: torch.Tensor, cfg) -> Tuple[torch.Tensor, ...]:
    """xf (T, d) -> (gates (T, E) fp32 softmax of the router, top-k gates
    (T, k), their experts (T, k))."""
    gates = torch.softmax(xf.float() @ params["router"], dim=-1)
    topw, topi = torch.topk(gates, cfg.moe_top_k, dim=-1)
    return gates, topw, topi


def load_balance_loss(gates: torch.Tensor, topi: torch.Tensor) -> torch.Tensor:
    """The Switch-style aux loss ``E * sum_e f_e * p_e`` of ``route``'s
    gates and chosen experts: f_e the share of (token, slot) entries routed
    to expert e, p_e its mean gate."""
    e = gates.shape[-1]
    density = F.one_hot(topi, e).float().mean(dim=(0, 1))
    return e * torch.sum(density * gates.mean(dim=0))


def moe_mlp(params: Dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """x (B, S, d) -> out (B, S, d)."""
    b, s, d = x.shape
    if dtm.is_dtensor(x):
        out = _routed_sharded(params, x, cfg)
    else:
        out = _routed(x.reshape(b * s, d), params["router"], params["w_gate"], params["w_up"],
                      params["w_down"], cfg).reshape(b, s, d)
    if "shared" in params:
        out = out + mlp(params["shared"], x, "swiglu")
    return out


def _routed(xf, router, w_gate, w_up, w_down, cfg, e_lo: int = 0,
            shard=None) -> torch.Tensor:
    """The routed experts over tokens xf (T, d) -> (T, d). ``w_*`` may hold
    only experts ``[e_lo, e_lo + E_loc)`` (one rank's share): entries routed
    to other experts then weigh 0 here, and the ranks' outputs sum to the
    whole. ``shard`` makes xf one shard of a larger token batch (``(mesh,
    mesh dims the tokens are split over)``): the capacity is then the whole
    batch's and each entry's rank within its expert counts the entries of
    the shards before this one (``_global_offsets``), so that exactly the
    entries the unsplit batch drops are dropped."""
    t, d = xf.shape
    e, k = cfg.n_routed_experts, cfg.moe_top_k
    e_loc = w_gate.shape[0]
    _, topw, topi = route({"router": router}, xf, cfg)

    # rank of each (token, slot) entry within its expert, in (token, slot)
    # order: the one-hot cumsum, taken along the inner dimension (E, T*k)
    flat_e = topi.reshape(-1)                                              # (T*k,)
    onehot = F.one_hot(flat_e, e).t()                                      # (E, T*k)
    pos = ((onehot.cumsum(1) - 1) * onehot).sum(0)                         # (T*k,)
    if shard is None:
        cap = _capacity(cfg, t)
    else:
        offsets, shards = _global_offsets(onehot.sum(1), *shard)
        cap = _capacity(cfg, t * shards)
        pos = pos + offsets[flat_e]
    keep = pos < cap
    if e_loc != e:                  # entries of other ranks' experts: dropped here
        flat_e = flat_e - e_lo
        keep = keep & (flat_e >= 0) & (flat_e < e_loc)
        flat_e = flat_e.clamp(0, e_loc - 1)
    pos_c = torch.where(keep, pos, torch.full_like(pos, cap))              # cap: overflow row

    tok_idx = torch.arange(t, device=xf.device).repeat_interleave(k)
    disp = torch.zeros((e_loc, cap + 1, d), dtype=xf.dtype, device=xf.device)
    disp[flat_e, pos_c] = xf[tok_idx]
    routed = disp[:, :cap]
    h = F.silu(torch.bmm(routed, w_gate)) * torch.bmm(routed, w_up)
    y_exp = torch.bmm(h, w_down)                                           # (E, cap, d)

    gathered = y_exp[flat_e, pos_c.clamp(max=cap - 1)]                     # (T*k, d)
    weights = torch.where(keep, topw.reshape(-1), torch.zeros_like(topw.reshape(-1)))
    contrib = (gathered * weights.to(xf.dtype)[:, None]).reshape(t, k, d)
    combined = contrib[:, 0]
    for j in range(1, k):
        combined = combined + contrib[:, j]
    return combined


def _global_offsets(counts: torch.Tensor, mesh, dims) -> Tuple[torch.Tensor, int]:
    """Per expert, the entries routed to it by the token shards before this
    rank's, in the unsplit batch's order (mesh order over ``dims``, the
    first dim outermost), and the shard count: one all-gather of the (E,)
    ``counts`` over each of ``dims``, innermost first. On meta tensors (the
    dry run) the offsets are zeros."""
    import torch.distributed as dist

    offsets = torch.zeros_like(counts)
    shards = 1
    for dim in reversed(dims):
        n = mesh.size(dim)
        shards *= n
        if counts.device.type == "meta":
            continue
        parts = [torch.empty_like(counts) for _ in range(n)]
        dist.all_gather(parts, counts, group=mesh.get_group(dim))
        offsets = offsets + sum(parts[:mesh.get_local_rank(dim)], torch.zeros_like(counts))
        counts = sum(parts[1:], parts[0])
    return offsets, shards


def _routed_sharded(params: Dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """The routed experts over DTensors, as expert parallelism (``local_map``
    site ``moe.experts``): tokens split over the data axes as the batch is,
    the experts over the mesh dims that split their weights' expert dim.
    Each rank routes its tokens with the whole batch's capacity, ranking
    each entry within its expert after the entries of the token shards
    before its own (one all-gather of per-expert counts: the reference's
    GSPMD dispatch drops what one device drops), runs its own experts and
    weighs 0 the entries of others: a partial sum over the experts' axes,
    which DTensor completes.
    The weights' FSDP shards are gathered first. Gradients: the tokens'
    partial over the experts' axes, the weights' over the batch's (the
    router's over both)."""
    from torch.distributed.tensor import Replicate, Shard

    mesh, x = x.device_mesh, dtm.pin_grad(x)
    exp_dims = dtm.shard_dim_axes_of(params["w_gate"].placements, 0)
    x_pl = dtm.batch_only(x)
    w_pl = tuple(Shard(0) if i in exp_dims else Replicate() for i in range(mesh.ndim))
    rep = dtm.replicate(w_pl)

    batch = dtm.shard_dim_axes_of(x_pl, 0)

    def local(xl, router, wg, wu, wd):
        b, s, d = xl.shape
        e_lo = dtm.shard_index(mesh, exp_dims) * wg.shape[0]
        return _routed(xl.reshape(b * s, d), router, wg, wu, wd, cfg, e_lo,
                       shard=(mesh, batch) if batch else None).reshape(b, s, d)

    return dtm.site("moe.experts", local, out_placements=(dtm.partial_over(x_pl, exp_dims),),
                    in_placements=(x_pl, rep, w_pl, w_pl, w_pl), mesh=mesh,
                    in_grad_placements=(dtm.partial_over(x_pl, exp_dims),
                                        dtm.partial_over(rep, batch + exp_dims))
                    + (dtm.partial_over(w_pl, batch),) * 3)(
        x, params["router"], params["w_gate"], params["w_up"], params["w_down"])
