"""Shared neural layers: RMSNorm, RoPE, MLP variants, embeddings.

Counterpart of ``repro.models.layers``. Layers are functional over plain
dicts of tensors; dtypes follow the config's ``param_dtype`` /
``compute_dtype``; normalisation statistics and softmax are always fp32.
"""
from __future__ import annotations

import functools
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import dtensor as dtm


def dt(name: str) -> torch.dtype:
    return getattr(torch, name)


def normal_init(shape, generator: torch.Generator, scale: float, dtype, device) -> torch.Tensor:
    """``normal(shape) * scale`` drawn in fp32 on the generator's device,
    then cast and moved (the JAX init draws fp32 and casts the same way);
    scaled in place, so a large leaf needs no second fp32 copy. On
    ``device="meta"`` it draws nothing (``generator`` may be None) and
    returns the leaf's shape and dtype: the dry run's abstract params."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    x = torch.randn(shape, generator=generator, device=generator.device,
                    dtype=torch.float32)
    return x.mul_(scale).to(device=device, dtype=dtype)


# --------------------------------------------------------------------- norm
def init_rmsnorm(d: int, dtype, device) -> Dict[str, torch.Tensor]:
    return {"scale": torch.zeros((d,), dtype=dtype, device=device)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with (1 + scale) parameterisation (gemma-style zeros init)."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + params["scale"].float())).to(x.dtype)


# --------------------------------------------------------------------- rope
def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))


@functools.lru_cache(maxsize=32)
def _rope_freqs(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """fp32 frequencies from the float64 numpy table, as the reference
    casts them; cached per device so a decode step copies nothing."""
    return torch.from_numpy(rope_frequencies(head_dim, theta).astype(np.float32)).to(device)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """(cos, sin) of the rotary angles, shaped (..., seq, 1, head_dim/2) to
    broadcast over heads; positions: (..., seq)."""
    freqs = dtm.lift(_rope_freqs(head_dim, theta, positions.device), positions)
    angles = positions.float()[..., None] * freqs      # (..., seq, hd/2)
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Split-half rotation (not interleaved) by precomputed ``rope_tables``."""
    x32 = x.float()
    x1, x2 = x32.chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, split-half (not interleaved).

    x: (..., seq, heads, head_dim); positions: broadcastable to (..., seq).
    """
    return rotate(x, *rope_tables(positions, x.shape[-1], theta))


# --------------------------------------------------------------------- mlp
def init_mlp(generator, d_model: int, d_ff: int, mlp_type: str, dtype, device,
             lead=()) -> Dict:
    gated = mlp_type in ("swiglu", "geglu")
    scale_in = 1.0 / np.sqrt(d_model)
    scale_out = 1.0 / np.sqrt(d_ff)
    params = {
        "w_up": normal_init(lead + (d_model, d_ff), generator, scale_in, dtype, device),
        "w_down": normal_init(lead + (d_ff, d_model), generator, scale_out, dtype, device),
    }
    if gated:
        params["w_gate"] = normal_init(lead + (d_model, d_ff), generator, scale_in,
                                   dtype, device)
    return params


def mlp(params, x: torch.Tensor, mlp_type: str) -> torch.Tensor:
    if dtm.is_dtensor(x):
        return _mlp_sharded(params, x, mlp_type)
    up = x @ params["w_up"]
    if mlp_type == "swiglu":
        act = F.silu(x @ params["w_gate"]) * up
    elif mlp_type == "geglu":
        act = F.gelu(x @ params["w_gate"], approximate="tanh") * up
    elif mlp_type == "squared_relu":
        act = F.relu(up).square()
    else:
        raise ValueError(mlp_type)
    return act @ params["w_down"]


def _mlp_sharded(params, x: torch.Tensor, mlp_type: str) -> torch.Tensor:
    """The MLP over DTensors as tensor parallelism (``local_map`` site
    ``layers.mlp``): the hidden width split over the mesh dims that split
    ``w_up``'s (its FSDP shards gathered first), tokens as ``x``'s batch;
    each rank's partial output is summed by DTensor (``Partial``). In the
    backward ``x``'s gradient is partial over those dims and the weights'
    over the batch's. DTensor's own strategy search over a 3-axis mesh
    reaches sequence-split layouts here that take it minutes."""
    from torch.distributed.tensor import Replicate, Shard

    mesh, x = x.device_mesh, dtm.pin_grad(x)
    tp = dtm.shard_dim_axes_of(params["w_up"].placements, 1)
    x_pl = dtm.batch_only(x)
    batch = dtm.shard_dim_axes_of(x_pl, 0)
    w_pl = lambda d: tuple(Shard(d) if i in tp else Replicate() for i in range(mesh.ndim))
    out_pl = dtm.partial_over(x_pl, tp)
    keys = ["w_up", "w_down"] + (["w_gate"] if "w_gate" in params else [])
    dims = {"w_up": 1, "w_gate": 1, "w_down": 0}

    def local(xl, *ws):
        return mlp(dict(zip(keys, ws)), xl, mlp_type)

    return dtm.site("layers.mlp", local, out_placements=(out_pl,),
                    in_placements=(x_pl,) + tuple(w_pl(dims[k]) for k in keys), mesh=mesh,
                    in_grad_placements=(out_pl,) + tuple(
                        dtm.partial_over(w_pl(dims[k]), batch) for k in keys))(
        x, *(params[k] for k in keys))


# --------------------------------------------------------------- embeddings
def init_embedding(generator, vocab: int, d_model: int, dtype, device) -> Dict:
    return {"table": normal_init((vocab, d_model), generator, 0.02, dtype, device)}


def embed(params, tokens: torch.Tensor, scale: bool, d_model: int, compute_dtype):
    table = params["table"]
    if dtm.is_dtensor(table) and table.device_mesh.size() > 1:
        x = _embed_sharded(table, tokens).to(compute_dtype)
    else:
        x = table[tokens.long()].to(compute_dtype)
    if scale:
        # a 0-dim CPU tensor multiplies as a scalar of the compute dtype
        x = x * dtm.lift(torch.tensor(np.sqrt(d_model), dtype=compute_dtype,
                                      device=x.device if dtm.is_dtensor(x) else None), x)
    return x


def _embed_sharded(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The lookup over a DTensor table whose vocab may be split over ranks
    (``local_map`` site ``layers.embed``; DTensor's own indexing of a table
    by a token tensor split over two mesh axes fails): each rank looks up
    the tokens in its range and zeroes the rest, a partial sum over the
    vocab's axes that DTensor completes (differentiably). The table's other
    dim is gathered first (an FSDP shard, as GSPMD gathers it); the rows
    come out laid out as the tokens, and the table's gradient is partial
    over their batch axes."""
    from torch.distributed.tensor import Replicate, Shard

    mesh, vocab_dims = table.device_mesh, dtm.shard_dim_axes_of(table.placements, 0)
    tab_pl = tuple(Shard(0) if i in vocab_dims else Replicate() for i in range(mesh.ndim))
    tok_pl = dtm.batch_only(tokens)

    def local(tab, tok):
        if not vocab_dims:
            return F.embedding(tok.long(), tab)
        n = tab.shape[0]
        off = dtm.shard_index(mesh, vocab_dims) * n
        t = tok.long() - off
        hit = (t >= 0) & (t < n)
        return F.embedding(t.clamp(0, n - 1), tab) * hit[..., None].to(tab.dtype)

    return dtm.site("layers.embed", local, out_placements=(dtm.partial_over(tok_pl, vocab_dims),),
                    in_placements=(tab_pl, tok_pl), mesh=mesh,
                    in_grad_placements=(
                        dtm.partial_over(tab_pl, dtm.shard_dim_axes_of(tok_pl, 0)), tok_pl))(
        table, tokens)


def unembed(params, x: torch.Tensor, softcap: float = 0.0) -> torch.Tensor:
    logits = (x @ params["table"].T.to(x.dtype)).float()
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    return logits


def softcap_logits(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0:
        return logits
    return cap * torch.tanh(logits / cap)
