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
    freqs = _rope_freqs(head_dim, theta, positions.device)
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


# --------------------------------------------------------------- embeddings
def init_embedding(generator, vocab: int, d_model: int, dtype, device) -> Dict:
    return {"table": normal_init((vocab, d_model), generator, 0.02, dtype, device)}


def embed(params, tokens: torch.Tensor, scale: bool, d_model: int, compute_dtype):
    x = params["table"][tokens.long()].to(compute_dtype)
    if scale:
        # a 0-dim CPU tensor multiplies as a scalar of the compute dtype
        x = x * torch.tensor(np.sqrt(d_model), dtype=compute_dtype)
    return x


def unembed(params, x: torch.Tensor, softcap: float = 0.0) -> torch.Tensor:
    logits = (x @ params["table"].T.to(x.dtype)).float()
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    return logits


def softcap_logits(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0:
        return logits
    return cap * torch.tanh(logits / cap)
