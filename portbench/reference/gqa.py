"""Plain float32 reference of a pre-norm GQA decoder (minitron-4b's shape):
the whole sequence in one causal pass, no cache, no batching, no kernels.

Per layer: x += Attn(RMSNorm(x)); x += MLP(RMSNorm(x)). RMSNorm scales by
(1 + scale). Attention: rotary embedding (split halves, the first half of
each head's dimensions paired with the second, at positions 0..T-1),
query head h reads key/value head h // (H / KV), causal softmax at
1 / sqrt(head_dim). MLP: squared ReLU (relu(x W_up)^2 W_down) or a gated
one. The final RMSNorm's output is unembedded by the embedding table (tied
head). It reads the parameter tree laid out by ``param_spec``.

With ``precision="fp8"`` every matmul's two inputs are first rounded to
float8 e4m3 (weights per output column, activations per row, scaled to the
format's range): the control, a lower precision than the bfloat16 served.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, List, Tuple

import torch

F8_MAX = 448.0


def param_spec(cfg: dict) -> List[Tuple[tuple, tuple, float]]:
    """(path, shape, scale) of every leaf: each is drawn normal(0, 1) times
    ``scale``; a norm's scale is drawn around 0, since RMSNorm multiplies
    by 1 + scale."""
    d, h, kv, hd, ff, v = (cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"],
                           cfg["d_ff"], cfg["vocab_size"])
    out = [(("embed", "table"), (v, d), 0.02), (("final_norm", "scale"), (d,), 0.1)]
    for si, stage in enumerate(cfg["stages"]):
        n = stage["n_units"]
        for bi, kind in enumerate(stage["unit"]):
            if kind != "attn":
                raise ValueError(f"gqa reference: block kind {kind!r}")
            p = ("stages", si, f"b{bi}")
            out += [(p + ("norm1", "scale"), (n, d), 0.1),
                    (p + ("attn", "wq"), (n, d, h, hd), 1 / math.sqrt(d)),
                    (p + ("attn", "wk"), (n, d, kv, hd), 1 / math.sqrt(d)),
                    (p + ("attn", "wv"), (n, d, kv, hd), 1 / math.sqrt(d)),
                    (p + ("attn", "wo"), (n, h, hd, d), 1 / math.sqrt(h * hd)),
                    (p + ("norm2", "scale"), (n, d), 0.1),
                    (p + ("mlp", "w_up"), (n, d, ff), 1 / math.sqrt(d)),
                    (p + ("mlp", "w_down"), (n, ff, d), 1 / math.sqrt(ff))]
            if cfg["mlp_type"] in ("swiglu", "geglu"):
                out.append((p + ("mlp", "w_gate"), (n, d, ff), 1 / math.sqrt(d)))
    return out


def _f8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along ``dim``."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = amax / F8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _mm(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """x (T, K) @ w (K, N) in fp32, or with both inputs rounded to fp8."""
    w = w.float()
    if precision == "fp8":
        return _f8(x, -1) @ _f8(w, 0)
    return x @ w


def _norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + scale.float())


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (T, heads, hd): rotate the pairs (i, i + hd/2) by pos * theta^(-2i/hd)."""
    t, hd = x.shape[0], x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float64) / hd))
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] \
        * inv.to(torch.float32).to(x.device)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    a, b = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def _layer(bp: Dict, x: torch.Tensor, cfg: dict, precision: str) -> torch.Tensor:
    t, d = x.shape
    h, kv, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    eps = cfg["rms_eps"]
    a = bp["attn"]
    y = _norm(x, bp["norm1"]["scale"], eps)
    q = _rope(_mm(y, a["wq"].reshape(d, h * hd), precision).view(t, h, hd), cfg["rope_theta"])
    k = _rope(_mm(y, a["wk"].reshape(d, kv * hd), precision).view(t, kv, hd), cfg["rope_theta"])
    v = _mm(y, a["wv"].reshape(d, kv * hd), precision).view(t, kv, hd)
    group = h // kv
    k = k.repeat_interleave(group, dim=1)                 # head j reads kv head j // group
    v = v.repeat_interleave(group, dim=1)
    scores = torch.einsum("thd,shd->hts", q, k) / math.sqrt(hd)
    causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    ctx = torch.einsum("hts,shd->thd", torch.softmax(scores, dim=-1), v)
    del scores
    x = x + _mm(ctx.reshape(t, h * hd), a["wo"].reshape(h * hd, d), precision)
    m = bp["mlp"]
    y = _norm(x, bp["norm2"]["scale"], eps)
    up = _mm(y, m["w_up"], precision)
    if cfg["mlp_type"] == "squared_relu":
        act = torch.relu(up).square()
    elif cfg["mlp_type"] == "swiglu":
        act = torch.nn.functional.silu(_mm(y, m["w_gate"], precision)) * up
    else:
        act = torch.nn.functional.gelu(_mm(y, m["w_gate"], precision), approximate="tanh") * up
    return x + _mm(act, m["w_down"], precision)


def hidden(params: Dict, cfg: dict, tokens: torch.Tensor, precision: str = "fp32"
           ) -> torch.Tensor:
    """Final-normed hidden states (T, d) fp32 of one sequence ``tokens`` (T,)."""
    x = params["embed"]["table"][tokens.long()].float()
    for si, stage in enumerate(cfg["stages"]):
        sp = params["stages"][si]
        for u in range(stage["n_units"]):
            for bi in range(len(stage["unit"])):
                bp = {name: {k: t[u] for k, t in leaf.items()}
                      for name, leaf in sp[f"b{bi}"].items()}
                x = _layer(bp, x, cfg, precision)
    return _norm(x, params["final_norm"]["scale"], cfg["rms_eps"])


def logits_blocks(params: Dict, cfg: dict, h: torch.Tensor, precision: str = "fp32",
                  rows: int = 256) -> Iterator[torch.Tensor]:
    """Logits (rows, V) fp32 of ``h`` (T, d), a block of rows at a time."""
    wt = params["embed"]["table"].float().T
    if precision == "fp8":
        wt = _f8(wt, 0)
    for i in range(0, h.shape[0], rows):
        x = h[i:i + rows]
        yield (_f8(x, -1) if precision == "fp8" else x) @ wt
