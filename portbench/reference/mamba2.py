"""Plain float32 reference of a Mamba2 (SSD) language model (mamba2-780m's
shape): the whole sequence in one causal pass, no cache, no kernels.

Per layer: x += Mixer(RMSNorm(x)). The mixer projects to z, x, B, C and dt;
x, B and C pass a depthwise causal convolution (width K, bias) and SiLU;
dt = softplus(dt + dt_bias); with A = -exp(A_log) per head, the state of
head h runs h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T and reads
y_t = h_t C_t + D x_t (head h reads B/C group h // (H / G)); then
RMSNorm(y * silu(z)) and the out-projection. RMSNorm scales by
(1 + scale). The final RMSNorm's output is unembedded by the embedding
table (tied). The scan is the chunked (state-space dual) form of that
recurrence, exact in float32. It reads the tree laid out by
``param_spec``.

With ``precision="fp8"`` every matmul's two inputs are first rounded to
float8 e4m3 (the control).
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, List, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.gqa import _f8, _mm, _norm

CHUNK = 64


def _dims(cfg: dict):
    d_inner = cfg["ssm_expand"] * cfg["d_model"]
    h, n, g = cfg["ssm_heads"], cfg["ssm_state"], cfg["ssm_groups"]
    return d_inner, h, d_inner // h, n, g, d_inner + 2 * g * n


def param_spec(cfg: dict) -> List[Tuple[tuple, tuple, float]]:
    """(path, shape, scale) of every leaf, drawn normal(0, 1) x scale. The
    decay, skip and step-bias leaves are drawn too: A_log around log 4,
    D around 0 and dt_bias around -1 (``weights.make_params`` adds the
    ``offset`` entries of ``OFFSETS``)."""
    d, v, k = cfg["d_model"], cfg["vocab_size"], cfg["ssm_conv_kernel"]
    d_inner, h, p, n, g, conv = _dims(cfg)
    out = [(("embed", "table"), (v, d), 0.02), (("final_norm", "scale"), (d,), 0.1)]
    for si, stage in enumerate(cfg["stages"]):
        u = stage["n_units"]
        for bi, kind in enumerate(stage["unit"]):
            if kind != "ssm":
                raise ValueError(f"mamba2 reference: block kind {kind!r}")
            b = ("stages", si, f"b{bi}")
            s = b + ("ssm",)
            out += [(b + ("norm1", "scale"), (u, d), 0.1),
                    (s + ("w_in",), (u, d, 2 * d_inner + 2 * g * n + h), 1 / math.sqrt(d)),
                    (s + ("conv_w",), (u, k, conv), 0.2),
                    (s + ("conv_b",), (u, conv), 0.1),
                    (s + ("a_log",), (u, h), 0.5),
                    (s + ("d_skip",), (u, h), 0.5),
                    (s + ("dt_bias",), (u, h), 0.5),
                    (s + ("norm", "scale"), (u, d_inner), 0.1),
                    (s + ("w_out",), (u, d_inner, d), 1 / math.sqrt(d_inner))]
    return out


# leaves the port keeps in fp32 at every param dtype, and the value each
# draw is centred on
OFFSETS = {"a_log": math.log(4.0), "d_skip": 0.0, "dt_bias": -1.0}


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a (..., L) -> (..., L, L): sum of a over (j, i] at [i, j], -inf
    above the diagonal."""
    ln = a.shape[-1]
    c = torch.cumsum(a, dim=-1)
    s = c[..., :, None] - c[..., None, :]
    mask = torch.ones(ln, ln, dtype=torch.bool, device=a.device).tril()
    return s.masked_fill(~mask, float("-inf"))


def ssd(x, dt, a, b, c):
    """x (T,H,P), dt (T,H), a (H,), b/c (T,H,N) -> y (T,H,P): the chunked
    form of h_t = exp(dt_t a) h_{t-1} + dt_t x_t b_t^T, y_t = h_t c_t."""
    t = x.shape[0]
    pad = (-t) % CHUNK
    xb = F.pad(x * dt[..., None], (0, 0, 0, 0, 0, pad))
    da = F.pad(dt * a, (0, 0, 0, pad))
    b, c = (F.pad(z, (0, 0, 0, 0, 0, pad)) for z in (b, c))
    nc = (t + pad) // CHUNK
    xb, b, c = (z.reshape(nc, CHUNK, *z.shape[1:]) for z in (xb, b, c))
    da = da.reshape(nc, CHUNK, -1).permute(2, 0, 1)               # (H, nc, L)
    cum = torch.cumsum(da, dim=-1)
    y = torch.einsum("clhn,cshn,hcls,cshp->clhp", c, b, torch.exp(_segsum(da)), xb)
    decay = torch.exp(cum[..., -1:] - cum)                          # (H, nc, L)
    states = torch.einsum("clhn,hcl,clhp->chpn", b, decay, xb)
    states = torch.cat([torch.zeros_like(states[:1]), states], dim=0)
    chunk_decay = torch.exp(_segsum(F.pad(cum[..., -1], (1, 0))))  # (H, nc+1, nc+1)
    states = torch.einsum("hzc,chpn->zhpn", chunk_decay, states)[:-1]
    y = y + torch.einsum("clhn,chpn,hcl->clhp", c, states, torch.exp(cum))
    return y.reshape(nc * CHUNK, *y.shape[2:])[:t]


def _mixer(sp: Dict, x: torch.Tensor, cfg: dict, precision: str) -> torch.Tensor:
    t = x.shape[0]
    d_inner, h, p, n, g, conv = _dims(cfg)
    proj = _mm(x, sp["w_in"], precision)
    z, xs, bb, cc, dtr = torch.split(proj, [d_inner, d_inner, g * n, g * n, h], dim=-1)
    u = torch.cat([xs, bb, cc], dim=-1)
    w = sp["conv_w"].float()
    k = w.shape[0]
    full = torch.cat([torch.zeros(k - 1, u.shape[1], device=x.device), u], dim=0)
    u = F.silu(sum(full[j:j + t] * w[j] for j in range(k)) + sp["conv_b"].float())
    xs, bb, cc = torch.split(u, [d_inner, g * n, g * n], dim=-1)
    dt = F.softplus(dtr + sp["dt_bias"].float())
    rep = h // g
    bb = bb.view(t, g, n).repeat_interleave(rep, dim=1)
    cc = cc.view(t, g, n).repeat_interleave(rep, dim=1)
    xh = xs.view(t, h, p)
    y = ssd(xh, dt, -torch.exp(sp["a_log"].float()), bb, cc)
    y = (y + sp["d_skip"].float()[None, :, None] * xh).reshape(t, d_inner)
    y = _norm(y * F.silu(z), sp["norm"]["scale"], cfg["rms_eps"])
    return _mm(y, sp["w_out"], precision)


def hidden(params: Dict, cfg: dict, tokens: torch.Tensor, precision: str = "fp32"
           ) -> torch.Tensor:
    """Final-normed hidden states (T, d) fp32 of one sequence ``tokens`` (T,)."""
    x = params["embed"]["table"][tokens.long()].float()
    for si, stage in enumerate(cfg["stages"]):
        blocks = params["stages"][si]
        for un in range(stage["n_units"]):
            for bi in range(len(stage["unit"])):
                bp = blocks[f"b{bi}"]
                sp = {k: (v[un] if torch.is_tensor(v) else {kk: vv[un] for kk, vv in v.items()})
                      for k, v in bp["ssm"].items()}
                x = x + _mixer(sp, _norm(x, bp["norm1"]["scale"][un], cfg["rms_eps"]), cfg,
                               precision)
    return _norm(x, params["final_norm"]["scale"], cfg["rms_eps"])


def logits_blocks(params: Dict, cfg: dict, h: torch.Tensor, precision: str = "fp32",
                  rows: int = 256) -> Iterator[torch.Tensor]:
    wt = params["embed"]["table"].float().T
    if precision == "fp8":
        wt = _f8(wt, 0)
    for i in range(0, h.shape[0], rows):
        x = h[i:i + rows]
        yield (_f8(x, -1) if precision == "fp8" else x) @ wt
