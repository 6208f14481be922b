"""Plain PyTorch version of the causal prefill-attention kernel.

The function of ``repro.models.flash.flash_attention`` (its forward,
``_flash_fwd_impl``) computed in one pass over each row's keys: scores are
products of the q and k elements summed in fp32, scaled, then softcapped,
then masked (``kpos <= qpos``, and ``qpos - kpos < window`` when ``window >
0``); the softmax is in fp32, its unnormalised probabilities ``exp(s - m)``
are rounded to v's dtype before P.V, whose products are summed in fp32,
and one division by the row's sum comes last. The kernel takes the row max
``m`` as it streams the keys, the reference block by block; here it is the
whole row's. A row with no key gives 0. The CPU path and the kernel's
comparisons on the card use it; nothing on the main path calls it.
"""
from __future__ import annotations

import torch


def prefill_attention_ref(
    q: torch.Tensor,   # (B, S, H, D)
    k: torch.Tensor,   # (B, L, KV, D)
    v: torch.Tensor,   # (B, L, KV, Dv)
    scale: float,
    *,
    softcap: float = 0.0,
    window: int = 0,
) -> torch.Tensor:     # (B, S, H, Dv), q's dtype
    b, s, h, dk = q.shape
    l, kv, dv = k.shape[1], k.shape[2], v.shape[-1]
    qg = q.reshape(b, s, kv, h // kv, dk)
    sc = torch.einsum("bskgd,blkd->bkgsl", qg.float(), k.float()) * scale
    if softcap > 0:
        sc = softcap * torch.tanh(sc / softcap)
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(l, device=q.device)[None, :]
    mask = kpos <= qpos
    if window > 0:
        mask &= (qpos - kpos) < window
    sc = sc.masked_fill(~mask, float("-inf"))
    m = sc.amax(-1, keepdim=True)
    p = torch.exp(sc - m.masked_fill(torch.isinf(m), 0.0))
    ctx = torch.einsum("bkgsl,blkd->bskgd", p.to(v.dtype).float(), v.float())
    den = p.sum(-1).permute(0, 3, 1, 2)[..., None]          # (B, S, KV, G, 1)
    return (ctx / den.clamp_min(1e-30)).reshape(b, s, h, dv).to(q.dtype)
