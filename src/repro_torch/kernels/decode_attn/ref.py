"""Plain PyTorch versions of the flash-decode kernels.

Transcriptions of ``repro.kernels.decode_attn.ref``: one query row per
request, KV cache with per-request valid lengths, grouped queries
(H = KV * G), asymmetric K/V head dims allowed. The CPU path and the
kernels' comparisons on the card use them; nothing on the main path calls
them when a card is present.

The logit softcap and the sliding window are the reference model's
(``repro.models.attention`` ``_grouped_scores`` / ``_decode_attend``): the
scaled score goes through ``softcap * tanh(s / softcap)`` before the mask,
and key ``kpos`` is attended iff ``valid_len - window <= kpos < valid_len``
(the model's ``lengths - kpos < window`` with ``lengths = valid_len - 1``);
0 is none. ``valid_len`` may exceed L (a shard of a split cache): keys
past L do not exist, and the window still starts at ``valid_len - window``.
``return_lse=True`` also returns each row's log-sum-exp of its attended
scores (``with_lse``), what a cross-rank combine weighs the row by.
"""
from __future__ import annotations

import torch

NEG_INF = -2.3819763e38


def decode_attention_ref(
    q: torch.Tensor,          # (B, H, Dk)
    k: torch.Tensor,          # (B, L, KV, Dk)
    v: torch.Tensor,          # (B, L, KV, Dv)
    valid_len: torch.Tensor,  # (B,) int32 — attends to kpos < valid_len
    scale: float,
    *,
    softcap: float = 0.0,
    window: int = 0,
    return_lse: bool = False,
):                            # (B, H, Dv), and with return_lse (B, H) fp32
    b, h, dk = q.shape
    l, kv = k.shape[1], k.shape[2]
    g = h // kv
    qg = q.reshape(b, kv, g, dk)
    scores = torch.einsum("bkgd,blkd->bkgl", qg.float(), k.float()) * scale
    if softcap > 0:
        scores = softcap * torch.tanh(scores / softcap)
    kpos = torch.arange(l, device=q.device)[None, :]
    vl = valid_len.long()[:, None]
    mask = kpos < vl
    if window > 0:
        mask &= kpos >= vl - window
    mask = mask[:, None, None, :]
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bkgl,blkd->bkgd", probs, v.float())
    out = ctx.reshape(b, h, v.shape[-1]).to(q.dtype)
    if not return_lse:
        return out
    return with_lse(out, scores, mask, (b, h))


def with_lse(out: torch.Tensor, scores: torch.Tensor, mask: torch.Tensor, rows: tuple):
    """(out, lse) of masked ``scores`` (..., keys): the natural-log
    log-sum-exp of the attended scores, -inf where a row attends no key
    (the kernels' convention), whose output is then 0, not the mean of
    every value."""
    lse = torch.logsumexp(scores.masked_fill(~mask, float("-inf")), dim=-1).reshape(rows)
    none = torch.isinf(lse)[..., None]
    return out.masked_fill(none, 0), lse


def paged_decode_attention_ref(
    q: torch.Tensor,             # (B, H, Dk)
    k_pages: torch.Tensor,       # (P, bs, KV, Dk)
    v_pages: torch.Tensor,       # (P, bs, KV, Dv)
    block_tables: torch.Tensor,  # (B, nb)
    valid_len: torch.Tensor,     # (B,)
    scale: float,
    *,
    softcap: float = 0.0,
    window: int = 0,
    return_lse: bool = False,
):
    """Gather the pages each request's table names into a contiguous view,
    then defer to the dense version — paging must be pure layout."""
    b = q.shape[0]
    bs, kv = k_pages.shape[1], k_pages.shape[2]
    nb = block_tables.shape[1]
    idx = block_tables.long()
    k = k_pages[idx].reshape(b, nb * bs, kv, k_pages.shape[-1])
    v = v_pages[idx].reshape(b, nb * bs, kv, v_pages.shape[-1])
    return decode_attention_ref(q, k, v, valid_len, scale, softcap=softcap, window=window,
                                return_lse=return_lse)
