"""Plain PyTorch versions of the MLA latent-decode kernels.

Transcriptions of ``repro.kernels.mla_decode.ref``: absorbed MLA attention
over the COMPRESSED cache, as MQA with one shared latent head. Scores
against ``[ckv; kr]``, values ``ckv``; scores, softmax and context in fp32,
the result cast to q's dtype; keys ``kpos < valid_len`` are attended
(``return_lse=True`` adds each row's log-sum-exp, -inf and output 0 where
no key is: ``decode_attn.ref.with_lse``). The
CPU path and the kernels' comparisons on the card use them; nothing on the
main path calls them when a card is present.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attn.ref import with_lse

NEG_INF = -2.3819763e38


def mla_latent_decode_ref(
    q_lat: torch.Tensor,      # (B, H, rank) — w_uk-absorbed nope queries
    q_rope: torch.Tensor,     # (B, H, rope)
    ckv: torch.Tensor,        # (B, L, rank) — compressed latent cache
    kr: torch.Tensor,         # (B, L, rope) — shared rotary key cache
    valid_len: torch.Tensor,  # (B,) int32 — attends to kpos < valid_len
    scale: float,
    *,
    return_lse: bool = False,
):                            # (B, H, rank) — latent context (w_uv applied outside)
    s = torch.einsum("bhr,blr->bhl", q_lat.float(), ckv.float())
    s = s + torch.einsum("bhk,blk->bhl", q_rope.float(), kr.float())
    s = s * scale
    kpos = torch.arange(ckv.shape[1], device=q_lat.device)
    mask = (kpos[None, :] < valid_len[:, None])[:, None, :]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhl,blr->bhr", p, ckv.float())
    out = ctx.to(q_lat.dtype)
    if not return_lse:
        return out
    return with_lse(out, s, mask, tuple(out.shape[:2]))


def mla_paged_latent_decode_ref(
    q_lat: torch.Tensor,         # (B, H, rank)
    q_rope: torch.Tensor,        # (B, H, rope)
    ckv_pages: torch.Tensor,     # (P, bs, rank)
    kr_pages: torch.Tensor,      # (P, bs, rope)
    block_tables: torch.Tensor,  # (B, nb)
    valid_len: torch.Tensor,     # (B,)
    scale: float,
) -> torch.Tensor:
    """Gather the pages each request's table names into the contiguous
    layout, then defer to the dense version — paging must be pure layout."""
    b = q_lat.shape[0]
    bs = ckv_pages.shape[1]
    nb = block_tables.shape[1]
    idx = block_tables.long()
    ckv = ckv_pages[idx].reshape(b, nb * bs, ckv_pages.shape[-1])
    kr = kr_pages[idx].reshape(b, nb * bs, kr_pages.shape[-1])
    return mla_latent_decode_ref(q_lat, q_rope, ckv, kr, valid_len, scale)
