"""Chunked softmax cross-entropy over huge vocabularies.

Counterpart of ``repro.training.losses``. 256 k-vocab configs (gemma,
nemotron) cannot hold (B, S, V) fp32 logits, so the loss loops over
sequence chunks, computing logits -> logsumexp -> label gather per chunk,
each chunk under ``torch.utils.checkpoint`` so the backward recomputes the
chunk's (B, chunk, V) logits instead of storing them. The sequence is
padded to a chunk multiple with mask 0.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.layers import softcap_logits


def _chunk_loss(h, table, labels, mask, final_softcap: float) -> torch.Tensor:
    logits = (h @ table.T.to(h.dtype)).float()                   # (B, c, V)
    logits = softcap_logits(logits, final_softcap)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return torch.sum((lse - gold) * mask)


def chunked_softmax_xent(
    hidden: torch.Tensor,        # (B, S, d)
    table: torch.Tensor,         # (V, d) embedding / unembedding matrix
    labels: torch.Tensor,        # (B, S) int
    *,
    mask: Optional[torch.Tensor] = None,   # (B, S) bool / float; 0 = ignore
    chunk: int = 512,
    final_softcap: float = 0.0,
) -> torch.Tensor:
    """Mean token loss over the unmasked positions (sum over max(mask
    sum, 1)), a 0-dim fp32 tensor."""
    b, s, d = hidden.shape
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.float32, device=hidden.device)
    mask = mask.to(torch.float32)
    pad = (-s) % chunk
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, s + pad, chunk):
        sl = slice(i, i + chunk)
        total = total + checkpoint(_chunk_loss, hidden[:, sl], table, labels[:, sl],
                                   mask[:, sl], final_softcap, use_reentrant=False)
    return total / torch.clamp(mask.sum(), min=1.0)
