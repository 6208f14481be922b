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

from repro_torch import dtensor as dtm
from repro_torch.models.layers import softcap_logits


def _chunk_loss(h, table, labels, mask, final_softcap: float) -> torch.Tensor:
    logits = (h @ table.T.to(h.dtype)).float()                   # (B, c, V)
    logits = softcap_logits(logits, final_softcap)
    if dtm.is_dtensor(logits) and logits.device_mesh.size() > 1:
        vocab_dims = dtm.shard_dim_axes_of(table.placements, 0)
        lse, gold = _lse_gold_sharded(logits, labels, vocab_dims)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return torch.sum((lse - gold) * mask)


def _lse_gold_sharded(logits, labels, vocab_dims):
    """logsumexp and gold logit of DTensor ``logits`` whose vocab may be
    split over mesh dims ``vocab_dims`` (the table's): each rank reduces its own
    slice (``local_map`` site ``losses.vocab_slice``) into a trailing dim
    of one entry per slice, and the slices' few numbers are then reduced
    as DTensors, so the (B, c, V) logits are never gathered and autograd
    runs through both steps. (DTensor's own gather of a vocab-split or
    partial-sum tensor leaves a masked partial that fails to reduce.)"""
    from torch.distributed.tensor import Shard

    mesh = logits.device_mesh
    lab_pl = dtm.batch_only(labels)
    log_pl = tuple(Shard(2) if i in vocab_dims else lab_pl[i] for i in range(mesh.ndim))

    def local(lg, lab):
        n = lg.shape[-1]
        t = lab.long() - dtm.shard_index(mesh, vocab_dims) * n
        hit = (t >= 0) & (t < n)
        g = lg.gather(-1, t.clamp(0, n - 1)[..., None]) * hit[..., None]
        return torch.logsumexp(lg, dim=-1, keepdim=True), g

    lse_parts, gold_parts = dtm.site(
        "losses.vocab_slice", local, out_placements=(log_pl, log_pl),
        in_placements=(log_pl, lab_pl), mesh=mesh)(logits, labels)
    return torch.logsumexp(lse_parts, dim=-1), gold_parts.sum(dim=-1)


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
        mask = dtm.lift(torch.ones((b, s), dtype=torch.float32, device=hidden.device),
                        hidden)
    mask = mask.to(torch.float32)
    pad = (-s) % chunk
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
    total = dtm.lift(torch.zeros((), dtype=torch.float32, device=hidden.device), hidden)
    for i in range(0, s + pad, chunk):
        sl = slice(i, i + chunk)
        total = total + checkpoint(_chunk_loss, hidden[:, sl], table, labels[:, sl],
                                   mask[:, sl], final_softcap, use_reentrant=False)
    return total / torch.clamp(mask.sum(), min=1.0)
