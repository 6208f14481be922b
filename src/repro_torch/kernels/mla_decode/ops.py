"""The full absorbed MLA decode attention around the latent kernels.

Counterparts of ``repro.kernels.mla_decode.ops``: absorb ``w_uk`` into the
query -> latent flash-decode kernel -> absorb ``w_uv`` -> ``w_o``. The two
absorb einsums and the output projection are ordinary (H-batched) matrix
products left to PyTorch; the cache-touching inner loop runs in the kernel,
with no decompression traffic. The CUDA kernels mask their own ragged edge,
so the JAX wrapper's padding of L to a block multiple has no counterpart.
``plain=True`` takes the kernels' plain versions.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.mla_decode.mla_decode import (
    mla_latent_decode,
    mla_paged_latent_decode,
)
from repro_torch.kernels.mla_decode.ref import (
    mla_latent_decode_ref,
    mla_paged_latent_decode_ref,
)


def _absorb_q(w_uk: torch.Tensor, q_nope: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bhk,rhk->bhr", q_nope, w_uk).contiguous()


def _absorb_out(ctx_lat, w_uv, w_o) -> torch.Tensor:
    ctx = torch.einsum("bhr,rhk->bhk", ctx_lat.to(w_uv.dtype), w_uv)
    return torch.einsum("bhk,hkd->bd", ctx, w_o)


def mla_fused_decode(
    w_uk: torch.Tensor,       # (rank, H, nope)
    w_uv: torch.Tensor,       # (rank, H, vdim)
    w_o: torch.Tensor,        # (H, vdim, d)
    q_nope: torch.Tensor,     # (B, H, nope)
    q_rope: torch.Tensor,     # (B, H, rope)
    ckv: torch.Tensor,        # (B, L, rank)
    kr: torch.Tensor,         # (B, L, rope)
    valid_len: torch.Tensor,  # (B,) int32
    *,
    scale: float,
    plain: bool = False,
) -> torch.Tensor:            # (B, d)
    fn = mla_latent_decode_ref if plain else mla_latent_decode
    ctx_lat = fn(_absorb_q(w_uk, q_nope), q_rope.contiguous(), ckv, kr, valid_len,
                 scale=scale)
    return _absorb_out(ctx_lat, w_uv, w_o)


def mla_paged_fused_decode(
    w_uk: torch.Tensor,          # (rank, H, nope)
    w_uv: torch.Tensor,          # (rank, H, vdim)
    w_o: torch.Tensor,           # (H, vdim, d)
    q_nope: torch.Tensor,        # (B, H, nope)
    q_rope: torch.Tensor,        # (B, H, rope)
    ckv_pages: torch.Tensor,     # (P, bs, rank)
    kr_pages: torch.Tensor,      # (P, bs, rope)
    block_tables: torch.Tensor,  # (B, nb) int32
    valid_len: torch.Tensor,     # (B,) int32
    *,
    scale: float,
    plain: bool = False,
) -> torch.Tensor:               # (B, d)
    """The same over the PAGED latent cache: the kernel reads the pages the
    table names, nothing is gathered first."""
    fn = mla_paged_latent_decode_ref if plain else mla_paged_latent_decode
    ctx_lat = fn(_absorb_q(w_uk, q_nope), q_rope.contiguous(), ckv_pages, kr_pages,
                 block_tables, valid_len, scale=scale)
    return _absorb_out(ctx_lat, w_uv, w_o)
