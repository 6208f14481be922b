"""Multi-head Latent Attention (DeepSeek-V2).

Counterpart of ``repro.models.mla``, with its two paths:

* ``absorb=True`` (the default, the one the model runs): ``w_uk`` is
  absorbed into the query and ``w_uv`` into the output projection, so
  attention runs directly on the compressed cache, which is never
  decompressed; decode goes through the MLA kernels.
* ``absorb=False``, the naive / vLLM-like path, the paper's baseline: every
  step decompresses the whole latent cache to per-head K and V (``w_uk`` /
  ``w_uv`` over every cached position), then attends with the rope scores
  added. The reference computes it in jnp with no Pallas kernel, so here it
  is plain PyTorch; the paged form gathers the table's pages first, as the
  reference does.

Latent cache: ``{"ckv": (B, L, kv_lora), "kr": (B, L, rope_dim)}`` plus
external ``lengths``, as the JAX model keeps it; paged, ``(P, bs, ...)``
pages and a block table. Decode writes the new latent row IN PLACE and
hands the cache to the kernels of ``repro_torch.kernels.mla_decode`` with
``valid_len = lengths + 1`` (the model attends ``kpos <= lengths``, the
kernels ``kpos < valid_len``). The paged path gives the kernel the pages and
the table: nothing is gathered into a contiguous view first.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import dtensor as dtm
from repro_torch.kernels.mla_decode import (
    mla_fused_decode,
    mla_latent_decode,
    mla_latent_decode_ref,
    mla_paged_fused_decode,
)
from repro_torch.kernels.mla_decode.ops import _absorb_out, _absorb_q
from repro_torch.models.attention import (
    NEG_INF,
    DecodeIndex,
    _out_project,
    _project,
    _write_token,
    attention_prefill,
    decode_index,
    decode_over_split_cache,
    write_prefix,
)
from repro_torch.models.layers import normal_init, rmsnorm, rope_tables, rotate


def init_mla(generator, cfg, dtype, device, lead=()) -> Dict:
    d, h = cfg.d_model, cfg.n_heads
    rank, rope = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    nope, vdim = cfg.qk_nope_head_dim, cfg.v_head_dim
    s = 1.0 / np.sqrt(d)
    sr = 1.0 / np.sqrt(rank)
    p = {
        "w_dkv": normal_init(lead + (d, rank), generator, s, dtype, device),
        "w_kr": normal_init(lead + (d, rope), generator, s, dtype, device),
        "w_uk": normal_init(lead + (rank, h, nope), generator, sr, dtype, device),
        "w_uv": normal_init(lead + (rank, h, vdim), generator, sr, dtype, device),
        "w_o": normal_init(lead + (h, vdim, d), generator, 1.0 / np.sqrt(h * vdim),
                           dtype, device),
        "norm_kv": {"scale": torch.zeros(lead + (rank,), dtype=dtype, device=device)},
    }
    if cfg.q_lora_rank:
        qr = cfg.q_lora_rank
        p["w_dq"] = normal_init(lead + (d, qr), generator, s, dtype, device)
        p["norm_q"] = {"scale": torch.zeros(lead + (qr,), dtype=dtype, device=device)}
        p["w_uq"] = normal_init(lead + (qr, h, nope + rope), generator, 1.0 / np.sqrt(qr),
                                dtype, device)
    else:
        p["w_uq"] = normal_init(lead + (d, h, nope + rope), generator, s, dtype, device)
    return p


def _mla_scale(cfg) -> float:
    """1/sqrt(nope + rope): the scale of the full per-head query, not of the
    576-wide latent dot product the kernel computes."""
    return 1.0 / np.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)


def _queries(params, x, cos, sin, cfg):
    """-> q_nope (B,S,H,nope), q_rope (B,S,H,rope) with RoPE applied."""
    if cfg.q_lora_rank:
        cq = rmsnorm(params["norm_q"], x @ params["w_dq"], cfg.rms_eps)
        q = _project(cq, params["w_uq"])
    else:
        q = _project(x, params["w_uq"])
    nope = cfg.qk_nope_head_dim
    return q[..., :nope], rotate(q[..., nope:], cos, sin)


def _latents(params, x, cos, sin, cfg):
    """-> ckv (B,S,rank) normalised latent, kr (B,S,rope) rotary shared key
    (one head)."""
    ckv = rmsnorm(params["norm_kv"], x @ params["w_dkv"], cfg.rms_eps)
    kr = rotate((x @ params["w_kr"])[:, :, None, :], cos, sin)[:, :, 0, :]
    return ckv, kr


def _attend_naive(params, q_nope, q_rope, ckv, kr, mask, cfg, out_dtype):
    """Decompress the latents to full per-head K and V, then attend:
    q_nope (B,S,H,nope), q_rope (B,S,H,rope), ckv (B,L,rank), kr (B,L,rope),
    mask broadcastable to (B,H,S,L). Scores are summed in fp32 (the
    reference's ``preferred_element_type``; bf16 products are exact in
    fp32), the probabilities rounded to V's dtype before P.V."""
    k_nope = torch.einsum("blr,rhk->blhk", ckv, params["w_uk"])   # decompress K
    v = torch.einsum("blr,rhk->blhk", ckv, params["w_uv"])        # decompress V
    scores = torch.einsum("bshk,blhk->bhsl", q_nope.float(), k_nope.float())
    scores = scores + torch.einsum("bshk,blk->bhsl", q_rope.float(), kr.float())
    scores = scores * _mla_scale(cfg)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhsl,blhk->bshk", probs.to(v.dtype), v)
    return _out_project(ctx, params["w_o"]).to(out_dtype)


def mla_prefill(
    params: Dict,
    x: torch.Tensor,                 # (B, S, d)
    cfg,
    *,
    cache: Optional[Dict] = None,    # written at [0:S] in place when given
    absorb: bool = True,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Absorbed prefill: MQA over ``[q_lat; q_rope]`` x ``[ckv; kr]`` with
    V = ``ckv`` (one latent KV head, Dk = rank + rope, Dv = rank) through
    the plain causal ``attention_prefill``, as the reference's
    ``_attend_absorbed_blocked``; ``absorb=False``: the naive path, causal."""
    s = x.shape[1]
    positions = dtm.arange(s, x)[None, :]
    cos, sin = rope_tables(positions, cfg.qk_rope_head_dim, cfg.rope_theta)
    q_nope, q_rope = _queries(params, x, cos, sin, cfg)
    ckv, kr = _latents(params, x, cos, sin, cfg)
    if absorb:
        q_lat = torch.einsum("bshk,rhk->bshr", q_nope, params["w_uk"])
        q_cat = torch.cat([q_lat, q_rope], dim=-1)              # (B,S,H,rank+rope)
        k_cat = torch.cat([ckv, kr], dim=-1)[:, :, None, :]     # (B,S,1,rank+rope)
        ctx_lat = attention_prefill(q_cat, k_cat, ckv[:, :, None, :], scale=_mla_scale(cfg))
        ctx = torch.einsum("bshr,rhk->bshk", ctx_lat.to(ckv.dtype), params["w_uv"])
        out = _out_project(ctx, params["w_o"]).to(x.dtype)
    else:
        steps = torch.arange(s, device=x.device)
        mask = (steps[:, None] >= steps[None, :])[None, None]
        out = _attend_naive(params, q_nope, q_rope, ckv, kr, mask, cfg, x.dtype)
    if cache is not None:
        write_prefix(cache["ckv"], ckv)
        write_prefix(cache["kr"], kr)
    return out, cache


def _decode_latents(params, x, cache, index: DecodeIndex, cfg):
    """The new token's queries; its latent row written into the cache."""
    q_nope, q_rope = _queries(params, x, index.cos, index.sin, cfg)
    ckv_new, kr_new = _latents(params, x, index.cos, index.sin, cfg)
    _write_token(cache["ckv"], ckv_new, index)
    _write_token(cache["kr"], kr_new, index)
    return q_nope[:, 0], q_rope[:, 0]


def _decode_split(params, x, cache, lengths, index: DecodeIndex, cfg, plain: bool):
    """The absorbed decode over DTensor latent caches: the absorb products
    propagate, the latent row's write and kernel 4 run per shard in
    ``attention.decode_over_split_cache`` (its sequence may be split)."""
    q_nope, q_rope = _queries(params, x, index.cos, index.sin, cfg)
    ckv_new, kr_new = _latents(params, x, index.cos, index.sin, cfg)
    fn = mla_latent_decode_ref if plain else mla_latent_decode
    scale = _mla_scale(cfg)
    ctx_lat = decode_over_split_cache(
        "mla.decode", lambda qs, c, vl: fn(qs[0], qs[1], c[0], c[1], vl, scale=scale,
                                           return_lse=True),
        [_absorb_q(params["w_uk"], q_nope[:, 0]), q_rope[:, 0]],
        [ckv_new[:, 0], kr_new[:, 0]], [cache["ckv"], cache["kr"]], lengths, index=index)
    return _absorb_out(ctx_lat, params["w_uv"], params["w_o"])


def _decode_naive(params, x, q_nope, q_rope, ckv, kr, lengths, cfg):
    """The naive decode over a contiguous latent buffer (B, L, ...): the
    new token (position ``lengths``) attends ``kpos <= lengths``."""
    mask = (torch.arange(ckv.shape[1], device=x.device)[None, :]
            <= lengths.long()[:, None])[:, None, None, :]
    return _attend_naive(params, q_nope[:, None], q_rope[:, None], ckv.to(x.dtype),
                         kr.to(x.dtype), mask, cfg, x.dtype)


def mla_decode(
    params: Dict,
    x: torch.Tensor,                 # (B, 1, d)
    cache: Dict,                     # {"ckv": (B, L, rank), "kr": (B, L, rope)}
    lengths: torch.Tensor,           # (B,) valid tokens already in cache
    cfg,
    *,
    plain: bool = False,
    index: Optional[DecodeIndex] = None,
    absorb: bool = True,
) -> Tuple[torch.Tensor, Dict]:
    """Dense decode: write the new latent at ``lengths``, then attend with
    the ``mla_latent_decode`` kernel (``plain=True``: its plain version;
    ``absorb=False``: the naive path, which has no kernel).
    ``index`` is the step's ``decode_index``, built here when not given."""
    if index is None:
        index = decode_index(lengths, cfg, rope_dim=cfg.qk_rope_head_dim,
                             max_len=cache["ckv"].shape[1])
    if absorb and dtm.is_dtensor(cache["ckv"]):
        return _decode_split(params, x, cache, lengths, index, cfg, plain)[:, None].to(
            x.dtype), cache
    q_nope, q_rope = _decode_latents(params, x, cache, index, cfg)
    if not absorb:
        return _decode_naive(params, x, q_nope, q_rope, cache["ckv"], cache["kr"], lengths,
                             cfg), cache
    out = mla_fused_decode(params["w_uk"], params["w_uv"], params["w_o"], q_nope, q_rope,
                           cache["ckv"], cache["kr"], index.valid_len,
                           scale=_mla_scale(cfg), plain=plain)
    return out[:, None].to(x.dtype), cache


def mla_decode_paged(
    params: Dict,
    x: torch.Tensor,                 # (B, 1, d)
    cache: Dict,                     # {"ckv": (P, bs, rank), "kr": (P, bs, rope)}
    block_tables: torch.Tensor,      # (B, nb) int32
    lengths: torch.Tensor,           # (B,)
    active: torch.Tensor,            # (B,) bool
    cfg,
    *,
    plain: bool = False,
    index: Optional[DecodeIndex] = None,
    absorb: bool = True,
) -> Tuple[torch.Tensor, Dict]:
    """Decode over the PAGED latent cache: write the new latent through the
    block table (inactive slots to the null page), then hand the pages and
    the table to the paged kernel, which reads only the table's pages.
    ``absorb=False``: the naive path over the table's pages gathered into a
    contiguous view, as the reference's."""
    if index is None:
        index = decode_index(lengths, cfg, rope_dim=cfg.qk_rope_head_dim,
                             block_tables=block_tables, active=active,
                             block_size=cache["ckv"].shape[1])
    q_nope, q_rope = _decode_latents(params, x, cache, index, cfg)
    if not absorb:
        b = block_tables.shape[0]
        idx = block_tables.long()
        ckv = cache["ckv"][idx].reshape(b, -1, cache["ckv"].shape[-1])
        kr = cache["kr"][idx].reshape(b, -1, cache["kr"].shape[-1])
        return _decode_naive(params, x, q_nope, q_rope, ckv, kr, lengths, cfg), cache
    out = mla_paged_fused_decode(params["w_uk"], params["w_uv"], params["w_o"], q_nope,
                                 q_rope, cache["ckv"], cache["kr"], block_tables,
                                 index.valid_len, scale=_mla_scale(cfg), plain=plain)
    return out[:, None].to(x.dtype), cache
