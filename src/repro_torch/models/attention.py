"""GQA/MQA self-attention (prefill, dense decode and paged decode) and
cross-attention.

Counterpart of ``repro.models.attention``. Same cache convention: a
cache is ``{"k": (B, L_max, n_kv, hd), "v": ...}`` plus external per-example
``lengths: (B,)`` giving the tokens already cached; decode writes the new
token at ``lengths`` and attends over ``lengths + 1`` entries.

Cross-attention encodes the encoder states' k/v once (prefill and the
training forward); decode reuses the cached encoder k/v unchanged.

Unlike the JAX functions, the decode paths write the new token into the
cache IN PLACE and return the same cache dict.

Decode attention goes through the kernel wrappers of
``repro_torch.kernels.decode_attn`` with ``valid_len = lengths + 1``: the
model attends ``kpos <= lengths``, the kernels ``kpos < valid_len``. The
logit softcap (``cfg.attn_softcap``) and, on the local ``attn`` layers only,
the sliding window (``cfg.sliding_window``) are applied inside the kernels
(``softcap=``, ``window=``), where the reference applies both in jnp around
its attention (``_decode_attend``).

Prefill attention (``attention_prefill``) takes the causal flash kernel of
``repro_torch.kernels.prefill_attn`` where it applies (``prefill_kernel_takes``:
bf16 on the card, equal head dims the kernel was built for, no gradient
wanted), and otherwise its plain PyTorch code.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import dtensor as dtm
from repro_torch.kernels.decode_attn import (
    decode_attention,
    decode_attention_ref,
    paged_decode_attention,
    paged_decode_attention_ref,
)
from repro_torch.kernels.prefill_attn import HEAD_DIMS, prefill_attention
from repro_torch.models.layers import (
    apply_rope,
    normal_init,
    rope_tables,
    rotate,
    softcap_logits,
)

NEG_INF = -2.3819763e38  # large negative, safe in bf16/fp32


def init_attention(generator, cfg, dtype, device, lead=()) -> Dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = 1.0 / np.sqrt(d)
    so = 1.0 / np.sqrt(h * hd)
    return {
        "wq": normal_init(lead + (d, h, hd), generator, s, dtype, device),
        "wk": normal_init(lead + (d, kv, hd), generator, s, dtype, device),
        "wv": normal_init(lead + (d, kv, hd), generator, s, dtype, device),
        "wo": normal_init(lead + (h, hd, d), generator, so, dtype, device),
    }


def _attn_scale(cfg) -> float:
    return cfg.attn_scale if cfg.attn_scale else 1.0 / np.sqrt(cfg.head_dim)


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul (on DTensors per shard:
    ``_project_sharded``)."""
    if dtm.is_dtensor(w):
        return _project_sharded(x, w)
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).unflatten(-1, (h, k))


def _project_sharded(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``_project`` under ``local_map`` (site ``attention.project``), the
    split chosen per mesh dim from ``w``'s: heads split -> the output's heads
    split (``x``'s gradient partial); ``d`` split on a dim the batch does not
    use -> ``x`` cut along ``d`` and the output a partial sum; any other
    split of ``w`` (its head dim ``k``, an FSDP shard of ``d``) gathered
    first. DTensor's own propagation reaches splits of ``h * k`` that no
    view back to (h, k) can take."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = w.device_mesh
    x_pl, out_pl, w_pl, x_grad = [], [], [], []
    for i, (px, pw) in enumerate(zip(dtm.batch_only(x), w.placements)):
        if pw.is_shard() and pw.dim == 1:
            x_pl.append(px); w_pl.append(pw); out_pl.append(Shard(2)); x_grad.append(Partial())
        elif pw.is_shard() and pw.dim == 0 and not px.is_shard():
            x_pl.append(Shard(2)); w_pl.append(pw); out_pl.append(Partial())
            x_grad.append(Shard(2))
        else:
            x_pl.append(px); w_pl.append(Replicate()); out_pl.append(px); x_grad.append(px)
    x_pl, w_pl, out_pl = tuple(x_pl), tuple(w_pl), tuple(out_pl)
    return dtm.site("attention.project", _project, out_placements=(out_pl,),
                    in_placements=(x_pl, w_pl), mesh=mesh,
                    in_grad_placements=(
                        tuple(x_grad), dtm.partial_over(w_pl, dtm.shard_dim_axes_of(x_pl, 0))))(
        dtm.pin_grad(x), w)


def _out_project(ctx: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matmul."""
    h, k, d = wo.shape
    return ctx.flatten(-2) @ wo.reshape(h * k, d)


def prefill_kernel_takes(q, k, v) -> bool:
    """Whether ``attention_prefill`` hands (q, k, v) to the prefill kernel:
    all three bf16 on the card (or on meta, the dry run's stand-in for it),
    Dk == Dv among the kernel's ``HEAD_DIMS``, and no gradient wanted. The
    training forward, MLA's asymmetric prefill (Dk = latent + rope, Dv =
    latent), fp32 models and CPU tensors keep the plain code."""
    return (q.device.type in ("cuda", "meta")
            and q.dtype == k.dtype == v.dtype == torch.bfloat16
            and q.shape[-1] == k.shape[-1] == v.shape[-1] in HEAD_DIMS
            and not (torch.is_grad_enabled()
                     and (q.requires_grad or k.requires_grad or v.requires_grad)))


def attention_prefill(q, k, v, *, scale: float, window: int = 0,
                      softcap: float = 0.0, plain: bool = False) -> torch.Tensor:
    """Causal grouped attention for prefill: the counterpart of
    ``repro.models.flash.attention_prefill_auto``. Where
    ``prefill_kernel_takes`` (and not ``plain``), the kernel
    ``prefill_attention`` (the function of the reference's blocked branch);
    else plain PyTorch (its naive branch; both compute the same function).
    q (B,S,H,Dk), k (B,L,KV,Dk), v (B,L,KV,Dv) -> (B,S,H,Dv). On DTensors it
    runs per shard (``_per_head_shard``, site ``attention.prefill``)."""
    if dtm.is_dtensor(q):
        return _per_head_shard("attention.prefill", lambda *t: attention_prefill(
            *t, scale=scale, window=window, softcap=softcap, plain=plain), q, k, v)
    if not plain and prefill_kernel_takes(q, k, v):
        return prefill_attention(q.contiguous(), k.contiguous(), v.contiguous(), scale=scale,
                                 softcap=softcap, window=window)
    b, s, h, dk = q.shape
    l, kv = k.shape[1], k.shape[2]
    g = h // kv
    qg = q.reshape(b, s, kv, g, dk)
    sc = torch.einsum("bskgd,blkd->bkgsl", qg.float(), k.float()) * scale
    sc = softcap_logits(sc, softcap)
    qpos = dtm.arange(s, sc)[:, None]
    kpos = dtm.arange(l, sc)[None, :]
    mask = kpos <= qpos
    if window > 0:
        mask &= (qpos - kpos) < window
    sc = torch.where(mask, sc, torch.full_like(sc, NEG_INF))
    p = torch.softmax(sc, dim=-1)
    ctx = torch.einsum("bkgsl,blkd->bskgd", p.to(v.dtype), v)
    return ctx.reshape(b, s, h, v.shape[-1])


def _per_head_shard(name: str, fn, q, k, v):
    """``fn(q, k, v)``, an attention core over (B, S|L, heads, D) tensors,
    under ``local_map`` (site ``name``): batch over the data axes, KV heads
    (and their query groups) over ``model`` where the KV heads divide it,
    else every head on every ``model`` rank. No communication; its einsums
    are never split by DTensor's strategy search, which a 3-axis mesh
    makes slow."""
    mesh = q.device_mesh
    kv_pl = dtm.axis_layout(mesh, batch=(0, q.shape[0]), heads=(2, k.shape[2]))
    return dtm.site(name, fn, out_placements=(kv_pl,), in_placements=(kv_pl,) * 3,
                    mesh=mesh)(q, k, v)


def self_attention_prefill(
    params: Dict,
    x: torch.Tensor,                 # (B, S, d)
    cfg,
    *,
    is_global: bool,
    cache: Optional[Dict] = None,    # written at [0:S] in place when given
    plain: bool = False,             # the plain attention core, never the kernel
) -> Tuple[torch.Tensor, Optional[Dict]]:
    b, s, _ = x.shape
    positions = dtm.arange(s, x)[None, :]
    q = apply_rope(_project(x, params["wq"]), positions, cfg.rope_theta)
    k = apply_rope(_project(x, params["wk"]), positions, cfg.rope_theta)
    v = _project(x, params["wv"])
    window = 0 if is_global else cfg.sliding_window
    ctx = attention_prefill(q, k, v, scale=_attn_scale(cfg), window=window,
                            softcap=cfg.attn_softcap, plain=plain).to(x.dtype)
    out = _out_project(ctx, params["wo"])
    if cache is not None:
        write_prefix(cache["k"], k)
        write_prefix(cache["v"], v)
    return out, cache


def write_prefix(buf: torch.Tensor, new: torch.Tensor) -> None:
    """``buf[:, :S] = new`` IN PLACE (new (B, S, ...), buf (B, L, ...)). On
    a DTensor cache whose sequence is split over ranks, each rank writes
    the rows of its own range (``local_map`` site ``write_prefix``): ``new`` is cut
    as the cache is where S == L, else replicated over the sequence's axes
    and sliced."""
    if not dtm.is_dtensor(buf):
        buf[:, :new.shape[1]] = new.to(buf.dtype)
        return
    mesh, seq_dims, s = buf.device_mesh, dtm.shard_dim_axes_of(buf.placements, 1), new.shape[1]
    even = s == buf.shape[1]
    new_pl = buf.placements if even else dtm.batch_only(buf)

    def local(b, n):
        if even:
            b.copy_(n.to(b.dtype))
            return b
        n_loc = b.shape[1]
        off = dtm.shard_index(mesh, seq_dims) * n_loc
        hi = min(max(s - off, 0), n_loc)
        if hi:
            b[:, :hi] = n[:, off:off + hi].to(b.dtype)
        return b

    dtm.site("write_prefix", local, out_placements=(buf.placements,),
             in_placements=(buf.placements, new_pl), mesh=mesh)(buf, new)


def self_attention_prefill_suffix(
    params: Dict,
    x: torch.Tensor,                 # (1, S, d) suffix tokens only
    cache: Dict,                     # holds valid K/V for [0, prefix_len)
    prefix_len: torch.Tensor,        # (1,) int32
    cfg,
    *,
    is_global: bool,
) -> Tuple[torch.Tensor, Dict]:
    """Prefill a suffix on top of an already populated cache prefix (prefix
    sharing): only the suffix is projected, at positions ``prefix_len + i``,
    and written into the cache there IN PLACE (the start clamped so the S
    rows fit, as the reference's dynamic slice clamps); its queries attend
    over the whole buffer with the mask ``kpos <= position`` (and the window
    on local blocks), so the math matches a full prefill position for
    position. Batch is 1, as in the reference.

    Rounding, as the reference's ``_grouped_scores`` / ``_attend`` (which
    this path takes instead of the flash switch): scores are products of
    the ``x.dtype`` q and cached k summed in fp32 (here both operands are
    cast to fp32 first; bf16 products are exact in fp32, so only the
    summation order can differ), softmax in fp32, and the probabilities are
    rounded to v's dtype before P.V."""
    b, s, _ = x.shape
    if b != 1:
        raise ValueError(f"suffix prefill is batch-1 (got batch={b})")
    steps = torch.arange(s, device=x.device)
    positions = prefix_len.long()[:, None] + steps[None, :]            # (1, S)
    q = apply_rope(_project(x, params["wq"]), positions, cfg.rope_theta)
    k = apply_rope(_project(x, params["wk"]), positions, cfg.rope_theta)
    v = _project(x, params["wv"])
    l_max = cache["k"].shape[1]
    rows = prefix_len.long().clamp(max=l_max - s)[0] + steps
    cache["k"][0, rows] = k[0].to(cache["k"].dtype)
    cache["v"][0, rows] = v[0].to(cache["v"].dtype)

    kpos = torch.arange(l_max, device=x.device)[None, None, :]         # (1, 1, L)
    valid = kpos <= positions[:, :, None]                              # (1, S, L)
    if not is_global and cfg.sliding_window > 0:
        valid &= (positions[:, :, None] - kpos) < cfg.sliding_window
    h, n_kv, hd = q.shape[2], cache["k"].shape[2], q.shape[3]
    qg = q.reshape(b, s, n_kv, h // n_kv, hd)
    sc = torch.einsum("bskgd,blkd->bkgsl", qg.float(),
                      cache["k"].to(x.dtype).float()) * _attn_scale(cfg)
    sc = softcap_logits(sc, cfg.attn_softcap)
    sc = torch.where(valid[:, None, None], sc, torch.full_like(sc, NEG_INF))
    p = torch.softmax(sc, dim=-1)
    vb = cache["v"].to(x.dtype)
    ctx = torch.einsum("bkgsl,blkd->bskgd", p.to(vb.dtype), vb)
    ctx = ctx.reshape(b, s, h, vb.shape[-1]).to(x.dtype)
    return _out_project(ctx, params["wo"]), cache


@dataclasses.dataclass
class DecodeIndex:
    """What every layer of one decode step shares, computed once per step:
    the new token's rope tables, the kernels' ``valid_len`` and where the
    token's K/V row is written. Dense: slot row and position, with ``keep``
    False where the length already fills the row (nothing is written there,
    as the reference's mask-select writes nothing). Paged: physical page and
    offset through the block table, inactive slots routed to the null page
    0 (their stale table rows may name pages since given to another
    request)."""
    cos: torch.Tensor
    sin: torch.Tensor
    valid_len: torch.Tensor            # (B,) int32 = lengths + 1
    rows: torch.Tensor                 # (B,) slot row | physical page
    pos: torch.Tensor                  # (B,) position in the row | page offset
    keep: Optional[torch.Tensor]       # (B,) dense only


def decode_index(lengths: torch.Tensor, cfg, *, rope_dim: int, max_len: int = 0,
                 block_tables: Optional[torch.Tensor] = None,
                 active: Optional[torch.Tensor] = None,
                 block_size: int = 0) -> DecodeIndex:
    """The ``DecodeIndex`` of a dense (``max_len``) or a paged
    (``block_tables``, ``active``, ``block_size``) decode step, with rope
    tables ``rope_dim`` wide (``cfg.head_dim`` for GQA, the shared rope
    width ``cfg.qk_rope_head_dim`` for MLA)."""
    cos, sin = rope_tables(lengths[:, None], rope_dim, cfg.rope_theta)
    ln = lengths.long()
    if block_tables is None:
        rows = dtm.arange(ln.shape[0], ln)
        pos = ln.clamp(max=max_len - 1)
        keep = ln < max_len
    else:
        nb = block_tables.shape[1]
        blk = (ln // block_size).clamp(0, nb - 1)
        phys = block_tables.long().gather(1, blk[:, None])[:, 0]
        rows = torch.where(active, phys, torch.zeros_like(phys))
        pos = ln % block_size
        keep = None
    return DecodeIndex(cos, sin, (lengths + 1).to(torch.int32), rows, pos, keep)


def _write_token(buf: torch.Tensor, new: torch.Tensor, index: DecodeIndex) -> None:
    """Write the new token's row (B,1,...) into ``buf`` IN PLACE: one
    indexed write where the JAX version rebuilds the buffer (a mask-select
    for the dense cache, a scatter for the pages)."""
    val = new[:, 0].to(buf.dtype)
    if index.keep is not None:
        keep = index.keep.view((-1,) + (1,) * (val.dim() - 1))
        val = torch.where(keep, val, buf[index.rows, index.pos])
    buf[index.rows, index.pos] = val


def _decode_qkv(params, x, index: DecodeIndex):
    """Shared decode-step projections: rope'd q and new-token k/v rows."""
    q = rotate(_project(x, params["wq"]), index.cos, index.sin)
    k_new = rotate(_project(x, params["wk"]), index.cos, index.sin)
    v_new = _project(x, params["wv"])
    return q, k_new, v_new


def _kernel_options(cfg, is_global: bool) -> Dict:
    """The decode kernels' ``softcap`` and ``window`` for a layer: the
    window on local layers only, as the reference masks."""
    return {"softcap": cfg.attn_softcap, "window": 0 if is_global else cfg.sliding_window}


def self_attention_decode(
    params: Dict,
    x: torch.Tensor,                 # (B, 1, d)
    cache: Dict,
    lengths: torch.Tensor,           # (B,) valid tokens already in cache
    cfg,
    *,
    is_global: bool,
    plain: bool = False,
    index: Optional[DecodeIndex] = None,
) -> Tuple[torch.Tensor, Dict]:
    """Dense decode: write the new token at ``lengths``, then attend with
    the ``decode_attention`` kernel (``plain=True``: its plain version).
    ``index`` is the step's ``decode_index``, built here when not given."""
    if index is None:
        index = decode_index(lengths, cfg, rope_dim=cfg.head_dim, max_len=cache["k"].shape[1])
    q, k_new, v_new = _decode_qkv(params, x, index)
    fn = decode_attention_ref if plain else decode_attention
    opts = dict(scale=_attn_scale(cfg), **_kernel_options(cfg, is_global))
    if dtm.is_dtensor(cache["k"]):
        ctx = decode_over_split_cache(
            "attention.decode", lambda qs, kv, vl: fn(qs[0], kv[0], kv[1], vl, return_lse=True,
                                                      **opts),
            [q[:, 0]], [k_new[:, 0], v_new[:, 0]], [cache["k"], cache["v"]], lengths,
            window=opts["window"], index=index)
    else:
        _write_token(cache["k"], k_new, index)
        _write_token(cache["v"], v_new, index)
        ctx = fn(q[:, 0].contiguous(), cache["k"], cache["v"], index.valid_len, **opts)
    return _out_project(ctx[:, None].to(x.dtype), params["wo"]), cache


def decode_over_split_cache(name: str, attend, queries, new_rows, caches, lengths, *,
                            window: int = 0, index: Optional[DecodeIndex] = None
                            ) -> torch.Tensor:
    """One decode step's cache write and attention over DTensor caches
    whose batch may be split over the data axes and whose SEQUENCE may be
    split over others (``_CACHE_RULES``: gemma-2b's kv=1 cannot split
    heads), under ``local_map`` (site ``name``).

    ``queries`` and ``new_rows`` are per-row tensors (B, ...), ``caches``
    the (B, L, ...) leaves the rows are written into, ``lengths`` (B,).
    On each rank, with its shard holding keys ``[off, off + L_loc)``:

    * the new token's row lands on the one rank whose range holds
      ``lengths[b]`` (nothing is written where ``lengths[b] >= L``, as on
      one device);
    * ``attend(queries, caches, valid_len)`` runs the decode kernel over
      the local keys with ``valid_len = lengths + 1 - off`` (0 where the
      shard holds no attended key: weight 0, never NaN) and returns its
      output and log-sum-exp;
    * the kernels' own split-and-combine finishes across ranks: an
      all-reduce MAX of the log-sum-exp, then one SUM of the rescaled
      outputs and their weights. The cache is never gathered.

    Caches replicated whole (a mesh of one rank) take the step's ``index``
    and run exactly the single-device write and call.
    """
    mesh, ref = caches[0].device_mesh, caches[0]
    seq_dims = dtm.shard_dim_axes_of(ref.placements, 1)
    row_pl = dtm.batch_only(ref)
    l_total = ref.shape[1]
    n_q, n_new = len(queries), len(new_rows)
    split = dtm.shard_count(mesh, seq_dims) > 1
    whole = index is not None and all(p.is_replicate() for p in ref.placements)
    if whole:
        def local(*args):
            qs, news = args[:n_q], args[n_q:n_q + n_new]
            bufs, (rows, pos, keep, vl) = args[n_q + n_new:-4], args[-4:]
            ix = DecodeIndex(None, None, vl, rows, pos, keep)
            for buf, new in zip(bufs, news):
                _write_token(buf, new[:, None], ix)
            return attend([t.contiguous() for t in qs], bufs, vl)[0]

        rep = dtm.replicate(row_pl)
        fn = dtm.site(name, local, out_placements=(rep,),
                      in_placements=(rep,) * (n_q + n_new + len(caches) + 4), mesh=mesh)
        return fn(*queries, *new_rows, *caches, index.rows, index.pos, index.keep,
                  index.valid_len)

    def local(*args):
        qs, news = args[:n_q], args[n_q:n_q + n_new]
        bufs, ln = args[n_q + n_new:-1], args[-1].long()
        n_loc = bufs[0].shape[1]
        off = dtm.shard_index(mesh, seq_dims) * n_loc
        pos = ln - off
        write = (pos >= 0) & (pos < n_loc) & (ln < l_total)
        rows = torch.arange(ln.shape[0], device=ln.device)
        at = pos.clamp(0, n_loc - 1)
        for buf, new in zip(bufs, news):
            keep = write.view((-1,) + (1,) * (new.dim() - 1))
            buf[rows, at] = torch.where(keep, new.to(buf.dtype), buf[rows, at])
        vl = (ln + 1 - off).clamp(min=0)
        if window > 0:      # the window starts past this shard: no key here
            vl = torch.where(vl - window < n_loc, vl, torch.zeros_like(vl))
        out, lse = attend([t.contiguous() for t in qs], bufs, vl.to(torch.int32))
        if not split:
            return out
        m = dtm.all_reduce(lse, "max", mesh, seq_dims)
        w = torch.exp(lse - m)[..., None]                       # 0 where lse = -inf
        part = torch.cat([out.float() * w, w], dim=-1)
        tot = dtm.all_reduce(part, "sum", mesh, seq_dims)
        return (tot[..., :-1] / tot[..., -1:]).to(out.dtype)

    fn = dtm.site(name, local, out_placements=(row_pl,),
                  in_placements=(row_pl,) * (n_q + n_new)
                  + tuple(c.placements for c in caches) + (row_pl,),
                  mesh=mesh)
    return fn(*queries, *new_rows, *caches, lengths)


def self_attention_decode_paged(
    params: Dict,
    x: torch.Tensor,                 # (B, 1, d)
    cache: Dict,                     # {"k": (P, bs, KV, hd), "v": ...} pages
    block_tables: torch.Tensor,      # (B, nb) int32
    lengths: torch.Tensor,           # (B,)
    active: torch.Tensor,            # (B,) bool
    cfg,
    *,
    is_global: bool,
    plain: bool = False,
    index: Optional[DecodeIndex] = None,
) -> Tuple[torch.Tensor, Dict]:
    """Decode over the PAGED cache: write the new token through the block
    table, then hand the pages and the table to the paged kernel, which
    reads exactly the pages the table names (no gather to a contiguous
    view first)."""
    if index is None:
        index = decode_index(lengths, cfg, rope_dim=cfg.head_dim, block_tables=block_tables,
                             active=active, block_size=cache["k"].shape[1])
    q, k_new, v_new = _decode_qkv(params, x, index)
    _write_token(cache["k"], k_new, index)
    _write_token(cache["v"], v_new, index)
    fn = paged_decode_attention_ref if plain else paged_decode_attention
    ctx = fn(q[:, 0].contiguous(), cache["k"], cache["v"], block_tables,
             index.valid_len, scale=_attn_scale(cfg), **_kernel_options(cfg, is_global))
    return _out_project(ctx[:, None].to(x.dtype), params["wo"]), cache


# ----------------------------------------------------------------- cross-attn
def init_cross_attention(generator, cfg, dtype, device, lead=()) -> Dict:
    """Cross-attention to encoder states already projected to d_model (the
    frontend stub): the attention projections plus a zero-initialised gate
    (llama-3.2's), so at init the block adds nothing."""
    p = init_attention(generator, cfg, dtype, device, lead)
    p["gate"] = torch.zeros(lead, dtype=dtype, device=device)
    return p


def cross_attention_encode(params: Dict, encoder_states: torch.Tensor) -> Dict:
    """The encoder's k/v (B, n_media, KV, hd), computed once; in the
    promoted dtype of the states and the weights, as jnp's einsum."""
    dtype = torch.promote_types(encoder_states.dtype, params["wk"].dtype)
    enc = encoder_states.to(dtype)
    return {"k": _project(enc, params["wk"].to(dtype)),
            "v": _project(enc, params["wv"].to(dtype))}


def cross_attention_apply(params: Dict, x: torch.Tensor, enc_cache: Dict, cfg) -> torch.Tensor:
    """Every query attends to every encoder position (no mask), scores fp32
    with the logit softcap, the probabilities rounded to v's dtype before
    P.V; the output scaled by ``tanh(gate)``."""
    q = _project(x, params["wq"])
    k, v = enc_cache["k"].to(x.dtype), enc_cache["v"].to(x.dtype)
    if dtm.is_dtensor(q):
        ctx = _per_head_shard("attention.cross", lambda *t: _cross_core(*t, cfg), q, k, v)
    else:
        ctx = _cross_core(q, k, v, cfg)
    gate = torch.tanh(params["gate"].float()).to(x.dtype)
    return _out_project(ctx.to(x.dtype), params["wo"]) * gate


def _cross_core(q, k, v, cfg):
    b, s, h, hd = q.shape
    n_kv = k.shape[2]
    qg = q.reshape(b, s, n_kv, h // n_kv, hd)
    sc = torch.einsum("bskgd,blkd->bkgsl", qg.float(), k.float()) * _attn_scale(cfg)
    p = torch.softmax(softcap_logits(sc, cfg.attn_softcap), dim=-1)
    ctx = torch.einsum("bkgsl,blkd->bskgd", p.to(v.dtype), v)
    return ctx.reshape(b, s, h, v.shape[-1])
