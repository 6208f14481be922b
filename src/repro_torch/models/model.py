"""Decoder assembly: stages of looped units.

Counterpart of ``repro.models.model`` for configs whose blocks are
``attn`` / ``attn_global`` (GQA) or ``mla`` (absorbed MLA); other block
kinds raise ``NotImplementedError``. The param and cache trees keep the JAX
layout, so the tests compare like with like:

    params = {"embed": {"table"}, "final_norm": {"scale"},
              "stages": [{"b0": {...}, ...}, ...]}   # leaves (n_units, ...)
    cache  = {"stages": [{"b0": {"k", "v"} | {"ckv", "kr"}, ...}, ...]}

The stage ``lax.scan`` becomes a loop over units, indexing the stacked
leaves. Prefill and decode write the caches IN PLACE (the JAX functions
return new ones); they still return the cache so call sites read alike.

    init_params(cfg, generator, device=)             -> params
    params_from_numpy(tree, cfg, device=)            -> params (weight bridge)
    cache_from_numpy(tree, device=)                  -> cache
    init_cache(cfg, batch, max_len, device=)
    init_paged_cache(cfg, batch, n_pages, block_size, device=)
    paged_layout(cfg)
    prefill(params, cfg, tokens, cache, prompt_lengths=)  -> (logits, cache, lengths)
    decode_step(params, cfg, token, cache, lengths)       -> (logits, cache, lengths+1)
    decode_step_paged(params, cfg, token, cache, lengths, active, block_tables)
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mla as mla_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    dt,
    embed,
    init_embedding,
    init_mlp,
    init_rmsnorm,
    mlp,
    rmsnorm,
    unembed,
)

ATTN_KINDS = ("attn", "attn_global")
PORTED_KINDS = ATTN_KINDS + ("mla",)
# Block kinds whose cache grows per token and therefore lives in pages.
PAGED_KINDS = ("attn", "attn_global", "shared_attn", "mla", "mla_moe")


def _check_kinds(cfg: ModelConfig) -> None:
    bad = sorted(set(k for k in cfg.block_kinds_flat() if k not in PORTED_KINDS))
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: block kinds {bad} are not ported yet ({', '.join(PORTED_KINDS)})")
    if cfg.input_is_embeddings:
        raise NotImplementedError(f"{cfg.name}: embedding inputs are not ported yet")


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


# ------------------------------------------------------------------- params
def _init_block(kind: str, cfg: ModelConfig, generator, dtype, device, n: int) -> Dict:
    d = cfg.d_model
    lead = (n,)
    mixer = ({"mla": mla_mod.init_mla(generator, cfg, dtype, device, lead)} if kind == "mla"
             else {"attn": attn.init_attention(generator, cfg, dtype, device, lead)})
    return {
        "norm1": {"scale": torch.zeros(lead + (d,), dtype=dtype, device=device)},
        **mixer,
        "norm2": {"scale": torch.zeros(lead + (d,), dtype=dtype, device=device)},
        "mlp": init_mlp(generator, d, cfg.d_ff, cfg.mlp_type, dtype, device, lead),
    }


def init_params(cfg: ModelConfig, generator: torch.Generator, *,
                device="cuda") -> Dict:
    """Random weights with the JAX init's shapes and scales, per-stage
    stacked on a leading ``n_units`` axis. Values come from ``generator``
    (drawn on its device); they are not the JAX init's values."""
    _check_kinds(cfg)
    device = resolve_device(device)
    dtype = dt(cfg.param_dtype)
    params: Dict[str, Any] = {
        "embed": init_embedding(generator, cfg.vocab_size, cfg.d_model, dtype, device),
        "final_norm": init_rmsnorm(cfg.d_model, dtype, device),
    }
    params["stages"] = [
        {f"b{i}": _init_block(kind, cfg, generator, dtype, device, stage.n_units)
         for i, kind in enumerate(stage.unit)}
        for stage in cfg.stages
    ]
    return params


def params_from_numpy(tree, cfg: ModelConfig, *, device="cuda") -> Dict:
    """The weight bridge: a JAX ``init_params`` tree converted leaf by leaf
    to numpy arrays (same nesting) -> this package's params, same layout."""
    _check_kinds(cfg)
    device = resolve_device(device)
    dtype = dt(cfg.param_dtype)
    return _map(lambda a: torch.from_numpy(np.asarray(a, np.float32).copy())
                .to(device=device, dtype=dtype), tree)


def cache_from_numpy(tree, *, device="cuda") -> Dict:
    """A JAX cache tree as numpy arrays -> torch tensors of the same dtype."""
    device = resolve_device(device)

    def conv(a):
        a = np.asarray(a)
        if a.dtype.kind == "V" or str(a.dtype) == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
        return torch.from_numpy(a.copy()).to(device)

    return _map(conv, tree)


# -------------------------------------------------------------------- cache
def _cache_rows(kind: str, cfg: ModelConfig) -> Dict[str, tuple]:
    """Each cache leaf of a ``kind`` block -> the shape of one token's row."""
    if kind == "mla":
        return {"ckv": (cfg.kv_lora_rank,), "kr": (cfg.qk_rope_head_dim,)}
    return {"k": (cfg.n_kv_heads, cfg.head_dim), "v": (cfg.n_kv_heads, cfg.head_dim)}


def _stacked_cache(cfg: ModelConfig, lead: tuple, device) -> Dict:
    """Zero caches of every block, leaves (n_units,) + ``lead`` + row."""
    cd = dt(cfg.compute_dtype)
    return {"stages": [
        {f"b{i}": {key: torch.zeros((stage.n_units,) + lead + row, dtype=cd, device=device)
                   for key, row in _cache_rows(kind, cfg).items()}
         for i, kind in enumerate(stage.unit)}
        for stage in cfg.stages
    ]}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device="cuda") -> Dict:
    _check_kinds(cfg)
    return _stacked_cache(cfg, (batch, max_len), resolve_device(device))


def init_paged_cache(cfg: ModelConfig, batch: int, n_pages: int, block_size: int,
                     *, device="cuda") -> Dict:
    """Paged decode cache: per-token caches live in ``n_pages`` physical
    pages of ``block_size`` tokens (page 0 reserved as the null page),
    shared by all requests through per-request block tables. Same tree as
    ``init_cache``."""
    _check_kinds(cfg)
    return _stacked_cache(cfg, (n_pages, block_size), resolve_device(device))


def paged_layout(cfg: ModelConfig) -> Dict:
    """Boolean tree matching the cache: True leaves are paged (block-table
    indexed), False leaves slot indexed."""
    return {"stages": [
        {f"b{i}": {key: kind in PAGED_KINDS for key in _cache_rows(kind, cfg)}
         for i, kind in enumerate(stage.unit)}
        for stage in cfg.stages
    ]}


# ------------------------------------------------------------------ forward
def _run_stages(params: Dict, cfg: ModelConfig, x: torch.Tensor, mode: str,
                cache: Dict, lengths: Optional[torch.Tensor],
                block_tables: Optional[torch.Tensor] = None,
                active: Optional[torch.Tensor] = None,
                plain: bool = False) -> torch.Tensor:
    """Run every unit of every stage over ``x``; caches update in place.
    A decode step's rope tables, write positions and ``valid_len`` are the
    same for every layer of one kind and are computed once per kind
    (``attn.decode_index``), from that block's own cache leaves."""
    indexes: Dict[bool, attn.DecodeIndex] = {}

    def step_index(kind: str, bc: Dict) -> attn.DecodeIndex:
        mla = kind == "mla"             # attn and attn_global share one index
        if mla not in indexes:
            rope, leaf = ((cfg.qk_rope_head_dim, bc["ckv"]) if mla
                          else (cfg.head_dim, bc["k"]))   # leaf (B|P, L|bs, ...)
            if block_tables is None:
                indexes[mla] = attn.decode_index(lengths, cfg, rope_dim=rope,
                                                 max_len=leaf.shape[1])
            else:
                indexes[mla] = attn.decode_index(lengths, cfg, rope_dim=rope,
                                                 block_tables=block_tables, active=active,
                                                 block_size=leaf.shape[1])
        return indexes[mla]

    for si, stage in enumerate(cfg.stages):
        sp = params["stages"][si]
        sc = cache["stages"][si]
        for u in range(stage.n_units):
            for i, kind in enumerate(stage.unit):
                bp = _map(lambda a, _u=u: a[_u], sp[f"b{i}"])
                bc = {key: t[u] for key, t in sc[f"b{i}"].items()}
                h = rmsnorm(bp["norm1"], x, cfg.rms_eps)
                if kind == "mla":
                    if mode == "prefill":
                        a_out, _ = mla_mod.mla_prefill(bp["mla"], h, cfg, cache=bc)
                    elif block_tables is not None:
                        a_out, _ = mla_mod.mla_decode_paged(
                            bp["mla"], h, bc, block_tables, lengths, active, cfg,
                            plain=plain, index=step_index(kind, bc))
                    else:
                        a_out, _ = mla_mod.mla_decode(
                            bp["mla"], h, bc, lengths, cfg, plain=plain,
                            index=step_index(kind, bc))
                else:
                    is_global = kind == "attn_global"
                    if mode == "prefill":
                        a_out, _ = attn.self_attention_prefill(
                            bp["attn"], h, cfg, is_global=is_global, cache=bc)
                    elif block_tables is not None:
                        a_out, _ = attn.self_attention_decode_paged(
                            bp["attn"], h, bc, block_tables, lengths, active, cfg,
                            is_global=is_global, plain=plain, index=step_index(kind, bc))
                    else:
                        a_out, _ = attn.self_attention_decode(
                            bp["attn"], h, bc, lengths, cfg, is_global=is_global,
                            plain=plain, index=step_index(kind, bc))
                x = x + a_out
                h = rmsnorm(bp["norm2"], x, cfg.rms_eps)
                x = x + mlp(bp["mlp"], h, cfg.mlp_type)
    return x


def _embed_inputs(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    return embed(params["embed"], tokens, cfg.embed_scale, cfg.d_model,
                 dt(cfg.compute_dtype))


def logits(params: Dict, cfg: ModelConfig, hidden: torch.Tensor) -> torch.Tensor:
    return unembed(params["embed"], hidden, cfg.final_softcap)


def prefill(params: Dict, cfg: ModelConfig, inputs: torch.Tensor, cache: Dict, *,
            prompt_lengths: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict, torch.Tensor]:
    """Process the prompt, fill caches, return last-valid-token logits."""
    b, s = inputs.shape[0], inputs.shape[1]
    if prompt_lengths is None:
        prompt_lengths = torch.full((b,), s, dtype=torch.int32, device=inputs.device)
    x = _embed_inputs(params, cfg, inputs)
    x = _run_stages(params, cfg, x, "prefill", cache, None)
    x = rmsnorm(params["final_norm"], x, cfg.rms_eps)
    last = x[torch.arange(b, device=x.device), prompt_lengths.long() - 1]
    return logits(params, cfg, last[:, None])[:, 0], cache, prompt_lengths


def decode_step(params: Dict, cfg: ModelConfig, token: torch.Tensor, cache: Dict,
                lengths: torch.Tensor, *, plain: bool = False
                ) -> Tuple[torch.Tensor, Dict, torch.Tensor]:
    """One decode step: append token, return (logits (B,V), cache, lengths+1).
    ``plain=True`` attends with the kernels' plain versions."""
    x = _embed_inputs(params, cfg, token[:, None])
    x = _run_stages(params, cfg, x, "decode", cache, lengths, plain=plain)
    x = rmsnorm(params["final_norm"], x, cfg.rms_eps)
    return logits(params, cfg, x)[:, 0], cache, lengths + 1


def decode_step_paged(params: Dict, cfg: ModelConfig, token: torch.Tensor,
                      cache: Dict, lengths: torch.Tensor, active: torch.Tensor,
                      block_tables: torch.Tensor, *, plain: bool = False
                      ) -> Tuple[torch.Tensor, Dict, torch.Tensor]:
    """One decode step over the PAGED cache: per-token caches are written
    and read through the block table. Paging is pure layout, so logits equal
    ``decode_step``'s on the equivalent dense cache."""
    x = _embed_inputs(params, cfg, token[:, None])
    x = _run_stages(params, cfg, x, "decode", cache, lengths,
                    block_tables=block_tables, active=active, plain=plain)
    x = rmsnorm(params["final_norm"], x, cfg.rms_eps)
    return logits(params, cfg, x)[:, 0], cache, lengths + 1
