"""Decoder assembly: stages of looped units.

Counterpart of ``repro.models.model`` for configs whose blocks are
``attn`` / ``attn_global`` (GQA, softcap and sliding window included),
``shared_attn`` (zamba2: one unstacked ``params["shared_block"]`` run as
``attn_global`` at every such slot, each slot with its own k/v cache),
``cross_attn`` (llama-3.2-vision: gated attention to encoder states, whose
k/v are encoded at prefill and cached slot-indexed, paged layout or not),
``mla`` (absorbed MLA), ``mla_moe`` (absorbed MLA, then the routed MoE MLP
of ``models/moe.py``), ``ssm`` (Mamba2, ``ssm_groups`` B/C groups) or
``gdn`` (Gated DeltaNet), with token ids or (``cfg.input_is_embeddings``,
musicgen) embedding rows as inputs. The serving pool passes no encoder states and
feeds token ids, as the reference's does, so ``cross_attn`` and embedding
inputs are model-level paths: ``forward`` (training), ``prefill`` and the
decode steps. The param and cache trees keep the JAX layout, so the tests
compare like with like:

    params = {"embed": {"table"}, "final_norm": {"scale"},
              ["shared_block": {"norm1", "attn", "norm2", "mlp"},]  # unstacked
              "stages": [{"b0": {...}, ...}, ...]}   # leaves (n_units, ...)
    cache  = {"stages": [{"b0": {"k", "v"} | {"ckv", "kr"}      # per token
                               | {"ssm", "conv"} | {"gdn"}, ...}, ...]}  # state

Per-token leaves are (n_units, B, L, ...) dense or (n_units, P, bs, ...)
paged; the O(1) state leaves of ``ssm`` and ``gdn`` and the encoder k/v of
``cross_attn`` are (n_units, B, ...) in both layouts (slot indexed).

The stage ``lax.scan`` becomes a loop over units, indexing the stacked
leaves. Prefill and decode write the caches IN PLACE (the JAX functions
return new ones); they still return the cache so call sites read alike.
``forward`` is the training pass: the prefill path with no cache, each
unit under ``torch.utils.checkpoint`` when ``remat`` (as the reference's
``jax.checkpoint(unit_fn)``), returning the final-normed hidden states.

    init_params(cfg, generator, device=)             -> params
    params_from_numpy(tree, cfg, device=)            -> params (weight bridge)
    cache_from_numpy(tree, device=)                  -> cache
    init_cache(cfg, batch, max_len, device=)
    init_paged_cache(cfg, batch, n_pages, block_size, device=)
    paged_layout(cfg)
    forward(params, cfg, inputs, enc_states=, remat=)     -> hidden (B, S, d)
    prefill(params, cfg, inputs, cache, prompt_lengths=, enc_states=, plain=)
                                                          -> (logits, cache, lengths)
    prefill_suffix(params, cfg, tokens, cache, prefix_len=, suffix_lengths=)
    decode_step(params, cfg, token, cache, lengths)       -> (logits, cache, lengths+1)
    decode_step_paged(params, cfg, token, cache, lengths, active, block_tables)

A decode step's ``token`` is (B,) ids, or (B, 1, d) embedding rows when
``cfg.input_is_embeddings``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import dtensor as dtm
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import gdn as gdn_mod
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
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
MLA_KINDS = ("mla", "mla_moe")
# the kinds whose blocks launch a decode-attention kernel every decode step,
# and those whose blocks launch a prefill scan every prefill
DECODE_KINDS = ATTN_KINDS + ("shared_attn",) + MLA_KINDS
SCAN_KINDS = ("ssm", "gdn")
PORTED_KINDS = DECODE_KINDS + SCAN_KINDS + ("cross_attn",)
# fp32 leaves at every param dtype, as the JAX init makes them
FP32_PARAMS = ("a_log", "d_skip", "dt_bias", "router")


def _check_kinds(cfg: ModelConfig) -> None:
    kinds = set(cfg.block_kinds_flat())
    bad = sorted(kinds - set(PORTED_KINDS))
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: block kinds {bad} are not ported yet (ported: "
            f"{', '.join(PORTED_KINDS)})")


def _map(fn, tree, name: str = ""):
    """``fn(leaf, name)`` over a nested dict/list tree; ``name`` is the
    leaf's dict key (or its parent's, inside a list)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v, name) for v in tree]
    return fn(tree, name)


# ------------------------------------------------------------------- params
def _init_block(kind: str, cfg: ModelConfig, generator, dtype, device, n: int) -> Dict:
    if kind == "shared_attn":         # params live in params["shared_block"]
        return {}
    d = cfg.d_model
    lead = (n,)
    norm1 = {"scale": torch.zeros(lead + (d,), dtype=dtype, device=device)}
    if kind == "ssm":                 # no MLP: the mixer is the whole block
        return {"norm1": norm1, "ssm": ssm_mod.init_ssm(generator, cfg, dtype, device, lead)}
    if kind in MLA_KINDS:
        mixer = {"mla": mla_mod.init_mla(generator, cfg, dtype, device, lead)}
    elif kind == "gdn":
        mixer = {"gdn": gdn_mod.init_gdn(generator, cfg, dtype, device, lead)}
    elif kind == "cross_attn":
        mixer = {"xattn": attn.init_cross_attention(generator, cfg, dtype, device, lead)}
    else:
        mixer = {"attn": attn.init_attention(generator, cfg, dtype, device, lead)}
    norm2 = {"scale": torch.zeros(lead + (d,), dtype=dtype, device=device)}
    ffn = ({"moe": moe_mod.init_moe(generator, cfg, dtype, device, lead)} if kind == "mla_moe"
           else {"mlp": init_mlp(generator, d, cfg.d_ff, cfg.mlp_type, dtype, device, lead)})
    return {"norm1": norm1, **mixer, "norm2": norm2, **ffn}


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
    if "shared_attn" in cfg.block_kinds_flat():
        d = cfg.d_model
        params["shared_block"] = {
            "norm1": init_rmsnorm(d, dtype, device),
            "attn": attn.init_attention(generator, cfg, dtype, device),
            "norm2": init_rmsnorm(d, dtype, device),
            "mlp": init_mlp(generator, d, cfg.d_ff, cfg.mlp_type, dtype, device),
        }
    params["stages"] = [
        {f"b{i}": _init_block(kind, cfg, generator, dtype, device, stage.n_units)
         for i, kind in enumerate(stage.unit)}
        for stage in cfg.stages
    ]
    return params


def params_from_numpy(tree, cfg: ModelConfig, *, device="cuda") -> Dict:
    """The weight bridge: a JAX ``init_params`` tree converted leaf by leaf
    to numpy arrays (same nesting) -> this package's params, same layout,
    in ``param_dtype`` except the fp32 leaves of ``FP32_PARAMS``."""
    _check_kinds(cfg)
    device = resolve_device(device)
    dtype = dt(cfg.param_dtype)
    return _map(lambda a, name: torch.from_numpy(np.asarray(a, np.float32).copy()).to(
        device=device, dtype=torch.float32 if name in FP32_PARAMS else dtype), tree)


def cache_from_numpy(tree, *, device="cuda") -> Dict:
    """A JAX cache tree as numpy arrays -> torch tensors of the same dtype."""
    device = resolve_device(device)

    def conv(a):
        a = np.asarray(a)
        if a.dtype.kind == "V" or str(a.dtype) == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
        return torch.from_numpy(a.copy()).to(device)

    return _map(lambda a, _: conv(a), tree)


# -------------------------------------------------------------------- cache
def _cache_leaves(kind: str, cfg: ModelConfig) -> Dict[str, Tuple[tuple, bool, torch.dtype]]:
    """Each cache leaf of a ``kind`` block -> (its trailing shape, whether it
    holds one row per token, dtype). Per-token leaves live in pages in a
    paged cache; the O(1) state of ssm / gdn stays slot indexed there too."""
    cd = dt(cfg.compute_dtype)
    if kind == "ssm":
        d_inner, heads, p, n, g, conv_dim = ssm_mod._dims(cfg)
        return {"ssm": ((heads, p, n), False, torch.float32),
                "conv": ((cfg.ssm_conv_kernel - 1, conv_dim), False, cd)}
    if kind == "gdn":
        return {"gdn": ((cfg.gdn_heads, cfg.gdn_head_dim, cfg.gdn_head_dim), False,
                        torch.float32)}
    if kind in MLA_KINDS:
        return {"ckv": ((cfg.kv_lora_rank,), True, cd), "kr": ((cfg.qk_rope_head_dim,), True, cd)}
    if kind == "cross_attn":          # the encoded media tokens, fixed at prefill
        row = (cfg.n_media_tokens, cfg.n_kv_heads, cfg.head_dim)
        return {"k": (row, False, cd), "v": (row, False, cd)}
    if kind in ATTN_KINDS + ("shared_attn",):
        row = (cfg.n_kv_heads, cfg.head_dim)
        return {"k": (row, True, cd), "v": (row, True, cd)}
    raise ValueError(f"no cache layout for block kind {kind!r}")


def _stacked_cache(cfg: ModelConfig, batch: int, token_lead: tuple, device) -> Dict:
    """Zero caches of every block: per-token leaves (n_units,) + ``token_lead``
    + row, state leaves (n_units, batch) + state shape."""
    return {"stages": [
        {f"b{i}": {key: torch.zeros((stage.n_units,) + (token_lead if per_token else (batch,))
                                    + shape, dtype=dtype, device=device)
                   for key, (shape, per_token, dtype) in _cache_leaves(kind, cfg).items()}
         for i, kind in enumerate(stage.unit)}
        for stage in cfg.stages
    ]}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device="cuda") -> Dict:
    _check_kinds(cfg)
    return _stacked_cache(cfg, batch, (batch, max_len), resolve_device(device))


def init_paged_cache(cfg: ModelConfig, batch: int, n_pages: int, block_size: int,
                     *, device="cuda") -> Dict:
    """Paged decode cache: per-token caches live in ``n_pages`` physical
    pages of ``block_size`` tokens (page 0 reserved as the null page),
    shared by all requests through per-request block tables; O(1) state
    stays a dense ``batch``-row array. Same tree as ``init_cache``."""
    _check_kinds(cfg)
    return _stacked_cache(cfg, batch, (n_pages, block_size), resolve_device(device))


def paged_layout(cfg: ModelConfig) -> Dict:
    """Boolean tree matching the cache: True leaves are paged (block-table
    indexed), False leaves slot indexed (recurrent state, encoder k/v)."""
    return {"stages": [
        {f"b{i}": {key: per_token for key, (_, per_token, _) in _cache_leaves(kind, cfg).items()}
         for i, kind in enumerate(stage.unit)}
        for stage in cfg.stages
    ]}


# ------------------------------------------------------------------ forward
def _block(kind: str, bp: Dict, x: torch.Tensor, cfg: ModelConfig, mode: str,
           bc: Optional[Dict], lengths: Optional[torch.Tensor],
           enc_states: Optional[torch.Tensor], block_tables: Optional[torch.Tensor],
           active: Optional[torch.Tensor], plain: bool,
           prefix_len: Optional[torch.Tensor], step_index) -> torch.Tensor:
    """One block over ``x`` in ``mode`` (train | prefill | decode); ``bc`` is
    its cache (None in train), updated in place."""
    if prefix_len is not None and kind not in ATTN_KINDS:
        raise NotImplementedError(
            f"suffix prefill (prefix sharing) supports attention-family "
            f"blocks only, got {kind!r}")
    h = rmsnorm(bp["norm1"], x, cfg.rms_eps)
    if kind == "ssm":             # no MLP
        if mode == "decode":
            s_out, _ = ssm_mod.ssm_decode(bp["ssm"], h, bc, cfg)
        else:
            s_out, _ = ssm_mod.ssm_prefill(bp["ssm"], h, cfg, cache=bc, plain=plain)
        return x + s_out
    if kind == "gdn":             # state slot indexed: dense and paged alike
        if mode == "decode":
            a_out, _ = gdn_mod.gdn_decode(bp["gdn"], h, bc, cfg)
        else:
            a_out, _ = gdn_mod.gdn_prefill(bp["gdn"], h, cfg, cache=bc, plain=plain)
    elif kind == "cross_attn":    # encode in train and prefill; decode reads the cache
        if mode == "decode":
            enc = bc
        else:
            enc = attn.cross_attention_encode(bp["xattn"], enc_states)
            if bc is not None:
                bc["k"].copy_(enc["k"])
                bc["v"].copy_(enc["v"])
        a_out = attn.cross_attention_apply(bp["xattn"], h, enc, cfg)
    elif kind in MLA_KINDS:
        if mode != "decode":
            a_out, _ = mla_mod.mla_prefill(bp["mla"], h, cfg, cache=bc)
        elif block_tables is not None:
            a_out, _ = mla_mod.mla_decode_paged(
                bp["mla"], h, bc, block_tables, lengths, active, cfg,
                plain=plain, index=step_index(kind, bc))
        else:
            a_out, _ = mla_mod.mla_decode(
                bp["mla"], h, bc, lengths, cfg, plain=plain, index=step_index(kind, bc))
    else:
        is_global = kind == "attn_global"
        if mode == "prefill" and prefix_len is not None:
            a_out, _ = attn.self_attention_prefill_suffix(
                bp["attn"], h, bc, prefix_len, cfg, is_global=is_global)
        elif mode != "decode":
            a_out, _ = attn.self_attention_prefill(
                bp["attn"], h, cfg, is_global=is_global, cache=bc, plain=plain)
        elif block_tables is not None:
            a_out, _ = attn.self_attention_decode_paged(
                bp["attn"], h, bc, block_tables, lengths, active, cfg,
                is_global=is_global, plain=plain, index=step_index(kind, bc))
        else:
            a_out, _ = attn.self_attention_decode(
                bp["attn"], h, bc, lengths, cfg, is_global=is_global,
                plain=plain, index=step_index(kind, bc))
    x = dtm.constrain_batch(x + a_out)     # DTensors: the residual stays batch-sharded
    h = rmsnorm(bp["norm2"], x, cfg.rms_eps)
    if kind == "mla_moe":         # the aux loss stays out, as in the reference
        return x + moe_mod.moe_mlp(bp["moe"], h, cfg)
    return x + mlp(bp["mlp"], h, cfg.mlp_type)


def _run_stages(params: Dict, cfg: ModelConfig, x: torch.Tensor, mode: str,
                cache: Optional[Dict], lengths: Optional[torch.Tensor],
                block_tables: Optional[torch.Tensor] = None,
                active: Optional[torch.Tensor] = None,
                plain: bool = False,
                prefix_len: Optional[torch.Tensor] = None,
                enc_states: Optional[torch.Tensor] = None,
                remat: bool = False) -> torch.Tensor:
    """Run every unit of every stage over ``x``; caches update in place
    (``mode`` train runs with no cache, and with ``remat`` each unit under
    ``torch.utils.checkpoint``).
    ``prefix_len`` (suffix prefill) takes the attention blocks through
    ``self_attention_prefill_suffix``; any other kind raises.
    A decode step's rope tables, write positions and ``valid_len`` are the
    same for every layer of one family (GQA or MLA) and are computed once per
    family (``attn.decode_index``), from that block's own cache leaves; a
    local layer's window is the kernel's, so local and global layers share
    one index. ``shared_attn`` slots run ``params["shared_block"]`` (not
    stacked, so not sliced by unit) as ``attn_global``."""
    indexes: Dict[bool, attn.DecodeIndex] = {}
    shared = params.get("shared_block")

    def step_index(kind: str, bc: Dict) -> attn.DecodeIndex:
        mla = kind in MLA_KINDS         # attn and attn_global share one index
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
        # each stacked leaf split into its units once: under autograd the
        # backward of the split is one stack, where indexing each unit out
        # would add a zero-filled full-size gradient per unit
        sp = _map(lambda a, _: a.unbind(0), params["stages"][si])
        sc = cache["stages"][si] if cache is not None else None

        def unit(x, u, _stage=stage, _sp=sp, _sc=sc):
            for i, kind in enumerate(_stage.unit):
                if kind == "shared_attn":
                    bp, kind = shared, "attn_global"
                else:
                    bp = _map(lambda units, _, _u=u: units[_u], _sp[f"b{i}"])
                bc = {key: t[u] for key, t in _sc[f"b{i}"].items()} if _sc is not None else None
                x = _block(kind, bp, x, cfg, mode, bc, lengths, enc_states, block_tables,
                           active, plain, prefix_len, step_index)
            # DTensor activations stay batch-sharded across unit boundaries
            return dtm.constrain_batch(x)

        for u in range(stage.n_units):
            if remat and mode == "train":
                x = checkpoint(unit, x, u, use_reentrant=False)
            else:
                x = unit(x, u)
    return x


def _embed_inputs(params, cfg: ModelConfig, inputs: torch.Tensor) -> torch.Tensor:
    """Token ids (B, S) -> embeddings; embedding inputs (B, S, d) pass
    through in the compute dtype."""
    if cfg.input_is_embeddings:
        return inputs.to(dt(cfg.compute_dtype))
    return embed(params["embed"], inputs, cfg.embed_scale, cfg.d_model,
                 dt(cfg.compute_dtype))


def _step_inputs(params, cfg: ModelConfig, token: torch.Tensor) -> torch.Tensor:
    """A decode step's (B,) ids or (B, 1, d) embedding rows -> (B, 1, d)."""
    return _embed_inputs(params, cfg, token if cfg.input_is_embeddings else token[:, None])


def logits(params: Dict, cfg: ModelConfig, hidden: torch.Tensor) -> torch.Tensor:
    return unembed(params["embed"], hidden, cfg.final_softcap)


def forward(params: Dict, cfg: ModelConfig, inputs: torch.Tensor, *,
            enc_states: Optional[torch.Tensor] = None, remat: bool = True) -> torch.Tensor:
    """Training/eval forward -> final hidden states (B, S, d), never the
    logits (the training loss unembeds in chunks). With ``remat`` each unit
    runs under ``torch.utils.checkpoint``, so the backward recomputes its
    activations. The scan kernels of ``ssm`` and ``gdn`` blocks (kernels 3
    and 6) are differentiable: on the card their backward is a kernel too.
    """
    x = _embed_inputs(params, cfg, inputs)
    x = _run_stages(params, cfg, x, "train", None, None, enc_states=enc_states, remat=remat)
    return rmsnorm(params["final_norm"], x, cfg.rms_eps)


def prefill(params: Dict, cfg: ModelConfig, inputs: torch.Tensor, cache: Dict, *,
            prompt_lengths: Optional[torch.Tensor] = None,
            enc_states: Optional[torch.Tensor] = None, plain: bool = False
            ) -> Tuple[torch.Tensor, Dict, torch.Tensor]:
    """Process the prompt, fill caches, return last-valid-token logits.
    ``enc_states`` (B, n_media, d) feed the ``cross_attn`` blocks.
    ``plain=True`` scans (ssm, gdn) and attends (the self-attention blocks'
    causal core) with the kernels' plain versions. As in
    the reference, a recurrent block runs every position, padding past
    ``prompt_lengths`` included, so its state holds the padding too."""
    b, s = inputs.shape[0], inputs.shape[1]
    if prompt_lengths is None:
        prompt_lengths = dtm.lift(torch.full((b,), s, dtype=torch.int32, device=inputs.device),
                                  inputs)
    x = _embed_inputs(params, cfg, inputs)
    x = _run_stages(params, cfg, x, "prefill", cache, None, plain=plain, enc_states=enc_states)
    x = rmsnorm(params["final_norm"], x, cfg.rms_eps)
    last = x[dtm.arange(b, x), prompt_lengths.long() - 1]
    return logits(params, cfg, last[:, None])[:, 0], cache, prompt_lengths


def prefill_suffix(params: Dict, cfg: ModelConfig, inputs: torch.Tensor, cache: Dict, *,
                   prefix_len: torch.Tensor, suffix_lengths: torch.Tensor
                   ) -> Tuple[torch.Tensor, Dict, torch.Tensor]:
    """Prefill only the un-shared suffix of a prompt (prefix sharing).
    ``cache`` (batch 1) already holds valid K/V for positions
    ``[0, prefix_len)``, gathered from shared pages by the serving pool; the
    suffix ``inputs`` (1, S), bucket-padded, run at positions
    ``prefix_len + i`` and are written into the cache there. Returns the
    last valid suffix token's logits (the first-token logits a full prefill
    of the whole prompt gives), the cache and ``prefix_len +
    suffix_lengths``. Attention-family configs only: other kinds raise."""
    b = inputs.shape[0]
    if b != 1:
        raise ValueError(f"suffix prefill is batch-1 (got batch={b})")
    x = _embed_inputs(params, cfg, inputs)
    x = _run_stages(params, cfg, x, "prefill", cache, None, prefix_len=prefix_len)
    x = rmsnorm(params["final_norm"], x, cfg.rms_eps)
    last = x[0, suffix_lengths.long() - 1]
    return logits(params, cfg, last[:, None])[:, 0], cache, prefix_len + suffix_lengths


def decode_step(params: Dict, cfg: ModelConfig, token: torch.Tensor, cache: Dict,
                lengths: torch.Tensor, *, plain: bool = False
                ) -> Tuple[torch.Tensor, Dict, torch.Tensor]:
    """One decode step: append token, return (logits (B,V), cache, lengths+1).
    ``plain=True`` attends with the kernels' plain versions (the recurrent
    steps of ssm and gdn have no kernel)."""
    x = _step_inputs(params, cfg, token)
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
    x = _step_inputs(params, cfg, token)
    x = _run_stages(params, cfg, x, "decode", cache, lengths,
                    block_tables=block_tables, active=active, plain=plain)
    x = rmsnorm(params["final_norm"], x, cfg.rms_eps)
    return logits(params, cfg, x)[:, 0], cache, lengths + 1


# ---------------------------------------------------------------------------
# Replica batching over ranks. The event engine folds a fused group of K
# replicas into one step of batch p2 x B over a ``CacheBank`` (the port's
# counterpart of the reference's ``vmap_replicas``). ``shard_map_replicas``
# lays that step out over a 1-D ``replica`` mesh of every rank that is up,
# the reference's ``shard_map`` over the host's devices: each rank runs its
# members' rows, and per-replica computations never communicate.


def replica_mesh():
    """A 1-D ``("replica",)`` mesh over the process group that is up:
    ``"cuda"`` under NCCL, else ``"cpu"``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (dist.get_world_size(),),
                            mesh_dim_names=("replica",))


def shard_map_replicas(step_fn, n_args: int, n_broadcast: int = 1, *, out_dims,
                       in_dims=None, mesh=None):
    """``step_fn`` under ``local_map`` over a 1-D replica mesh (``mesh``, or
    ``replica_mesh()``): the first ``n_broadcast`` arguments (the weights)
    ``Replicate``, every leaf of the others ``Shard`` on its replica axis
    (``in_dims``, one per stacked argument, default 0: a bank's cache leaves
    carry their rows on dim 1). Every rank passes the same full arguments
    and cuts its shard locally; ``out_dims`` gives the replica axis of each
    output LEAF (flattened), and each output comes back whole (gathered),
    as the reference's ``shard_map`` returns a global array. The replica
    axis must split evenly (p2 divides the world)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import local_map
    from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

    dims = tuple(in_dims) if in_dims is not None else (0,) * (n_args - n_broadcast)

    def run(*args):
        m = mesh if mesh is not None else replica_mesh()
        placed, in_pl = [], []
        for i, a in enumerate(args):
            leaves, spec = tree_flatten(a)
            if i < n_broadcast:
                pl = (Replicate(),)
                leaves = [DTensor.from_local(t, m, pl, run_check=False) for t in leaves]
            else:
                pl = (Shard(dims[i - n_broadcast]),)
                leaves = [distribute_tensor(t, m, pl, src_data_rank=None) for t in leaves]
            in_pl += [pl] * len(leaves)
            placed.append(tree_unflatten(leaves, spec))
        out = local_map(step_fn, out_placements=tuple((Shard(d),) for d in out_dims),
                        in_placements=tuple(in_pl), device_mesh=m)(*placed)
        return tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor) else t, out)

    return run
