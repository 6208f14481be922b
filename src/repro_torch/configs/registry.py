"""Architecture registry.

``get_config(arch_id)`` returns the exact assigned config;
``reduced_config(arch_id)`` returns a structurally identical but tiny config
of the same family for CPU smoke tests (small layers/width, few experts,
tiny vocab — per the assignment contract, full configs are exercised only
via the dry-run).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

from repro_torch.configs import (
    deepseek_v2_236b,
    deepseek_v2_lite_16b,
    gemma2_9b,
    gemma_2b,
    llama_3_2_vision_11b,
    mamba2_780m,
    minicpm_2b,
    musicgen_large,
    nemotron_4_15b,
    zamba2_1_2b,
)
from repro_torch.configs.paper_models import PAPER_MODELS
from repro_torch.models.config import ModelConfig, StageSpec

ASSIGNED_ARCHS: Tuple[str, ...] = (
    "mamba2-780m",
    "llama-3.2-vision-11b",
    "gemma-2b",
    "gemma2-9b",
    "nemotron-4-15b",
    "minicpm-2b",
    "musicgen-large",
    "deepseek-v2-lite-16b",
    "deepseek-v2-236b",
    "zamba2-1.2b",
)

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {
    "mamba2-780m": mamba2_780m.config,
    "llama-3.2-vision-11b": llama_3_2_vision_11b.config,
    "gemma-2b": gemma_2b.config,
    "gemma2-9b": gemma2_9b.config,
    "nemotron-4-15b": nemotron_4_15b.config,
    "minicpm-2b": minicpm_2b.config,
    "musicgen-large": musicgen_large.config,
    "deepseek-v2-lite-16b": deepseek_v2_lite_16b.config,
    "deepseek-v2-236b": deepseek_v2_236b.config,
    "zamba2-1.2b": zamba2_1_2b.config,
    **PAPER_MODELS,
}


def list_archs(include_paper_models: bool = True):
    if include_paper_models:
        return sorted(_REGISTRY)
    return list(ASSIGNED_ARCHS)


def get_config(arch: str) -> ModelConfig:
    try:
        return _REGISTRY[arch]()
    except KeyError:
        raise KeyError(f"unknown arch {arch!r}; have {sorted(_REGISTRY)}") from None


def _shrink_stage(s: StageSpec, n_units: int) -> StageSpec:
    return StageSpec(unit=s.unit, n_units=min(s.n_units, n_units))


def reduced_config(arch: str) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    cfg = get_config(arch)
    heads = min(cfg.n_heads, 4) if cfg.n_heads else 0
    kv = min(cfg.n_kv_heads, heads) if cfg.n_kv_heads else 0
    if kv and heads % kv:
        kv = 1
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-reduced",
        d_model=64,
        vocab_size=512,
        stages=tuple(_shrink_stage(s, 2) for s in cfg.stages),
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=16 if cfg.head_dim else 0,
        d_ff=96 if cfg.d_ff else 0,
        kv_lora_rank=32 if cfg.kv_lora_rank else 0,
        q_lora_rank=24 if cfg.q_lora_rank else 0,
        qk_nope_head_dim=16 if cfg.qk_nope_head_dim else 0,
        qk_rope_head_dim=8 if cfg.qk_rope_head_dim else 0,
        v_head_dim=16 if cfg.v_head_dim else 0,
        n_routed_experts=8 if cfg.n_routed_experts else 0,
        n_shared_experts=min(cfg.n_shared_experts, 1),
        moe_top_k=min(cfg.moe_top_k, 2),
        moe_d_ff=32 if cfg.moe_d_ff else 0,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_heads=4 if cfg.ssm_heads else 0,
        ssm_head_dim=32 if cfg.ssm_heads else 64,   # d_inner=128 / 4 heads
        ssm_chunk=8,
        gdn_heads=2 if cfg.gdn_heads else 0,
        gdn_head_dim=16 if cfg.gdn_head_dim else 0,
        n_media_tokens=8 if cfg.n_media_tokens else 0,
        sliding_window=8 if cfg.sliding_window else 0,
        param_dtype="float32",
        compute_dtype="float32",
        max_seq_len=128,
    )
