"""Model zoo of the port: config schema, layers, attention (GQA and
absorbed MLA), the recurrent blocks (Mamba2 SSD, Gated DeltaNet), assembly
(``attn``, ``mla``, ``ssm`` and ``gdn`` stacks so far)."""
from repro_torch.models.config import (
    ModelConfig,
    StageSpec,
    kv_cache_bytes_per_token,
    recurrent_state_bytes,
)
from repro_torch.models.model import (
    cache_from_numpy,
    decode_step,
    decode_step_paged,
    init_cache,
    init_paged_cache,
    init_params,
    logits,
    paged_layout,
    params_from_numpy,
    prefill,
    prefill_suffix,
)

__all__ = [
    "ModelConfig",
    "StageSpec",
    "kv_cache_bytes_per_token",
    "recurrent_state_bytes",
    "cache_from_numpy",
    "decode_step",
    "decode_step_paged",
    "init_cache",
    "init_paged_cache",
    "init_params",
    "logits",
    "paged_layout",
    "params_from_numpy",
    "prefill",
    "prefill_suffix",
]
