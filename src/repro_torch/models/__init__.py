"""Model zoo of the port: config schema, layers, attention (GQA with
softcap and sliding window; MLA, absorbed and naive), the routed MoE MLP,
the recurrent blocks (Mamba2 SSD, Gated DeltaNet), cross-attention,
assembly (``attn``, ``attn_global``, ``shared_attn``, ``cross_attn``,
``mla``, ``mla_moe``, ``ssm`` and ``gdn`` stacks, token or embedding
inputs) and the training forward."""
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
    forward,
    init_cache,
    init_paged_cache,
    init_params,
    logits,
    paged_layout,
    params_from_numpy,
    prefill,
    prefill_suffix,
    replica_mesh,
    shard_map_replicas,
)

__all__ = [
    "ModelConfig",
    "StageSpec",
    "kv_cache_bytes_per_token",
    "recurrent_state_bytes",
    "cache_from_numpy",
    "decode_step",
    "decode_step_paged",
    "forward",
    "init_cache",
    "init_paged_cache",
    "init_params",
    "logits",
    "paged_layout",
    "params_from_numpy",
    "prefill",
    "prefill_suffix",
    "replica_mesh",
    "shard_map_replicas",
]
