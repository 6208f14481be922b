"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention blocks.

38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000, ssm_state=64
[arXiv:2411.15242]. 38 block slots: 6 units of (5 ssm + 1 shared-attn
application) + 2 ssm tail = 32 SSM blocks + 6 applications of the single
shared transformer block (one param set, per-position KV caches).
"""
from repro_torch.models.config import ModelConfig, StageSpec


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b",
        family="hybrid",
        d_model=2048,
        vocab_size=32000,
        stages=(
            StageSpec(unit=("ssm", "ssm", "ssm", "ssm", "ssm", "shared_attn"), n_units=6),
            StageSpec(unit=("ssm", "ssm"), n_units=1),
        ),
        n_heads=32,
        n_kv_heads=32,
        head_dim=64,
        d_ff=8192,
        mlp_type="swiglu",
        ssm_state=64,
        ssm_heads=64,
        ssm_head_dim=64,
        ssm_groups=1,
        ssm_expand=2,
        ssm_conv_kernel=4,
        ssm_chunk=256,
        tie_embeddings=True,
        notes="hybrid: sub-quadratic global cost; runs long_500k",
    )
