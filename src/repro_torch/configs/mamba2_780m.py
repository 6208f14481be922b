"""mamba2-780m [ssm] — SSD (state-space duality), attention-free.

48L d_model=1536, vocab=50280, ssm_state=128 [arXiv:2405.21060].
d_inner = 2*d = 3072, head_dim 64 -> 48 SSM heads, 1 B/C group.
"""
from repro_torch.models.config import ModelConfig, StageSpec


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m",
        family="ssm",
        d_model=1536,
        vocab_size=50280,
        stages=(StageSpec(unit=("ssm",), n_units=48),),
        ssm_state=128,
        ssm_heads=48,
        ssm_head_dim=64,
        ssm_groups=1,
        ssm_expand=2,
        ssm_conv_kernel=4,
        ssm_chunk=256,
        tie_embeddings=True,
        notes="paper paradigm: Mamba2 (batch-sensitive DVFS class); O(1) decode state",
    )
