"""gemma-2b [dense] — GeGLU, head_dim=256, MQA (kv=1).

18L d_model=2048 8H (GQA kv=1) d_ff=16384 vocab=256000 [arXiv:2403.08295].
"""
from repro_torch.models.config import ModelConfig, StageSpec


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma-2b",
        family="dense",
        d_model=2048,
        vocab_size=256000,
        stages=(StageSpec(unit=("attn",), n_units=18),),
        n_heads=8,
        n_kv_heads=1,
        head_dim=256,
        d_ff=16384,
        mlp_type="geglu",
        embed_scale=True,
        tie_embeddings=True,
        notes="paper paradigm: extreme GQA (MQA) — batch-invariant DVFS class",
    )
