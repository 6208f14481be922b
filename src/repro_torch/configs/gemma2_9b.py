"""gemma2-9b [dense] — local/global alternating attention + logit softcap.

42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000 [arXiv:2408.00118].
Local layers use a 4096 sliding window; attn softcap 50, final softcap 30.
"""
from repro_torch.models.config import ModelConfig, StageSpec


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-9b",
        family="dense",
        d_model=3584,
        vocab_size=256000,
        # 21 units of (local, global) = 42 blocks
        stages=(StageSpec(unit=("attn", "attn_global"), n_units=21),),
        n_heads=16,
        n_kv_heads=8,
        head_dim=256,
        d_ff=14336,
        mlp_type="geglu",
        sliding_window=4096,
        attn_softcap=50.0,
        final_softcap=30.0,
        embed_scale=True,
        tie_embeddings=True,
        notes="not sub-quadratic overall: global layers attend full context",
    )
