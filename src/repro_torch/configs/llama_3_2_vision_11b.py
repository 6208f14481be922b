"""llama-3.2-vision-11b [vlm] — cross-attn image layers every 5th block.

40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256
[hf:meta-llama/Llama-3.2-11B-Vision]. Vision frontend is a stub:
input_specs() provides precomputed patch embeddings (B, 1600, d_model)
already projected to d_model; the backbone (incl. gated cross-attention)
is fully implemented.
"""
from repro_torch.models.config import ModelConfig, StageSpec


def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-11b",
        family="vlm",
        d_model=4096,
        vocab_size=128256,
        # 8 units of (4 self-attn + 1 cross-attn) = 40 blocks
        stages=(StageSpec(unit=("attn", "attn", "attn", "attn", "cross_attn"), n_units=8),),
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        mlp_type="swiglu",
        rope_theta=500000.0,
        n_media_tokens=1600,
        tie_embeddings=False,
        notes="paper paradigm: GQA + encoder cross-attn; vision tower stubbed",
    )
