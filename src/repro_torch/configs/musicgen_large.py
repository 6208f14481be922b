"""musicgen-large [audio] — decoder-only over EnCodec tokens.

48L d_model=2048 32H (kv=32 = MHA) d_ff=8192 vocab=2048 [arXiv:2306.05284].
The EnCodec frontend + codebook-delay interleaving is a stub: input_specs()
provides precomputed frame embeddings (B, S, d_model); the LM head predicts
one 2048-way codebook (DESIGN.md notes the 4-codebook head simplification).
"""
from repro_torch.models.config import ModelConfig, StageSpec


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large",
        family="audio",
        d_model=2048,
        vocab_size=2048,
        stages=(StageSpec(unit=("attn",), n_units=48),),
        n_heads=32,
        n_kv_heads=32,
        head_dim=64,
        d_ff=8192,
        mlp_type="swiglu",
        input_is_embeddings=True,
        tie_embeddings=True,
        notes="audio backbone only; EnCodec tokenizer stubbed per assignment",
    )
