"""minicpm-2b [dense] — llama-like arch; trained with the WSD schedule
(implemented in repro.training.optimizer, exercised by examples/train).

40L d_model=2304 36H (GQA kv=36 = MHA) d_ff=5760 vocab=122753
[arXiv:2404.06395]. MiniCPM's mu-parameterisation scaling factors are a
training-recipe detail and are not modelled (DESIGN.md simplifications).
"""
from repro_torch.models.config import ModelConfig, StageSpec


def config() -> ModelConfig:
    return ModelConfig(
        name="minicpm-2b",
        family="dense",
        d_model=2304,
        vocab_size=122753,
        stages=(StageSpec(unit=("attn",), n_units=40),),
        n_heads=36,
        n_kv_heads=36,
        head_dim=64,
        d_ff=5760,
        mlp_type="swiglu",
        tie_embeddings=True,
        notes="GQA-ctrl analogue in the assigned pool (full MHA kv=36)",
    )
