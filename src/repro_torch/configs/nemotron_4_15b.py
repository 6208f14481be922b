"""nemotron-4-15b [dense] — GQA + squared-ReLU MLP.

32L d_model=6144 48H (GQA kv=8) d_ff=24576 vocab=256000 [arXiv:2402.16819].
"""
from repro_torch.models.config import ModelConfig, StageSpec


def config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-15b",
        family="dense",
        d_model=6144,
        vocab_size=256000,
        stages=(StageSpec(unit=("attn",), n_units=32),),
        n_heads=48,
        n_kv_heads=8,
        head_dim=128,
        d_ff=24576,
        mlp_type="squared_relu",
        rope_theta=10000.0,
        tie_embeddings=False,
        notes="paper reference: NVIDIA Nemotron line (§2.1)",
    )
