"""deepseek-v2-lite-16b [moe] — MLA kv_lora=512 + 64 routed experts top-6.

27L d_model=2048 16H d_ff(expert)=1408 vocab=102400 [arXiv:2405.04434; hf].
First layer is dense (ff 10944); 2 shared + 64 routed experts top-6.
MLA: kv_lora 512, rope 64, nope 128, v 128 (576-dim latent cache/token —
the paper's compressed-KV paradigm).
"""
from repro_torch.models.config import ModelConfig, StageSpec


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b",
        family="moe",
        d_model=2048,
        vocab_size=102400,
        stages=(
            StageSpec(unit=("mla",), n_units=1),        # first layer dense
            StageSpec(unit=("mla_moe",), n_units=26),
        ),
        n_heads=16,
        kv_lora_rank=512,
        q_lora_rank=0,                                   # lite: no q compression
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
        d_ff=10944,                                      # dense-layer ffn
        mlp_type="swiglu",
        n_routed_experts=64,
        n_shared_experts=2,
        moe_top_k=6,
        moe_d_ff=1408,
        tie_embeddings=False,
        notes="paper paradigm: MLA (batch-sensitive DVFS class); EP over 'model' axis",
    )
