"""deepseek-v2-236b [moe] — MLA at production scale; 160 routed experts top-6.

60L d_model=5120 128H vocab=102400 [arXiv:2405.04434; hf].
MLA: kv_lora 512, q_lora 1536, rope 64, nope 128, v 128.
First layer dense (ff 12288); 2 shared + 160 routed experts, top-6,
moe_d_ff=1536. 2D-sharded params (FSDP x TP) are required: 472 GB bf16.
"""
from repro_torch.models.config import ModelConfig, StageSpec


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b",
        family="moe",
        d_model=5120,
        vocab_size=102400,
        stages=(
            StageSpec(unit=("mla",), n_units=1),
            StageSpec(unit=("mla_moe",), n_units=59),
        ),
        n_heads=128,
        kv_lora_rank=512,
        q_lora_rank=1536,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
        d_ff=12288,
        mlp_type="swiglu",
        n_routed_experts=160,
        n_shared_experts=2,
        moe_top_k=6,
        moe_d_ff=1536,
        tie_embeddings=False,
        notes="the production decode-pool case for the paper's MLA crossover",
    )
