"""The paper's five ≈4B models (§3.3) — used by the fidelity benchmarks.

* qwen3-4b        GQA      (the paper's mainstream-transformer representative)
* minitron-4b     GQA-ctrl (controlled baseline; Minitron-4B weights)
* minitron-4b-mla MLA      (TransMLA conversion of the same base weights:
                            576-dim latent = kv_lora 512 + rope 64; d_h=192 =
                            nope 128 + rope 64 — the paper's non-power-of-2
                            head-dim tile penalty)
* gdn-4b          GDN      (Qwen3.5-style gated-deltanet replacement)
* mamba2-4b       Mamba2   (SSD; mamba2-2.7b public config scaled to ~4B)

The GQA-ctrl <-> MLA pair shares every dimension except the attention
mechanism — the paper's only controlled ablation, reproduced exactly.
"""
from repro_torch.models.config import ModelConfig, StageSpec


def qwen3_4b() -> ModelConfig:
    return ModelConfig(
        name="qwen3-4b",
        family="dense",
        d_model=2560,
        vocab_size=151936,
        stages=(StageSpec(unit=("attn",), n_units=36),),
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=9728,
        mlp_type="swiglu",
        rope_theta=1000000.0,
        tie_embeddings=True,
        notes="paper GQA representative (batch-invariant DVFS class)",
    )


def minitron_4b() -> ModelConfig:
    return ModelConfig(
        name="minitron-4b",
        family="dense",
        d_model=3072,
        vocab_size=256000,
        stages=(StageSpec(unit=("attn",), n_units=32),),
        n_heads=24,
        n_kv_heads=8,
        head_dim=128,
        d_ff=9216,
        mlp_type="squared_relu",
        rope_theta=10000.0,
        tie_embeddings=False,
        notes="GQA-ctrl: controlled baseline for the MLA ablation",
    )


def minitron_4b_mla() -> ModelConfig:
    base = minitron_4b()
    return ModelConfig(
        name="minitron-4b-mla",
        family="dense",
        d_model=base.d_model,
        vocab_size=base.vocab_size,
        stages=(StageSpec(unit=("mla",), n_units=32),),
        n_heads=base.n_heads,
        kv_lora_rank=512,
        q_lora_rank=0,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,            # 512+64 = 576-dim latent (3.6x vs GQA-ctrl)
        v_head_dim=128,
        d_ff=base.d_ff,
        mlp_type=base.mlp_type,
        rope_theta=base.rope_theta,
        tie_embeddings=False,
        notes="TransMLA conversion: same base dims, attention mechanism only",
    )


def gdn_4b() -> ModelConfig:
    return ModelConfig(
        name="gdn-4b",
        family="gdn",
        d_model=2560,
        vocab_size=151936,
        stages=(StageSpec(unit=("gdn",), n_units=36),),
        gdn_heads=20,
        gdn_head_dim=128,
        d_ff=9728,
        mlp_type="swiglu",
        tie_embeddings=True,
        notes="paper GDN representative (compute-light DVFS class)",
    )


def mamba2_4b() -> ModelConfig:
    return ModelConfig(
        name="mamba2-4b",
        family="ssm",
        d_model=2560,
        vocab_size=50280,
        stages=(StageSpec(unit=("ssm",), n_units=64),),
        ssm_state=128,
        ssm_heads=80,
        ssm_head_dim=64,
        ssm_groups=1,
        ssm_expand=2,
        ssm_conv_kernel=4,
        ssm_chunk=256,
        tie_embeddings=True,
        notes="paper Mamba2 representative (batch-sensitive DVFS class)",
    )


PAPER_MODELS = {
    "qwen3-4b": qwen3_4b,
    "minitron-4b": minitron_4b,
    "minitron-4b-mla": minitron_4b_mla,
    "gdn-4b": gdn_4b,
    "mamba2-4b": mamba2_4b,
}

# paradigm labels as the paper uses them
PARADIGM = {
    "qwen3-4b": "GQA",
    "minitron-4b": "GQA-ctrl",
    "minitron-4b-mla": "MLA",
    "gdn-4b": "GDN",
    "mamba2-4b": "Mamba2",
}
