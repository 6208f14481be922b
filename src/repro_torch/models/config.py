"""Model configuration schema.

One ``ModelConfig`` describes any architecture in the pool: dense GQA/MQA
transformers, MLA (compressed-latent) transformers, MoE (shared + routed),
pure SSM (Mamba2/SSD), linear-recurrent (Gated DeltaNet), and hybrids
(Mamba2 + shared attention), plus modality-frontend stubs (vision/audio
backbones that consume precomputed embeddings).

The model is assembled as a list of **stages**; each stage scans a stack of
identical **units**; a unit is a short tuple of block kinds (e.g.
``("attn", "attn_global")`` for gemma2's local/global alternation). This keeps
the lowered HLO proportional to the unit, not the depth — essential for
compiling 60-layer MoE configs against a 512-device mesh.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

# Block kinds understood by repro.models.model
BLOCK_KINDS = (
    "attn",          # self-attention (GQA/MQA) + MLP
    "attn_global",   # self-attention, global (when alternating with local)
    "mla",           # multi-head latent attention + MLP
    "mla_moe",       # MLA + MoE MLP
    "cross_attn",    # cross-attention to encoder states + MLP
    "ssm",           # Mamba2 / SSD block
    "gdn",           # gated-deltanet block
    "shared_attn",   # self-attention with SHARED (non-stacked) params
)


@dataclasses.dataclass(frozen=True)
class StageSpec:
    """A scanned stack of ``n_units`` repetitions of ``unit``."""

    unit: Tuple[str, ...]
    n_units: int

    def __post_init__(self):
        for kind in self.unit:
            if kind not in BLOCK_KINDS:
                raise ValueError(f"unknown block kind {kind!r}")
        if self.n_units < 1:
            raise ValueError("n_units must be >= 1")

    @property
    def n_blocks(self) -> int:
        return len(self.unit) * self.n_units


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    d_model: int
    vocab_size: int
    stages: Tuple[StageSpec, ...]

    # --- attention ----------------------------------------------------------
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    rope_theta: float = 10000.0
    sliding_window: int = 0          # 0 = full attention on local layers
    attn_softcap: float = 0.0        # 0 = disabled (gemma2: 50.0)
    final_softcap: float = 0.0       # gemma2: 30.0
    attn_scale: Optional[float] = None   # override 1/sqrt(head_dim)

    # --- MLA (DeepSeek-V2) ---------------------------------------------------
    kv_lora_rank: int = 0
    q_lora_rank: int = 0             # 0 = no query compression
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # --- MLP ------------------------------------------------------------------
    d_ff: int = 0
    mlp_type: str = "swiglu"         # swiglu | geglu | squared_relu
    # --- MoE -------------------------------------------------------------------
    n_routed_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0                # per-expert ffn dim
    moe_capacity_factor: float = 1.25
    # --- SSM (Mamba2/SSD) -------------------------------------------------------
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_groups: int = 1              # B/C groups (like GQA for SSM)
    ssm_expand: int = 2
    ssm_conv_kernel: int = 4
    ssm_chunk: int = 64              # SSD chunk length
    # --- GDN ----------------------------------------------------------------------
    gdn_heads: int = 0
    gdn_head_dim: int = 0
    # --- embeddings / io -------------------------------------------------------
    input_is_embeddings: bool = False    # audio/vlm frontends are stubs
    tie_embeddings: bool = True
    eos_token_id: int = 0                # serving stops a request on this id
    n_media_tokens: int = 0              # vlm: encoder states per request
    embed_scale: bool = False            # gemma multiplies embeds by sqrt(d)
    # --- norm / numerics --------------------------------------------------------
    rms_eps: float = 1e-6
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # --- misc bookkeeping ---------------------------------------------------------
    max_seq_len: int = 131072
    notes: str = ""

    # ------------------------------------------------------------------ helpers
    @property
    def n_blocks(self) -> int:
        return sum(s.n_blocks for s in self.stages)

    def block_kinds_flat(self) -> Tuple[str, ...]:
        out = []
        for s in self.stages:
            out.extend(list(s.unit) * s.n_units)
        return tuple(out)

    @property
    def uses_attention(self) -> bool:
        kinds = set(self.block_kinds_flat())
        return bool(kinds & {"attn", "attn_global", "shared_attn", "cross_attn"})

    @property
    def uses_full_attention(self) -> bool:
        """True if *any* block attends over the full (unbounded) context."""
        kinds = set(self.block_kinds_flat())
        if kinds & {"mla", "mla_moe", "attn_global", "shared_attn"}:
            return True
        if "attn" in kinds and self.sliding_window == 0:
            return True
        return False

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k decode: SSM / linear-attn / hybrid."""
        kinds = set(self.block_kinds_flat())
        if not kinds & {"ssm", "gdn"}:
            return False
        return True

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head).

        ``shared_attn`` blocks share ONE parameter set across all their
        applications (zamba2 semantics) — counted once here.
        """
        d = self.d_model
        total = self.vocab_size * d  # embedding (tied head included below)
        if not self.tie_embeddings:
            total += self.vocab_size * d
        seen_shared = False
        for kind in self.block_kinds_flat():
            if kind == "shared_attn":
                if seen_shared:
                    continue
                seen_shared = True
            total += self._block_params(kind)
        total += d  # final norm
        return total

    def active_param_count(self) -> int:
        """Params *touched by compute* per token (MoE: shared + top-k routed
        only; shared_attn counted per APPLICATION — FLOPs semantics)."""
        d = self.d_model
        total = self.vocab_size * d
        if not self.tie_embeddings:
            total += self.vocab_size * d
        for kind in self.block_kinds_flat():
            total += self._block_params(kind, active_only=True)
        total += d
        return total

    # ---------------------------------------------------------------- internals
    def _attn_params(self) -> int:
        d = self.d_model
        return (
            d * self.n_heads * self.head_dim        # wq
            + 2 * d * self.n_kv_heads * self.head_dim  # wk, wv
            + self.n_heads * self.head_dim * d      # wo
        )

    def _mla_params(self) -> int:
        d = self.d_model
        qk_dim = self.qk_nope_head_dim + self.qk_rope_head_dim
        if self.q_lora_rank:
            q = d * self.q_lora_rank + self.q_lora_rank * self.n_heads * qk_dim
        else:
            q = d * self.n_heads * qk_dim
        kv = (
            d * self.kv_lora_rank                    # w_dkv
            + self.kv_lora_rank                      # norm_kv
            + d * self.qk_rope_head_dim              # w_kr (shared rope key)
            + self.kv_lora_rank * self.n_heads * self.qk_nope_head_dim  # w_uk
            + self.kv_lora_rank * self.n_heads * self.v_head_dim        # w_uv
        )
        if self.q_lora_rank:
            kv += self.q_lora_rank                   # norm_q
        o = self.n_heads * self.v_head_dim * d
        return q + kv + o

    def _mlp_params(self, ff: int) -> int:
        gated = self.mlp_type in ("swiglu", "geglu")
        return self.d_model * ff * (3 if gated else 2)

    def _moe_params(self, active_only: bool) -> int:
        d = self.d_model
        n_routed = self.moe_top_k if active_only else self.n_routed_experts
        routed = n_routed * self._mlp_params(self.moe_d_ff)
        shared = self.n_shared_experts * self._mlp_params(self.moe_d_ff)
        router = d * self.n_routed_experts
        return routed + shared + router

    def _ssm_params(self) -> int:
        d = self.d_model
        d_inner = self.ssm_expand * d
        heads = self.ssm_heads
        conv_dim = d_inner + 2 * self.ssm_groups * self.ssm_state
        proj_in = d * (2 * d_inner + 2 * self.ssm_groups * self.ssm_state + heads)
        conv = conv_dim * self.ssm_conv_kernel + conv_dim  # conv_w + conv_b
        extras = 3 * heads + d_inner  # A_log, D, dt_bias, norm
        proj_out = d_inner * d
        return proj_in + conv + extras + proj_out

    def _gdn_params(self) -> int:
        d = self.d_model
        h, k = self.gdn_heads, self.gdn_head_dim
        qkv = 3 * d * h * k
        gates = 2 * d * h        # beta, alpha projections
        out_gate = d * h * k
        proj_out = h * k * d
        inner_norm = h * k
        return qkv + gates + out_gate + proj_out + inner_norm

    def _block_params(self, kind: str, active_only: bool = False) -> int:
        d = self.d_model
        norms = 2 * d
        if kind in ("attn", "attn_global", "shared_attn", "cross_attn"):
            return self._attn_params() + self._mlp_params(self.d_ff) + norms
        if kind == "mla":
            return self._mla_params() + self._mlp_params(self.d_ff) + norms
        if kind == "mla_moe":
            return self._mla_params() + self._moe_params(active_only) + norms
        if kind == "ssm":
            return self._ssm_params() + d
        if kind == "gdn":
            return self._gdn_params() + self._mlp_params(self.d_ff) + norms
        raise ValueError(kind)


def kv_cache_bytes_per_token(cfg: ModelConfig, dtype_bytes: int = 2) -> int:
    """HBM bytes appended to the decode cache per generated token."""
    total = 0
    for kind in cfg.block_kinds_flat():
        if kind in ("attn", "attn_global", "shared_attn"):
            total += 2 * cfg.n_kv_heads * cfg.head_dim * dtype_bytes
        elif kind in ("mla", "mla_moe"):
            total += (cfg.kv_lora_rank + cfg.qk_rope_head_dim) * dtype_bytes
        # ssm / gdn / cross_attn: O(1) state, nothing per token
    return total


def recurrent_state_bytes(cfg: ModelConfig, dtype_bytes: int = 2,
                          mutable_only: bool = False) -> int:
    """HBM bytes of O(1)-per-request state one decode step streams (one
    pass). A step reads all of it but rewrites only the mutable part —
    ``mutable_only=True`` excludes the read-only encoder (cross-attn)
    cache, so a traffic meter bills reads and writes separately.

    This is the SSM/GDN/cross-attn counterpart of
    :func:`kv_cache_bytes_per_token` — fp32 recurrent state, bf16 conv and
    encoder caches — so a traffic meter can be byte-accurate for the
    architectures whose decode traffic is state, not KV (the paper's
    compute-light DVFS class)."""
    total = 0
    for kind in cfg.block_kinds_flat():
        if kind == "ssm":
            d_inner = cfg.ssm_expand * cfg.d_model
            p = d_inner // cfg.ssm_heads
            conv_dim = d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
            total += cfg.ssm_heads * p * cfg.ssm_state * 4          # fp32 SSM state
            total += (cfg.ssm_conv_kernel - 1) * conv_dim * dtype_bytes
        elif kind == "gdn":
            total += cfg.gdn_heads * cfg.gdn_head_dim * cfg.gdn_head_dim * 4
        elif kind == "cross_attn" and not mutable_only:
            total += 2 * cfg.n_media_tokens * cfg.n_kv_heads * cfg.head_dim * dtype_bytes
    return total
