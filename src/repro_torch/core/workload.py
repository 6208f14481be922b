"""Analytic per-architecture workload model.

Produces, for one prefill call or one decode step, the resource vector the
energy model consumes::

    Workload(flops_mxu, flops_vpu, hbm_bytes, ici_bytes,
             n_kernels, gemm_m, tokens)

Every term is derived from the ModelConfig the same way the paper's NCU
rooflines attribute kernel classes (§4):

* **flops_mxu** — GEMM-class work (projections, attention score/value
  contractions, fused-recurrent chunk matmuls). Scaled by the chip's
  GEMM-M efficiency curve (matrix-vector decode hits ~5 % of peak).
* **flops_vpu** — elementwise/scan-class work (norms, activations, rope,
  softmax, eager SSM/delta-rule recurrences). The paper's GDN profile
  (65 % elementwise kernels, 1.8 % TC utilisation) lands here.
* **hbm_bytes** — weight streaming + KV/latent/state traffic + activation
  round-trips + (naive-MLA) decompression writes.
* **n_kernels** — dispatch count; x launch overhead gives the
  clock-insensitive floor that §6.2 blames for 90 % of the MLA–GQA gap
  (hundreds of small cat/copy/reshape kernels per step).
* **gemm_m** — effective GEMM rows for the MXU efficiency curve.

``fused=True`` models the paper's §7.2 counterfactual (and our Pallas
kernels): recurrent chunk math moves VPU->MXU and the kernel zoo collapses;
for MLA it removes the decompression/copy overhead (absorbed attention).
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig, kv_cache_bytes_per_token

BYTES = 2  # bf16 weights/activations/caches
STATE_BYTES = 4  # fp32 recurrent state

# kernel-count coefficients (per layer, per step/call) — calibrated against
# the paper's §5.1/§6.2 kernel-zoo observations
K_ATTN_LAYER = 12          # fused-ish transformer layer under CUDA-graphs
K_MLA_EXTRA = 10           # cat/copy/reshape zoo per MLA layer (vLLM path):
                           # ~320 small kernels/step on a 32L model — the
                           # paper's "hundreds of small kernels" (§6.2)
K_SSM_EAGER = 28           # eager Mamba2 decode step per layer
K_GDN_EAGER = 34           # eager GDN decode step per layer (65% elementwise)
K_FUSED = 8                # fused Pallas-style block
K_RECURRENT_PREFILL_PER_CHUNK = 40  # eager chunked prefill launches/chunk
ACT_ROUNDTRIPS = 6         # activation HBM round-trips per block
VPU_OPS_PER_ACT = 20       # norms+activations+residuals per element

# Per-block-kind occupancy profiles (calibrated against the paper's Table 1
# power levels + §5.2 savings ordering):
#   sm_activity — fraction of step time the SM issue machinery is active
#                 (clock-scaled power even when memory-bound, §5.1)
#   copy_frac   — fraction of dispatch-overhead time that keeps the memory
#                 subsystem hot (MLA's cat/copy/reshape zoo ~0.8; launch-gap
#                 eager scans ~0.1)
SM_ACT = {"attn": 0.80, "mla": 0.95, "ssm": 0.70, "gdn": 0.75}
COPY_FRAC = {"attn": 0.30, "mla": 0.80, "ssm": 0.10, "gdn": 0.10}


@dataclasses.dataclass(frozen=True)
class Workload:
    flops_mxu: float
    flops_vpu: float
    hbm_bytes: float
    ici_bytes: float
    n_kernels: float
    gemm_m: int
    tokens: int
    sm_activity: float = 0.8        # SM issue-machinery active fraction
    copy_frac: float = 0.3         # mem-hot share of dispatch overhead

    def scaled(self, chips: int) -> "Workload":
        """Per-chip share under ideal sharding (used for TP/EP what-ifs)."""
        return dataclasses.replace(
            self,
            flops_mxu=self.flops_mxu / chips,
            flops_vpu=self.flops_vpu / chips,
            hbm_bytes=self.hbm_bytes / chips,
            n_kernels=self.n_kernels,  # dispatch floor does not shard
        )


def _gemm_params(cfg: ModelConfig) -> int:
    """Active params touched by GEMMs per token.

    The input-embedding *gather* is excluded (not a GEMM, negligible bytes);
    the LM-head GEMM (vocab x d) is always included — whether its weights are
    tied to the embedding table or not, the matmul happens every step.
    """
    active = cfg.active_param_count()
    emb = cfg.vocab_size * cfg.d_model
    blocks_and_norm = active - emb - (emb if not cfg.tie_embeddings else 0)
    return blocks_and_norm + emb  # + LM head GEMM


def weight_stream_bytes(cfg: ModelConfig) -> int:
    """HBM bytes of weights one decode step streams (once per step, shared
    by the whole batch). Batch-amortised by the paged pool's traffic meter
    when attributing per-request bytes."""
    return int(_gemm_params(cfg) * BYTES)


def _block_kind_counts(cfg: ModelConfig):
    counts: dict[str, int] = {}
    for k in cfg.block_kinds_flat():
        counts[k] = counts.get(k, 0) + 1
    return counts


def _attn_like_layers(cfg: ModelConfig) -> int:
    c = _block_kind_counts(cfg)
    return c.get("attn", 0) + c.get("attn_global", 0) + c.get("shared_attn", 0)


def _occupancy(cfg: ModelConfig, fused: bool):
    """Workload-level (sm_activity, copy_frac): block-count weighted."""
    kind_map = {
        "attn": "attn", "attn_global": "attn", "shared_attn": "attn",
        "cross_attn": "attn", "mla": "mla", "mla_moe": "mla",
        "ssm": "ssm", "gdn": "gdn",
    }
    counts = _block_kind_counts(cfg)
    tot = sum(counts.values())
    sm = sum(SM_ACT[kind_map[k]] * n for k, n in counts.items()) / tot
    cp = sum(COPY_FRAC[kind_map[k]] * n for k, n in counts.items()) / tot
    if fused:
        # fused Pallas paths collapse the kernel zoo; occupancy reverts to
        # the attn-like profile
        sm = min(sm, SM_ACT["attn"])
        cp = min(cp, COPY_FRAC["attn"])
    return sm, cp


def decode_workload(
    cfg: ModelConfig,
    batch: int,
    context: int,
    *,
    fused: bool = False,
    mla_naive_decompress: bool = False,
) -> Workload:
    """One decode step: 1 new token per request, cache length = context."""
    counts = _block_kind_counts(cfg)
    b, l = batch, context
    d = cfg.d_model

    proj = 2.0 * b * _gemm_params(cfg)
    mxu = proj
    vpu = VPU_OPS_PER_ACT * b * d * cfg.n_blocks
    bytes_ = _gemm_params(cfg) * BYTES                               # weights
    bytes_ += ACT_ROUNDTRIPS * b * d * cfg.n_blocks * BYTES          # activations
    kernels = 0.0

    n_attn = _attn_like_layers(cfg)
    if n_attn:
        h, hd, kv = cfg.n_heads, cfg.head_dim, cfg.n_kv_heads
        mxu += 4.0 * b * l * h * hd * n_attn                         # QK + AV
        vpu += 5.0 * b * h * l * n_attn                              # softmax
        bytes_ += b * l * 2 * kv * hd * BYTES * n_attn               # KV read
        bytes_ += b * 2 * kv * hd * BYTES * n_attn                   # KV write
        kernels += K_ATTN_LAYER * n_attn

    n_cross = counts.get("cross_attn", 0)
    if n_cross:
        h, hd, kv = cfg.n_heads, cfg.head_dim, cfg.n_kv_heads
        m = cfg.n_media_tokens
        mxu += 4.0 * b * m * h * hd * n_cross
        bytes_ += b * m * 2 * kv * hd * BYTES * n_cross
        kernels += K_ATTN_LAYER * n_cross

    n_mla = counts.get("mla", 0) + counts.get("mla_moe", 0)
    if n_mla:
        h = cfg.n_heads
        rank, rope = cfg.kv_lora_rank, cfg.qk_rope_head_dim
        nope, vdim = cfg.qk_nope_head_dim, cfg.v_head_dim
        latent = rank + rope
        if mla_naive_decompress:
            # decompress whole cache to full K/V every step (MiniCPM3 trap)
            mxu += 2.0 * b * l * rank * h * (nope + vdim) * n_mla
            mxu += (2.0 * b * l * h * (nope + rope) + 2.0 * b * l * h * vdim) * n_mla
            bytes_ += 2.0 * b * l * h * (nope + vdim) * BYTES * n_mla  # write+read
        else:
            # absorbed path: attention in latent space
            mxu += (2.0 * b * l * h * latent + 2.0 * b * l * h * rank) * n_mla
            mxu += 4.0 * b * h * nope * rank * n_mla                 # absorb einsums
        vpu += 5.0 * b * h * l * n_mla
        bytes_ += b * l * latent * BYTES * n_mla                     # latent read
        bytes_ += b * latent * BYTES * n_mla                         # latent write
        kernels += (K_ATTN_LAYER + (0 if fused else K_MLA_EXTRA)) * n_mla

    n_ssm = counts.get("ssm", 0)
    if n_ssm:
        d_inner = cfg.ssm_expand * d
        hs, p, n = cfg.ssm_heads, (cfg.ssm_expand * d) // cfg.ssm_heads, cfg.ssm_state
        flops = 6.0 * b * hs * p * n * n_ssm                         # state update + out
        if fused:
            mxu += flops
        else:
            vpu += flops
        vpu += 10.0 * b * d_inner * n_ssm                            # conv+gates
        bytes_ += 2.0 * b * hs * p * n * STATE_BYTES * n_ssm         # state r/w
        kernels += (K_FUSED if fused else K_SSM_EAGER) * n_ssm

    n_gdn = counts.get("gdn", 0)
    if n_gdn:
        hg, kg = cfg.gdn_heads, cfg.gdn_head_dim
        flops = 8.0 * b * hg * kg * kg * n_gdn                       # delta rule
        if fused:
            mxu += flops
        else:
            vpu += flops
        bytes_ += 2.0 * b * hg * kg * kg * STATE_BYTES * n_gdn
        kernels += (K_FUSED if fused else K_GDN_EAGER) * n_gdn

    n_moe_layers = counts.get("mla_moe", 0)
    if n_moe_layers:
        kernels += 6 * n_moe_layers                                  # route/dispatch

    return Workload(
        flops_mxu=mxu,
        flops_vpu=vpu,
        hbm_bytes=bytes_,
        ici_bytes=0.0,
        n_kernels=kernels,
        gemm_m=max(1, batch),
        tokens=batch,
        sm_activity=_occupancy(cfg, fused)[0],
        copy_frac=_occupancy(cfg, fused)[1],
    )


def prefill_workload(
    cfg: ModelConfig,
    batch: int,
    seq: int,
    *,
    fused: bool = False,
) -> Workload:
    """One prefill call over (batch, seq) prompt tokens."""
    counts = _block_kind_counts(cfg)
    b, s = batch, seq
    d = cfg.d_model
    t = b * s

    proj = 2.0 * t * _gemm_params(cfg)
    mxu = proj
    vpu = VPU_OPS_PER_ACT * t * d * cfg.n_blocks
    bytes_ = _gemm_params(cfg) * BYTES
    bytes_ += ACT_ROUNDTRIPS * t * d * cfg.n_blocks * BYTES
    kernels = 0.0

    n_attn = _attn_like_layers(cfg)
    if n_attn:
        h, hd, kv = cfg.n_heads, cfg.head_dim, cfg.n_kv_heads
        win = cfg.sliding_window
        counts_local = _block_kind_counts(cfg).get("attn", 0) if win else 0
        # causal: S^2/2; windowed local layers: S*W
        full_layers = n_attn - (counts_local if win else 0)
        mxu += 2.0 * b * s * s * h * hd * full_layers
        if win:
            mxu += 4.0 * b * s * min(win, s) * h * hd * counts_local
        vpu += 2.5 * b * h * s * s * n_attn
        bytes_ += b * s * 2 * kv * hd * BYTES * n_attn               # KV write
        kernels += K_ATTN_LAYER * n_attn

    n_cross = counts.get("cross_attn", 0)
    if n_cross:
        h, hd, kv = cfg.n_heads, cfg.head_dim, cfg.n_kv_heads
        m = cfg.n_media_tokens
        mxu += 4.0 * b * s * m * h * hd * n_cross
        bytes_ += b * m * 2 * kv * hd * BYTES * n_cross
        kernels += K_ATTN_LAYER * n_cross

    n_mla = counts.get("mla", 0) + counts.get("mla_moe", 0)
    if n_mla:
        h = cfg.n_heads
        rank, rope = cfg.kv_lora_rank, cfg.qk_rope_head_dim
        latent = rank + rope
        # absorbed latent attention (MQA-form), causal
        mxu += (b * s * s * h * latent + b * s * s * h * rank) * n_mla
        vpu += 2.5 * b * h * s * s * n_mla
        # non-power-of-2 d_h=192 tile penalty (paper §6.1): 1.6x attention time
        # modelled as extra issue work on the attention contractions
        mxu += 0.6 * (b * s * s * h * latent + b * s * s * h * rank) * n_mla
        bytes_ += b * s * latent * BYTES * n_mla
        kernels += (K_ATTN_LAYER + (0 if fused else K_MLA_EXTRA)) * n_mla

    n_ssm = counts.get("ssm", 0)
    if n_ssm:
        hs, p, n = cfg.ssm_heads, (cfg.ssm_expand * d) // cfg.ssm_heads, cfg.ssm_state
        q = cfg.ssm_chunk
        d_inner = cfg.ssm_expand * d
        # chunked SSD: intra-chunk quadratic + state passing
        flops = (2.0 * t * q * (hs * p + 2 * cfg.ssm_groups * n) + 6.0 * t * hs * p * n / q * q) * n_ssm
        if fused:
            mxu += flops
            kernels += K_FUSED * n_ssm
        else:
            vpu += flops
            kernels += (s / q) * K_RECURRENT_PREFILL_PER_CHUNK * n_ssm
        vpu += 10.0 * t * d_inner * n_ssm
        bytes_ += 2.0 * b * (s / q) * hs * p * n * STATE_BYTES * n_ssm
        kernels += 0

    n_gdn = counts.get("gdn", 0)
    if n_gdn:
        hg, kg = cfg.gdn_heads, cfg.gdn_head_dim
        flops = 8.0 * t * hg * kg * kg * n_gdn
        if fused:
            mxu += flops
            kernels += K_FUSED * n_gdn
        else:
            vpu += flops
            # eager scan: launches scale with sequence
            kernels += (s / 8) * K_RECURRENT_PREFILL_PER_CHUNK * n_gdn
        bytes_ += 2.0 * b * hg * kg * kg * STATE_BYTES * n_gdn

    if counts.get("mla_moe", 0):
        kernels += 6 * counts["mla_moe"]

    return Workload(
        flops_mxu=mxu,
        flops_vpu=vpu,
        hbm_bytes=bytes_,
        ici_bytes=0.0,
        n_kernels=kernels,
        gemm_m=max(1, t),
        tokens=t,
        sm_activity=_occupancy(cfg, fused)[0],
        copy_frac=_occupancy(cfg, fused)[1],
    )


def model_flops_per_token(cfg: ModelConfig) -> float:
    """6*N_active*D convention (D=1): training FLOPs per token / token."""
    return 6.0 * cfg.active_param_count()
