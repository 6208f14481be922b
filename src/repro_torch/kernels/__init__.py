"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version.

* decode_attn — flash decode over a dense or a paged KV cache (GQA/MQA);
                the counterpart of ``repro.kernels.decode_attn``.
* mla_decode  — absorbed-MLA latent decode over a dense or a paged
                compressed cache, and the fused decode attention around it;
                the counterpart of ``repro.kernels.mla_decode``.
* ssd         — the chunked Mamba2 SSD prefill scan, and the padded prefill
                around it; the counterpart of ``repro.kernels.ssd``; and the
                scan's backward kernel (no TPU counterpart: the JAX package
                differentiates its jnp scan), behind ``SsdScan``.
* gdn         — the gated-delta-rule prefill scan, and the padded prefill
                around it; the counterpart of ``repro.kernels.gdn``; and the
                scan's backward kernel, behind ``GdnScan``.
* prefill_attn — causal GQA flash attention for prefill (no TPU
                counterpart: the JAX package computes it in jnp,
                ``repro.models.flash.flash_attention``).

Sources live in ``csrc/``; ``build.py`` compiles them with ``nvcc`` at first
use. Every Pallas kernel of ``repro.kernels`` has its counterpart here.
"""
from repro_torch.kernels.decode_attn import (
    decode_attention,
    decode_attention_ref,
    paged_decode_attention,
    paged_decode_attention_ref,
)
from repro_torch.kernels.gdn import (
    gdn_chunked_ref,
    gdn_prefill,
    gdn_scan,
    gdn_scan_bwd,
    gdn_scan_bwd_ref,
    gdn_scan_ref,
)
from repro_torch.kernels.mla_decode import (
    mla_fused_decode,
    mla_latent_decode,
    mla_latent_decode_ref,
    mla_paged_fused_decode,
    mla_paged_latent_decode,
    mla_paged_latent_decode_ref,
)
from repro_torch.kernels.prefill_attn import prefill_attention, prefill_attention_ref
from repro_torch.kernels.ssd import (
    ssd_prefill,
    ssd_scan,
    ssd_scan_bwd,
    ssd_scan_bwd_ref,
    ssd_scan_ref,
)

# every wrapper that counts its kernel launches in ``<wrapper>.launches``
COUNTED_KERNELS = (decode_attention, paged_decode_attention, mla_latent_decode,
                   mla_paged_latent_decode, ssd_scan, gdn_scan, ssd_scan_bwd, gdn_scan_bwd,
                   prefill_attention)

__all__ = [
    "decode_attention", "decode_attention_ref",
    "paged_decode_attention", "paged_decode_attention_ref",
    "mla_latent_decode", "mla_latent_decode_ref",
    "mla_paged_latent_decode", "mla_paged_latent_decode_ref",
    "mla_fused_decode", "mla_paged_fused_decode",
    "ssd_scan", "ssd_scan_ref", "ssd_prefill", "ssd_scan_bwd", "ssd_scan_bwd_ref",
    "gdn_scan", "gdn_scan_ref", "gdn_prefill", "gdn_chunked_ref", "gdn_scan_bwd",
    "gdn_scan_bwd_ref",
    "prefill_attention", "prefill_attention_ref",
    "COUNTED_KERNELS",
]
