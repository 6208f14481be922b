from repro_torch.kernels.prefill_attn.prefill_attn import HEAD_DIMS, prefill_attention
from repro_torch.kernels.prefill_attn.ref import prefill_attention_ref

__all__ = ["prefill_attention", "prefill_attention_ref", "HEAD_DIMS"]
