from repro_torch.kernels.decode_attn.decode_attn import decode_attention, paged_decode_attention
from repro_torch.kernels.decode_attn.ref import decode_attention_ref, paged_decode_attention_ref

__all__ = [
    "decode_attention", "paged_decode_attention",
    "decode_attention_ref", "paged_decode_attention_ref",
]
