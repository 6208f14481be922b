"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version.

* decode_attn — flash decode over a dense or a paged KV cache (GQA/MQA);
                the counterpart of ``repro.kernels.decode_attn``.

Sources live in ``csrc/``; ``build.py`` compiles them with ``nvcc`` at first
use. The other Pallas kernels of ``repro.kernels`` (ssd, mla_decode, gdn)
are not ported yet.
"""
from repro_torch.kernels.decode_attn import (
    decode_attention,
    decode_attention_ref,
    paged_decode_attention,
    paged_decode_attention_ref,
)

__all__ = [
    "decode_attention", "decode_attention_ref",
    "paged_decode_attention", "paged_decode_attention_ref",
]
