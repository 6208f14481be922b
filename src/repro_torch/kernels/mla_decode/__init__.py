from repro_torch.kernels.mla_decode.mla_decode import mla_latent_decode, mla_paged_latent_decode
from repro_torch.kernels.mla_decode.ops import mla_fused_decode, mla_paged_fused_decode
from repro_torch.kernels.mla_decode.ref import mla_latent_decode_ref, mla_paged_latent_decode_ref

__all__ = [
    "mla_latent_decode", "mla_paged_latent_decode",
    "mla_fused_decode", "mla_paged_fused_decode",
    "mla_latent_decode_ref", "mla_paged_latent_decode_ref",
]
