from repro_torch.kernels.gdn.gdn import gdn_scan
from repro_torch.kernels.gdn.ops import gdn_prefill
from repro_torch.kernels.gdn.ref import gdn_chunked_ref, gdn_scan_ref

__all__ = ["gdn_scan", "gdn_prefill", "gdn_scan_ref", "gdn_chunked_ref"]
