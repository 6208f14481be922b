from repro_torch.kernels.gdn.gdn import GdnScan, gdn_scan
from repro_torch.kernels.gdn.gdn_bwd import gdn_scan_bwd
from repro_torch.kernels.gdn.ops import gdn_prefill
from repro_torch.kernels.gdn.ref import gdn_chunked_ref, gdn_scan_bwd_ref, gdn_scan_ref

__all__ = ["gdn_scan", "gdn_scan_bwd", "GdnScan", "gdn_prefill", "gdn_scan_ref",
           "gdn_scan_bwd_ref", "gdn_chunked_ref"]
