from repro_torch.kernels.ssd.ops import ssd_prefill
from repro_torch.kernels.ssd.ref import ssd_scan_bwd_ref, ssd_scan_ref
from repro_torch.kernels.ssd.ssd import SsdScan, ssd_scan
from repro_torch.kernels.ssd.ssd_bwd import ssd_scan_bwd

__all__ = ["ssd_scan", "ssd_scan_bwd", "SsdScan", "ssd_prefill", "ssd_scan_ref",
           "ssd_scan_bwd_ref"]
