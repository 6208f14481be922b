from repro_torch.kernels.ssd.ops import ssd_prefill
from repro_torch.kernels.ssd.ref import ssd_scan_ref
from repro_torch.kernels.ssd.ssd import ssd_scan

__all__ = ["ssd_scan", "ssd_prefill", "ssd_scan_ref"]
