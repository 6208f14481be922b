"""Hardware specifications (copied from ``repro.hw.chips``)."""
from repro_torch.hw.chips import (
    HardwareSpec,
    TPU_V5E,
    H200_SXM,
    get_chip,
)

__all__ = ["HardwareSpec", "TPU_V5E", "H200_SXM", "get_chip"]
