"""Hardware specifications and roofline math.

The reference's names (``hw/chips.py`` and ``hw/roofline.py``, copied
verbatim) plus ``H100_SXM`` (``hw/h100.py``), the card the port runs on.
``get_chip`` knows all three.
"""
from repro_torch.hw.chips import (
    HardwareSpec,
    TPU_V5E,
    H200_SXM,
)
from repro_torch.hw.chips import get_chip as _reference_get_chip
from repro_torch.hw.h100 import H100_SXM
from repro_torch.hw.roofline import (
    RooflineTerms,
    roofline_terms,
    ridge_point,
    arithmetic_intensity,
    bound_class,
)


def get_chip(name: str) -> HardwareSpec:
    """The spec named ``name``: ``h100-sxm``, or any chip of ``hw.chips``."""
    if name == H100_SXM.name:
        return H100_SXM
    try:
        return _reference_get_chip(name)
    except KeyError:
        have = sorted({H100_SXM.name, H200_SXM.name, TPU_V5E.name})
        raise KeyError(f"unknown chip {name!r}; have {have}") from None


__all__ = [
    "HardwareSpec",
    "TPU_V5E",
    "H200_SXM",
    "H100_SXM",
    "get_chip",
    "RooflineTerms",
    "roofline_terms",
    "ridge_point",
    "arithmetic_intensity",
    "bound_class",
]
