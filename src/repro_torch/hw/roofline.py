"""Three-term roofline math shared by the energy model and the dry-run report.

Terms (per the task contract, per step, per chip-ensemble):

    compute    = FLOPs            / (chips * peak_flops)
    memory     = HBM bytes        / (chips * hbm_bw)
    collective = collective bytes / (chips * ici_bw)

``roofline_terms`` accepts *totals* (already summed over the ensemble) so the
same function serves both the analytic workload model (single chip,
``chips=1``) and the dry-run artefacts (per-device HLO numbers with
``chips=1``, or global numbers with ``chips=N``).
"""
from __future__ import annotations

import dataclasses

from repro_torch.hw.chips import HardwareSpec


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    """The three roofline times, in seconds, plus bookkeeping."""

    t_compute: float
    t_memory: float
    t_collective: float
    flops: float
    hbm_bytes: float
    collective_bytes: float
    chips: int

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)  # type: ignore[arg-type]

    @property
    def t_bound(self) -> float:
        """Lower bound on step time assuming perfect overlap of the pipes."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def t_serial(self) -> float:
        """Upper bound assuming zero overlap."""
        return self.t_compute + self.t_memory + self.t_collective

    def fraction(self, measured_t: float) -> float:
        """Roofline fraction achieved by a measured/modelled step time."""
        if measured_t <= 0:
            return 0.0
        return self.t_bound / measured_t


def roofline_terms(
    spec: HardwareSpec,
    *,
    flops: float,
    hbm_bytes: float,
    collective_bytes: float = 0.0,
    chips: int = 1,
    clock_mhz: float | None = None,
) -> RooflineTerms:
    f = spec.f_max if clock_mhz is None else clock_mhz
    compute_rate = spec.compute_rate(f) * chips
    return RooflineTerms(
        t_compute=flops / compute_rate if compute_rate else float("inf"),
        t_memory=hbm_bytes / (spec.hbm_bw * chips),
        t_collective=collective_bytes / (spec.ici_bw * chips),
        flops=flops,
        hbm_bytes=hbm_bytes,
        collective_bytes=collective_bytes,
        chips=chips,
    )


def ridge_point(spec: HardwareSpec) -> float:
    """FLOPs/byte above which a kernel is compute-bound on this chip."""
    return spec.ridge_flops_per_byte()


def arithmetic_intensity(flops: float, hbm_bytes: float) -> float:
    return flops / hbm_bytes if hbm_bytes else float("inf")


def bound_class(spec: HardwareSpec, flops: float, hbm_bytes: float) -> str:
    """'memory' or 'compute' — which side of the ridge a kernel sits on."""
    return "compute" if arithmetic_intensity(flops, hbm_bytes) >= ridge_point(spec) else "memory"
