"""The two static energy levers, with the exact semantics the paper measures.

* ``ClockLock`` — pins the compute clock. The H200 spec carries the paper's
  §5.2 firmware artefact: any requested lock >= 1830 MHz is silently clamped
  to 1830 (free-running boost is NOT — the "double disguise").
* ``PowerCap`` — board-level ceiling. The driver runs at its default clock
  and only throttles while modelled power exceeds the cap; if the workload
  never reaches the cap the cap is **inert** and the operating point is
  byte-identical to default — the paper's central finding.

``resolve()`` maps (lever, workload) -> OperatingPoint, recording both the
*configured* and the *actual* clock/power so Table 1's configured-vs-actual
gap can be reproduced mechanically.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

from repro_torch.core.energy import EnergyModel, StepProfile
from repro_torch.core.workload import Workload


@dataclasses.dataclass(frozen=True)
class ClockLock:
    requested_mhz: float


@dataclasses.dataclass(frozen=True)
class PowerCap:
    cap_w: float


@dataclasses.dataclass(frozen=True)
class Default:
    """No lever: driver governor at its default under-load clock."""


Lever = Union[ClockLock, PowerCap, Default]


@dataclasses.dataclass(frozen=True)
class OperatingPoint:
    lever: str                    # "lock" | "cap" | "default"
    configured: float             # requested MHz or cap W
    actual_clock_mhz: float
    engaged: bool                 # did the lever change anything?
    profile: StepProfile

    @property
    def power_w(self) -> float:
        return self.profile.power_w

    @property
    def clock_gap_mhz(self) -> float:
        """Configured-vs-actual clock gap for lock levers (Table 1's silent
        clamp); 0 for caps/default where ``configured`` is not in MHz."""
        return self.configured - self.actual_clock_mhz if self.lever == "lock" else 0.0

    @property
    def throughput(self) -> float:
        return self.profile.throughput

    @property
    def tokens_per_joule(self) -> float:
        return self.profile.tokens_per_joule

    @property
    def energy_per_token_mj(self) -> float:
        return self.profile.energy_per_token_mj


def resolve(model: EnergyModel, w: Workload, lever: Lever) -> OperatingPoint:
    spec = model.spec
    f_default = spec.governor_default_clock

    if isinstance(lever, Default):
        prof = model.profile(w, f_default)
        return OperatingPoint("default", f_default, f_default, False, prof)

    if isinstance(lever, ClockLock):
        f_actual = spec.effective_lock(lever.requested_mhz)
        prof = model.profile(w, f_actual)
        return OperatingPoint(
            "lock", lever.requested_mhz, f_actual,
            engaged=True, profile=prof,
        )

    if isinstance(lever, PowerCap):
        # ceiling semantics: throttle only while P(f) > cap
        if model.power(w, f_default) <= lever.cap_w:
            prof = model.profile(w, f_default)
            return OperatingPoint("cap", lever.cap_w, f_default, False, prof)
        # driver walks the DVFS grid down until under the cap
        best: Optional[float] = None
        for f in sorted(model.clock_grid(), reverse=True):
            if f > f_default:
                continue
            if model.power(w, f) <= lever.cap_w:
                best = f
                break
        if best is None:
            best = min(spec.clock_levels)  # floor: cap unsatisfiable
        prof = model.profile(w, best)
        return OperatingPoint("cap", lever.cap_w, best, True, prof)

    raise TypeError(f"unknown lever {lever!r}")
