"""Pareto frontier analysis: clock locking vs power capping (paper Fig 3).

Points live in (throughput tok/s, efficiency tok/J) space — up-and-right is
better. ``lock_dominates_caps`` is the paper's headline test: for every cap
operating point there must exist a lock point with at least the cap's
throughput (within tolerance) and strictly better efficiency.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

from repro_torch.core.dvfs import ClockLock, PowerCap, OperatingPoint, resolve
from repro_torch.core.energy import EnergyModel
from repro_torch.core.workload import Workload


@dataclasses.dataclass(frozen=True)
class ParetoPoint:
    lever: str
    configured: float
    throughput: float
    tokens_per_joule: float
    power_w: float
    clock_mhz: float
    engaged: bool

    @classmethod
    def from_op(cls, op: OperatingPoint) -> "ParetoPoint":
        return cls(
            lever=op.lever,
            configured=op.configured,
            throughput=op.throughput,
            tokens_per_joule=op.tokens_per_joule,
            power_w=op.power_w,
            clock_mhz=op.actual_clock_mhz,
            engaged=op.engaged,
        )


def sweep_levers(model: EnergyModel, w: Workload) -> Tuple[List[ParetoPoint], List[ParetoPoint]]:
    """-> (lock points, cap points) over the spec's configured levels."""
    locks = [
        ParetoPoint.from_op(resolve(model, w, ClockLock(c)))
        for c in model.spec.clock_levels
    ]
    caps = [
        ParetoPoint.from_op(resolve(model, w, PowerCap(c)))
        for c in model.spec.power_cap_levels
    ]
    return locks, caps


def frontier(points: Sequence[ParetoPoint]) -> List[ParetoPoint]:
    """Non-dominated subset (maximise throughput and tok/J)."""
    out = []
    for p in points:
        dominated = any(
            (q.throughput >= p.throughput and q.tokens_per_joule >= p.tokens_per_joule)
            and (q.throughput > p.throughput or q.tokens_per_joule > p.tokens_per_joule)
            for q in points
        )
        if not dominated:
            out.append(p)
    return sorted(out, key=lambda p: p.throughput)


def lock_dominates_caps(
    locks: Sequence[ParetoPoint],
    caps: Sequence[ParetoPoint],
    *,
    tput_tolerance: float = 0.01,
) -> bool:
    """True iff every cap point is (weakly) dominated by some lock point."""
    for c in caps:
        if not any(
            l.throughput >= (1.0 - tput_tolerance) * c.throughput
            and l.tokens_per_joule >= c.tokens_per_joule
            for l in locks
        ):
            return False
    return True


def cap_degeneracy(caps: Sequence[ParetoPoint]) -> float:
    """Relative spread of cap-point throughput — the paper's 'degenerate
    blob' (all caps produce nearly identical operating points)."""
    ts = [c.throughput for c in caps]
    return (max(ts) - min(ts)) / max(ts) if ts else 0.0
