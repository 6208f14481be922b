"""Deployable per-architecture clock policies + DVFS behavioural classes.

The paper's contribution #2: energy control must target the critical-path
lever. This module turns the energy model into the paper's §6.4 artefact —
a policy table an operator can apply with one static clock call per pool:

* optimal clock  — argmin energy/token over the lock grid
* pareto clock   — argmin energy/token s.t. throughput >= (1-budget) x best
* DVFS class     — batch-invariant | batch-sensitive | compute-light
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from repro_torch.core.dvfs import ClockLock, resolve
from repro_torch.core.energy import EnergyModel
from repro_torch.core.workload import Workload, decode_workload, prefill_workload
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ClockChoice:
    clock_mhz: float
    energy_per_token_mj: float
    throughput: float
    loss_vs_best: float          # fractional throughput loss vs best clock


def best_clock(
    model: EnergyModel,
    w: Workload,
    *,
    budget: float = 0.01,
    clocks: Optional[Sequence[float]] = None,
) -> ClockChoice:
    """Lowest-energy lock whose throughput loss stays within ``budget``."""
    clocks = list(clocks or model.spec.clock_levels)
    points = [resolve(model, w, ClockLock(c)) for c in clocks]
    best_tput = max(p.throughput for p in points)
    ok = [p for p in points if p.throughput >= (1.0 - budget) * best_tput]
    pick = min(ok, key=lambda p: p.energy_per_token_mj)
    return ClockChoice(
        clock_mhz=pick.actual_clock_mhz,
        energy_per_token_mj=pick.energy_per_token_mj,
        throughput=pick.throughput,
        loss_vs_best=1.0 - pick.throughput / best_tput,
    )


def min_energy_clock(model: EnergyModel, w: Workload, **kw) -> ClockChoice:
    return best_clock(model, w, budget=1.0, **kw)


# ------------------------------------------------------------- DVFS classes
BATCH_LO, BATCH_HI = 1, 32


def classify_arch(
    model: EnergyModel,
    cfg: ModelConfig,
    *,
    context: int = 1024,
    budget: float = 0.01,
) -> str:
    """The paper's three behavioural classes (§5.1 / §6.4).

    Criteria mirror the paper's NCU-profile definitions:

    * compute-light   — tensor-pipe achieved utilisation stays negligible
      even at BS=32 (<5%, cf. GDN's 1.8% TC) and the compute mix is not
      scan-heavy: it tolerates aggressive underclocking unconditionally.
    * batch-sensitive — the energy-optimal clock rises from BS=1 to BS=32
      (MLA's absorbed-attention GEMMs, Mamba2's SSM scan compute).
    * batch-invariant — neither: memory-bound at every batch size (GQA's
      KV traffic scales with batch just like its compute).
    """
    w32 = decode_workload(cfg, BATCH_HI, context)
    prof32 = model.profile(w32, model.spec.governor_default_clock)
    fr = model.spec.governor_default_clock / model.spec.f_max
    t_mxu_ideal = w32.flops_mxu / (model.spec.peak_flops_bf16 * fr)
    u_mxu = t_mxu_ideal / prof32.t_total
    scan_heavy = w32.flops_vpu / max(w32.flops_mxu, 1.0) > 0.02
    if u_mxu < 0.05 and not scan_heavy:
        return "compute-light"
    lo = best_clock(model, decode_workload(cfg, BATCH_LO, context), budget=budget)
    hi = best_clock(model, w32, budget=budget)
    if hi.clock_mhz > lo.clock_mhz:
        return "batch-sensitive"
    return "batch-invariant"


@dataclasses.dataclass(frozen=True)
class PolicyRow:
    arch: str
    dvfs_class: str
    decode_clock_bs1: float
    decode_clock_bs32: float
    decode_clock_bs32_long: float     # seq >= 16K
    prefill_clock: float
    est_savings_w: float              # vs default governor, decode BS=1

    def clock_for(self, regime: str) -> float:
        """Column lookup for one (pool, regime): the lock to apply."""
        table = {
            "prefill": self.prefill_clock,
            "bs1": self.decode_clock_bs1,
            "bs32": self.decode_clock_bs32,
            "bs32_long": self.decode_clock_bs32_long,
        }
        try:
            return table[regime]
        except KeyError:
            raise KeyError(f"unknown regime {regime!r}; have {sorted(table)}") from None

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


def policy_row(
    model: EnergyModel,
    name: str,
    cfg: ModelConfig,
    *,
    budget: float = 0.01,
    context: int = 1024,
    long_context: int = 16384,
) -> PolicyRow:
    """One architecture's row of the deployable policy table."""
    from repro_torch.core.dvfs import Default  # local to avoid cycle confusion

    d1 = best_clock(model, decode_workload(cfg, 1, context), budget=budget)
    d32 = best_clock(model, decode_workload(cfg, 32, context), budget=budget)
    d32l = best_clock(model, decode_workload(cfg, 32, long_context), budget=budget)
    pf = best_clock(model, prefill_workload(cfg, 1, 4096), budget=budget)
    base = resolve(model, decode_workload(cfg, 1, context), Default())
    lock = resolve(model, decode_workload(cfg, 1, context), ClockLock(d1.clock_mhz))
    return PolicyRow(
        arch=name,
        dvfs_class=classify_arch(model, cfg, context=context, budget=budget),
        decode_clock_bs1=d1.clock_mhz,
        decode_clock_bs32=d32.clock_mhz,
        decode_clock_bs32_long=d32l.clock_mhz,
        prefill_clock=pf.clock_mhz,
        est_savings_w=base.power_w - lock.power_w,
    )


def policy_table(
    model: EnergyModel,
    cfgs: Dict[str, ModelConfig],
    *,
    budget: float = 0.01,
    context: int = 1024,
    long_context: int = 16384,
) -> List[PolicyRow]:
    """The deployable artefact: one static lock per (arch, pool, regime)."""
    return [
        policy_row(model, name, cfg, budget=budget, context=context,
                   long_context=long_context)
        for name, cfg in cfgs.items()
    ]
