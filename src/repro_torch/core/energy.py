"""Roofline-grounded energy/DVFS model.

Step time at clock f (MHz)::

    T_mxu(f)  = flops_mxu / (peak_mxu * eff(gemm_m) * f/f_max)
    T_vpu(f)  = flops_vpu / (peak_vpu * vpu_eff     * f/f_max)
    T_comp(f) = T_mxu + T_vpu                  # shared issue pipes
    T_mem     = hbm_bytes / bw_hbm             # HBM clock is NOT scalable
    T_coll    = ici_bytes / bw_ici
    T_over    = n_kernels * launch_overhead    # clock-insensitive dispatch
    T(f)      = max(T_comp, T_mem, T_coll) + T_over

Power::

    u_mxu = T_mxu / T                      # tensor-pipe busy fraction
    u_sm  = (T_comp + T_over + beta*T_mem) / T   # issue machinery active —
                                           # including during memory waits
    P(f) = P_idle + g(f) * (P_issue*u_sm + P_mxu*u_mxu)
                  + P_mem_dyn*u_m + P_ici_dyn*u_i

with g(f) = alpha*(f/fmax) + (1-alpha)*(f/fmax)^3 (CV^2 f with V~f).
The split between always-on issue power (clock-scaled even when memory
bound) and tensor-pipe power is what reproduces the paper's ordering:
compute-light GDN saves the most from underclocking, MLA the least.

This is the machinery behind every paper claim we reproduce: a cap is a
*ceiling* on P(f) (inert unless P(f_default) exceeds it), a lock pins f
directly (subject to the firmware clamp), and energy/token = P*T/tokens.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core.workload import Workload
from repro_torch.hw.chips import HardwareSpec


@dataclasses.dataclass(frozen=True)
class StepProfile:
    """One operating point: times (s), power (W), derived metrics."""

    clock_mhz: float
    t_mxu: float
    t_vpu: float
    t_mem: float
    t_coll: float
    t_overhead: float
    t_total: float
    power_w: float
    tokens: int

    @property
    def t_comp(self) -> float:
        return self.t_mxu + self.t_vpu

    @property
    def throughput(self) -> float:          # tokens / s
        return self.tokens / self.t_total

    @property
    def energy_j(self) -> float:
        return self.power_w * self.t_total

    @property
    def energy_per_token_mj(self) -> float:
        return 1e3 * self.energy_j / max(self.tokens, 1)

    @property
    def tokens_per_joule(self) -> float:
        return self.tokens / self.energy_j

    @property
    def dominant(self) -> str:
        parts = {
            "compute": self.t_comp,
            "memory": self.t_mem,
            "collective": self.t_coll,
        }
        return max(parts, key=parts.get)  # type: ignore[arg-type]


def joules_from_hbm_traffic(power_w: float, bytes_moved: float, hbm_bw_eff: float) -> float:
    """Decode energy from MEASURED bytes moved (the paper's core claim made
    operational): decode is HBM-bandwidth-bound, so the time a step spends
    on a request is ``bytes / effective_bandwidth`` and its energy is board
    power times that time. ``hbm_bw_eff`` is the achievable bandwidth
    (``spec.hbm_bw * spec.hbm_eff``). Used by the paged serving pool, where
    ``bytes_moved`` comes from the block-level ``TrafficCounter`` rather
    than a shape-based estimate."""
    if hbm_bw_eff <= 0:
        return 0.0
    return power_w * bytes_moved / hbm_bw_eff


class EnergyModel:
    def __init__(self, spec: HardwareSpec):
        self.spec = spec

    @property
    def hbm_bw_eff(self) -> float:
        """Achievable HBM bandwidth (bytes/s) — the denominator of every
        traffic-derived decode-time/energy attribution."""
        return self.spec.hbm_bw * self.spec.hbm_eff

    # ----------------------------------------------------------- time model
    def times(self, w: Workload, f_mhz: float) -> Tuple[float, float, float, float, float]:
        s = self.spec
        fr = max(f_mhz, 1.0) / s.f_max
        eff = s.gemm_efficiency(w.gemm_m)
        t_mxu = w.flops_mxu / (s.peak_flops_bf16 * eff * fr) if w.flops_mxu else 0.0
        t_vpu = w.flops_vpu / (s.peak_flops_vpu * s.vpu_eff * fr) if w.flops_vpu else 0.0
        t_mem = w.hbm_bytes / (s.hbm_bw * s.hbm_eff)
        t_coll = w.ici_bytes / s.ici_bw if w.ici_bytes else 0.0
        t_over = w.n_kernels * s.launch_overhead_s
        return t_mxu, t_vpu, t_mem, t_coll, t_over

    # --------------------------------------------------------------- profile
    def profile(self, w: Workload, f_mhz: float) -> StepProfile:
        s = self.spec
        t_mxu, t_vpu, t_mem, t_coll, t_over = self.times(w, f_mhz)
        t_bound = max(t_mxu + t_vpu, t_mem, t_coll)
        # launch overhead partially overlaps the roofline pipes (streams)
        t_total = t_bound + s.overlap_kappa * t_over
        fr = max(f_mhz, 1.0) / s.f_max
        # tensor-pipe power tracks ACHIEVED flops (energy/flop ~ constant):
        # GEMV decode barely warms the MXU even when t_mxu is significant
        t_mxu_ideal = w.flops_mxu / (s.peak_flops_bf16 * fr) if w.flops_mxu else 0.0
        u_mxu = min(1.0, t_mxu_ideal / t_total)
        # SM issue machinery activity is a workload property (kernel-class
        # mix): clock-scaled power drawn even when memory-bound (§5.1). The
        # copy zoo keeps the memory subsystem hot during dispatch overhead.
        u_sm = min(1.0, w.sm_activity)
        u_m = min(1.0, (t_mem + w.copy_frac * t_over) / t_total)
        u_i = min(1.0, t_coll / t_total)
        p = (
            s.p_idle
            + s.g(f_mhz) * (s.p_issue_max * u_sm + s.p_mxu_max * u_mxu)
            + s.p_mem_dyn * u_m
            + s.p_ici_dyn * u_i
        )
        return StepProfile(
            clock_mhz=f_mhz,
            t_mxu=t_mxu,
            t_vpu=t_vpu,
            t_mem=t_mem,
            t_coll=t_coll,
            t_overhead=t_over,
            t_total=t_total,
            power_w=p,
            tokens=w.tokens,
        )

    def power(self, w: Workload, f_mhz: float) -> float:
        return self.profile(w, f_mhz).power_w

    # fine DVFS grid the driver can actually select (15 MHz steps, like NVML)
    def clock_grid(self, step_mhz: float = 15.0):
        s = self.spec
        f = min(s.clock_levels)
        out = []
        while f < s.f_max:
            out.append(f)
            f += step_mhz
        out.append(s.f_max)
        return out
