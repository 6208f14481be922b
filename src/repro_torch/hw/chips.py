"""Chip specifications for the energy/DVFS model.

Two first-class specs:

* ``TPU_V5E`` — the target platform. Peak numbers follow the task contract
  (197 TFLOP/s bf16, 819 GB/s HBM, ~50 GB/s/link ICI). TPU board power is not
  published; the power-model coefficients are explicit, documented assumptions
  (board max ~220 W, idle floor fraction matched to the paper's H200 ratio).
* ``H200_SXM`` — the paper's platform (989 TFLOP/s bf16 dense, 4.8 TB/s HBM3e,
  700 W TDP, 75 W idle floor, five SM clock levels 390–1980 MHz, five cap
  levels 280–700 W, firmware lock clamp at 1830 MHz). Used to validate the
  simulator against the paper's published behaviour before any TPU claim is
  made.

The power model (see ``repro.core.energy``)::

    P(f) = P_idle + u_c * P_comp_max * g(f) + u_m * P_mem_dyn + u_i * P_ici_dyn
    g(f) = alpha * fr + (1 - alpha) * fr**3,   fr = f / f_max

``g`` interpolates between the linear (frequency-only) and cubic (CV^2 f with
voltage scaling) dynamic-power regimes; ``g(f_max) = 1`` by construction.
HBM frequency is *not* scalable — the paper observes the driver silently
ignores memory-clock requests, and we bake the same semantics in: only the
compute-rate term of the roofline responds to ``f``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """Static description of one accelerator chip + its DVFS surface."""

    name: str
    # --- throughput ceilings (per chip) -----------------------------------
    peak_flops_bf16: float       # MXU / tensor-core dense peak, FLOP/s
    peak_flops_vpu: float        # vector/elementwise peak, FLOP/s
    hbm_bw: float                # bytes/s
    hbm_capacity: float          # bytes
    ici_bw: float                # bytes/s per link (interconnect)
    ici_links: int               # links per chip
    # --- clock surface ------------------------------------------------------
    f_max: float                 # MHz, free-running boost ceiling
    f_base: float                # MHz, sustained/base clock
    clock_levels: Sequence[float]        # MHz, selectable static locks
    firmware_lock_clamp: Optional[float] # MHz; requested locks >= this are
                                         # silently clamped to it (H200
                                         # --lock-gpu-clocks artefact). None
                                         # when the lock is honoured exactly.
    governor_default_clock: float        # MHz the driver holds under load
                                         # when no lock/cap engages
    # --- power surface ------------------------------------------------------
    tdp: float                   # W, board limit
    p_idle: float                # W, idle floor (DVFS cannot touch this)
    p_issue_max: float           # W, SM/issue-machinery dynamic power at
                                 # f_max when cores are active — drawn even
                                 # by memory-bound elementwise kernels (the
                                 # reason GDN saves the MOST from
                                 # underclocking, paper §5.1)
    p_mxu_max: float             # W, additional tensor-pipe power at f_max
                                 # when the MXU/TC is streaming
    p_mem_dyn: float             # W, HBM+controller dynamic power at full bw
    p_ici_dyn: float             # W, interconnect dynamic power at full bw
    dvfs_alpha: float            # linear share of g(f); rest is cubic
    overlap_kappa: float         # fraction of kernel-launch overhead that
                                 # serialises with the roofline time
    mem_issue_beta: float        # SM-activity fraction while memory-waiting
    power_cap_levels: Sequence[float]    # W, configurable caps
    # --- measurement methodology (paper §3.1) ------------------------------
    power_sample_interval_s: float = 0.050   # NVML-style 50 ms sampling
    short_op_threshold_s: float = 0.100      # below this: snapshot fallback
    # --- MXU shape / efficiency model --------------------------------------
    mxu_min_dim: int = 128       # systolic tile edge; GEMM M below this
                                 # underutilises the array
    mxu_sat_m: int = 64          # GEMM M at which efficiency saturates
    gemv_eff: float = 0.05       # fraction of dense peak achieved by
                                 # matrix-vector (decode BS=1) issue
    vpu_eff: float = 0.15        # achieved fraction of vector peak for
                                 # low-ILP elementwise/scan chains
    hbm_eff: float = 0.80        # achieved fraction of peak HBM bandwidth
                                 # for streaming access patterns
    launch_overhead_s: float = 2.0e-6  # per dispatched kernel fixed cost
                                       # (clock-insensitive; drives the MLA
                                       # small-kernel penalty in §6.2)

    # ------------------------------------------------------------------ api
    def g(self, f: float) -> float:
        """Dynamic-power scaling factor for the compute pipe at clock f."""
        fr = max(0.0, min(f, self.f_max)) / self.f_max
        return self.dvfs_alpha * fr + (1.0 - self.dvfs_alpha) * fr ** 3

    def compute_rate(self, f: float) -> float:
        """MXU FLOP/s at clock f (linear in f; HBM unaffected)."""
        return self.peak_flops_bf16 * (f / self.f_max)

    def vpu_rate(self, f: float) -> float:
        return self.peak_flops_vpu * (f / self.f_max)

    def ridge_flops_per_byte(self) -> float:
        return self.peak_flops_bf16 / self.hbm_bw

    def effective_lock(self, requested_mhz: float) -> float:
        """Clock actually delivered by the *lock* mechanism.

        Reproduces the paper's §5.2 observation: ``--lock-gpu-clocks``
        silently clamps any request >= the clamp level to the clamp level,
        while free-running boost (no lock) reaches ``f_max``.
        """
        f = min(requested_mhz, self.f_max)
        if self.firmware_lock_clamp is not None and f >= self.firmware_lock_clamp:
            return self.firmware_lock_clamp
        return f

    def gemm_efficiency(self, m_rows: int) -> float:
        """Fraction of dense MXU peak achieved by a GEMM with M=m_rows.

        Matrix-vector (m=1) issues one row through the systolic array and
        achieves only ``gemv_eff`` of peak; efficiency ramps roughly linearly
        until the array is saturated at ``mxu_sat_m`` rows.
        """
        if m_rows <= 1:
            return self.gemv_eff
        frac = min(1.0, m_rows / float(self.mxu_sat_m))
        return self.gemv_eff + (1.0 - self.gemv_eff) * frac


# --------------------------------------------------------------------------
# H200 SXM — the paper's platform. Constants from §3.1/§5.2 of the paper.
# Power coefficients calibrated against Table 1 + §5.2 watt numbers (see
# tests/test_paper_fidelity.py for the acceptance bands).
# --------------------------------------------------------------------------
H200_SXM = HardwareSpec(
    name="h200-sxm",
    peak_flops_bf16=989e12,
    peak_flops_vpu=67e12,          # CUDA-core fp32 peak
    hbm_bw=4.8e12,
    hbm_capacity=141e9,
    ici_bw=450e9 / 18,             # NVLink4: 900 GB/s bidir = 450 GB/s/dir / 18 links
    ici_links=18,
    f_max=1980.0,
    f_base=1830.0,
    clock_levels=(390.0, 780.0, 1185.0, 1590.0, 1980.0),
    firmware_lock_clamp=1830.0,
    governor_default_clock=1830.0,
    tdp=700.0,
    p_idle=75.0,
    p_issue_max=90.0,
    p_mxu_max=440.0,
    p_mem_dyn=82.0,
    p_ici_dyn=30.0,
    dvfs_alpha=0.40,
    overlap_kappa=0.6,
    mem_issue_beta=0.6,
    power_cap_levels=(280.0, 420.0, 500.0, 600.0, 700.0),
    launch_overhead_s=6.0e-6,    # vLLM CPU-dispatch reality on H200 (§6.2)
)

# --------------------------------------------------------------------------
# TPU v5e — the target. Throughput ceilings per the task contract; power
# surface is an explicit assumption set (documented in DESIGN.md §2): board
# max ~220 W, idle floor ~11% of board max (H200 ratio), no firmware lock
# clamp (clock locks are honoured exactly — a *difference* from the H200
# that our benchmarks surface rather than hide).
# --------------------------------------------------------------------------
TPU_V5E = HardwareSpec(
    name="tpu-v5e",
    peak_flops_bf16=197e12,
    peak_flops_vpu=4.9e12,
    hbm_bw=819e9,
    hbm_capacity=16e9,
    ici_bw=50e9,                   # per task contract: ~50 GB/s/link
    ici_links=4,                   # 2D torus
    f_max=940.0,
    f_base=940.0,
    clock_levels=(235.0, 376.0, 564.0, 752.0, 940.0),
    firmware_lock_clamp=None,
    governor_default_clock=940.0,
    tdp=220.0,
    p_idle=24.0,
    p_issue_max=25.0,
    p_mxu_max=140.0,
    p_mem_dyn=30.0,
    p_ici_dyn=12.0,
    dvfs_alpha=0.40,
    overlap_kappa=0.3,           # XLA's single fused program has little
                                 # dispatch serialisation vs a CUDA kernel zoo
    mem_issue_beta=0.5,
    power_cap_levels=(90.0, 130.0, 160.0, 190.0, 220.0),
)

_CHIPS = {c.name: c for c in (H200_SXM, TPU_V5E)}


def get_chip(name: str) -> HardwareSpec:
    try:
        return _CHIPS[name]
    except KeyError:
        raise KeyError(f"unknown chip {name!r}; have {sorted(_CHIPS)}") from None
