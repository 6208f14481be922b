"""The H100 SXM energy spec: the card the port runs on.

``hw/chips.py`` is held verbatim to the reference, so the spec lives here.
The throughput ceilings, capacity, interconnect and board limit are NVIDIA's
data-sheet figures for the H100 SXM5 80 GB. Every other field is an
assumption: the H100 SXM and the H200 SXM share the GH100 die and the 700 W
limit, so the clock surface and the compute-side power coefficients are
carried over from ``H200_SXM``. ``p_mem_dyn`` and ``p_idle`` are the H200's
too, and are not calibrated for the H100's HBM3 (the H200 has HBM3e).
``chip_smoke.py`` prints the card's own clock and power surface beside these
fields; none of them is measured.
"""
from __future__ import annotations

from repro_torch.hw.chips import H200_SXM, HardwareSpec

H100_SXM = HardwareSpec(
    name="h100-sxm",
    peak_flops_bf16=989e12,        # data sheet: bf16 tensor core, dense
    peak_flops_vpu=67e12,          # data sheet: fp32 outside the tensor cores
    hbm_bw=3.35e12,                # data sheet: HBM3, 3.35 TB/s
    hbm_capacity=80e9,             # data sheet: 80 GB
    ici_bw=450e9 / 18,             # data sheet: NVLink4, 900 GB/s bidir over 18 links
    ici_links=18,                  # data sheet
    # assumption: the GH100 clock surface of H200_SXM (five locks 390-1980
    # MHz, the firmware lock clamp and the governor's default at 1830 MHz)
    f_max=H200_SXM.f_max,
    f_base=H200_SXM.f_base,
    clock_levels=H200_SXM.clock_levels,
    firmware_lock_clamp=H200_SXM.firmware_lock_clamp,
    governor_default_clock=H200_SXM.governor_default_clock,
    tdp=700.0,                     # data sheet: SXM board limit
    # assumption, not calibrated for HBM3: the H200's idle floor
    p_idle=H200_SXM.p_idle,
    # assumption: the same die's issue and tensor-pipe power
    p_issue_max=H200_SXM.p_issue_max,
    p_mxu_max=H200_SXM.p_mxu_max,
    # assumption, not calibrated for HBM3: the H200's HBM3e dynamic power
    p_mem_dyn=H200_SXM.p_mem_dyn,
    # assumption: the same NVLink4 links
    p_ici_dyn=H200_SXM.p_ici_dyn,
    # assumption: the H200's DVFS shape, overlap and memory-wait activity
    dvfs_alpha=H200_SXM.dvfs_alpha,
    overlap_kappa=H200_SXM.overlap_kappa,
    mem_issue_beta=H200_SXM.mem_issue_beta,
    # assumption: the cap levels the paper sweeps on the H200 (same 700 W board)
    power_cap_levels=H200_SXM.power_cap_levels,
    # assumption: the H200's per-kernel dispatch cost under vLLM (§6.2)
    launch_overhead_s=H200_SXM.launch_overhead_s,
    # the fields left at their defaults (50 ms power sampling, the GEMM /
    # GEMV / vector / HBM efficiency model) are assumptions, as on H200_SXM
)
