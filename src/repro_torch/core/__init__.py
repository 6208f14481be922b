"""The paper's contribution: phase-aware energy characterisation + DVFS policy.

Layers:
  workload    — analytic per-arch FLOPs/bytes/kernel-count vectors per phase
  energy      — roofline-grounded P(f)*T(f) model (EnergyModel, StepProfile)
  dvfs        — ClockLock (+ firmware clamp) and PowerCap (ceiling semantics)
  policy      — DVFS classes + deployable per-arch clock table
  pareto      — lock-vs-cap frontier and dominance tests
  crossover   — total request energy vs output length
  metering    — 50 ms sampling + trapezoidal integration methodology
  clock       — VirtualClock: the pluggable simulated timeline
  latency     — per-request TTFT/TBT event ledger + percentile summaries
  traces      — seeded arrival processes x length profiles for replay
  hypotheses  — the paper's six formalised hypotheses
  characterize— the full sweep driver
"""
from repro_torch.core.workload import Workload, decode_workload, prefill_workload, model_flops_per_token
from repro_torch.core.energy import EnergyModel, StepProfile, joules_from_hbm_traffic
from repro_torch.core.dvfs import ClockLock, Default, PowerCap, OperatingPoint, resolve
from repro_torch.core.policy import (
    ClockChoice,
    PolicyRow,
    best_clock,
    classify_arch,
    min_energy_clock,
    policy_row,
    policy_table,
)
from repro_torch.core.pareto import ParetoPoint, cap_degeneracy, frontier, lock_dominates_caps, sweep_levers
from repro_torch.core.crossover import RequestEnergy, crossover_output_length, energy_curve, request_energy
from repro_torch.core.metering import (
    CounterCrossValidator,
    EnergyMeasurement,
    EnergyMeter,
    GaugeSource,
    PowerSampler,
    PowerTrace,
    TrafficCounter,
    integrate_trace,
)
from repro_torch.core.clock import VirtualClock
from repro_torch.core.latency import (
    LatencyLedger,
    LatencySummary,
    percentile,
    summarize_latency,
)
from repro_torch.core.traces import (
    BUCKETS,
    TracedRequest,
    diurnal_arrivals,
    generate_conversation_trace,
    generate_fanout_trace,
    generate_trace,
    onoff_arrivals,
    poisson_arrivals,
)
from repro_torch.core.hypotheses import HypothesisResult, evaluate_hypotheses
from repro_torch.core.characterize import Record, characterize, filter_records, to_csv

__all__ = [
    "Workload", "decode_workload", "prefill_workload", "model_flops_per_token",
    "EnergyModel", "StepProfile", "joules_from_hbm_traffic",
    "ClockLock", "Default", "PowerCap", "OperatingPoint", "resolve",
    "ClockChoice", "PolicyRow", "best_clock", "classify_arch", "min_energy_clock",
    "policy_row", "policy_table",
    "ParetoPoint", "cap_degeneracy", "frontier", "lock_dominates_caps", "sweep_levers",
    "RequestEnergy", "crossover_output_length", "energy_curve", "request_energy",
    "CounterCrossValidator", "EnergyMeasurement", "EnergyMeter", "GaugeSource",
    "PowerSampler", "PowerTrace", "TrafficCounter", "integrate_trace",
    "VirtualClock",
    "LatencyLedger", "LatencySummary", "percentile", "summarize_latency",
    "BUCKETS", "TracedRequest", "generate_trace",
    "generate_conversation_trace", "generate_fanout_trace",
    "poisson_arrivals", "onoff_arrivals", "diurnal_arrivals",
    "HypothesisResult", "evaluate_hypotheses",
    "Record", "characterize", "filter_records", "to_csv",
]
