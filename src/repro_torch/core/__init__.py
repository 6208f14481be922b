"""Analytic energy core: the copies of ``repro.core`` modules the serving
path imports (workload, energy, dvfs, policy, metering, clock, latency)."""
