"""Energy metering — the paper's §3.1 measurement methodology as code.

* ``PowerSampler`` — polls a power source at a fixed cadence (50 ms, NVML
  style) on a daemon thread; ``EnergyMeter`` integrates the trace with the
  trapezoidal rule.
* Short-operation fallback: operations below ``short_op_threshold_s``
  (100 ms) use snapshot-power x wall-clock instead (the paper's ~44 % of
  prefill configs).
* ``CounterCrossValidator`` — emulates the NVML energy counter (millijoule
  granularity) and reports the relative disagreement; the paper accepts the
  trapezoid when they agree within 2 % for ops >= 200 ms.

The power source is a callable () -> watts: in production the platform's
telemetry, here the energy model or a synthetic trace (tests feed known
waveforms and assert integration error bounds).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class TrafficCounter:
    """Byte-accurate HBM traffic ledger for a paged cache.

    The serving pool increments it once per decode step with the number of
    cache blocks (and bytes) actually touched — reads stream whole blocks
    (a partially-filled tail block still moves ``block_bytes`` over the
    bus), writes append one token's worth of cache plus any recurrent-state
    rewrite. The energy layer converts ``total_bytes`` into joules via
    :func:`repro.core.energy.joules_from_hbm_traffic`, replacing the
    shape-based estimate with measured traffic.
    """

    read_bytes: int = 0
    write_bytes: int = 0
    block_reads: int = 0
    block_writes: int = 0
    steps: int = 0

    def count_reads(self, blocks: int, bytes_: int):
        self.block_reads += int(blocks)
        self.read_bytes += int(bytes_)

    def count_writes(self, blocks: int, bytes_: int):
        self.block_writes += int(blocks)
        self.write_bytes += int(bytes_)

    def count_step(self):
        self.steps += 1

    @property
    def total_bytes(self) -> int:
        return self.read_bytes + self.write_bytes

    def snapshot(self) -> "TrafficCounter":
        return dataclasses.replace(self)


@dataclasses.dataclass
class PowerTrace:
    times_s: List[float]
    watts: List[float]

    def integrate_trapezoid(self) -> float:
        # snapshot to a common length: a live sampler thread may be between
        # its two appends when a reader integrates the trace
        n = min(len(self.times_s), len(self.watts))
        if n < 2:
            return 0.0
        return float(np.trapezoid(self.watts[:n], self.times_s[:n]))


class GaugeSource:
    """Mutable power source: a controller writes watts as the operating
    point moves; a sampler thread reads it. This is how each serving pool's
    sampler sees "the energy model evaluated at the pool's current operating
    point" without the sampler knowing anything about levers or workloads.
    """

    def __init__(self, watts: float = 0.0):
        self._watts = float(watts)
        self._lock = threading.Lock()

    def set(self, watts: float):
        with self._lock:
            self._watts = float(watts)

    def __call__(self) -> float:
        with self._lock:
            return self._watts


class PowerSampler:
    """Polls a power source over time. Two drive modes:

    * **threaded** (default) — a daemon thread samples every ``interval_s``
      of wall time, NVML style. The seed behaviour.
    * **synchronous** (``synchronous=True``) — no thread; the caller invokes
      :meth:`advance` at every explicit clock movement or source change.
      This is the virtual-time path: with samples taken exactly at the
      breakpoints of a piecewise-constant power signal, the trapezoid over
      the trace is an *exact* integral, and replays are deterministic
      because no wall-clock jitter enters the trace.
    """

    def __init__(
        self,
        source: Callable[[], float],
        *,
        interval_s: float = 0.050,
        clock: Callable[[], float] = time.monotonic,
        synchronous: bool = False,
    ):
        self.source = source
        self.interval_s = interval_s
        self.clock = clock
        self.synchronous = synchronous
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.trace = PowerTrace([], [])

    def sample_once(self):
        self.trace.times_s.append(self.clock())
        self.trace.watts.append(float(self.source()))

    def advance(self):
        """Synchronous sampling hook: record (now, watts). Call after the
        (virtual) clock moved or right around a source change."""
        self.sample_once()

    def start(self):
        self._stop.clear()
        self.trace = PowerTrace([], [])
        self.sample_once()
        if self.synchronous:
            return

        def loop():
            while not self._stop.is_set():
                self.sample_once()
                self._stop.wait(self.interval_s)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self):
        if self.synchronous:
            self.sample_once()
            return
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        self.sample_once()


@dataclasses.dataclass(frozen=True)
class EnergyMeasurement:
    energy_j: float
    duration_s: float
    method: str                 # "trapezoid" | "snapshot"
    n_samples: int

    @property
    def mean_power_w(self) -> float:
        return self.energy_j / self.duration_s if self.duration_s else 0.0


class EnergyMeter:
    """Context-manager measuring one operation's energy."""

    def __init__(
        self,
        source: Callable[[], float],
        *,
        interval_s: float = 0.050,
        short_op_threshold_s: float = 0.100,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.sampler = PowerSampler(source, interval_s=interval_s, clock=clock)
        self.short_op_threshold_s = short_op_threshold_s
        self.clock = clock
        self.result: Optional[EnergyMeasurement] = None

    def __enter__(self):
        self._t0 = self.clock()
        self.sampler.start()
        return self

    def __exit__(self, *exc):
        self.sampler.stop()
        dt = self.clock() - self._t0
        trace = self.sampler.trace
        if dt < self.short_op_threshold_s or len(trace.times_s) < 3:
            # snapshot fallback: product of snapshot power and wall-clock
            snap = trace.watts[-1] if trace.watts else 0.0
            self.result = EnergyMeasurement(snap * dt, dt, "snapshot", len(trace.times_s))
        else:
            self.result = EnergyMeasurement(
                trace.integrate_trapezoid(), dt, "trapezoid", len(trace.times_s)
            )
        return False


def integrate_trace(times_s, watts) -> float:
    return PowerTrace(list(times_s), list(watts)).integrate_trapezoid()


class CounterCrossValidator:
    """Emulated hardware energy counter with quantised (mJ) granularity."""

    def __init__(self, granularity_j: float = 1e-3):
        self.granularity_j = granularity_j
        self._accum = 0.0

    def accumulate(self, power_w: float, dt_s: float):
        self._accum += power_w * dt_s

    def read(self) -> float:
        return np.floor(self._accum / self.granularity_j) * self.granularity_j

    @staticmethod
    def agreement(trapezoid_j: float, counter_j: float) -> float:
        """Relative disagreement; the paper requires <=2% for ops >=200 ms."""
        if max(trapezoid_j, counter_j) <= 0:
            return 0.0
        return abs(trapezoid_j - counter_j) / max(trapezoid_j, counter_j)
