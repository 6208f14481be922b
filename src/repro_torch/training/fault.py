"""Fault tolerance: step watchdog / straggler detection, preemption handling.

These are the host-side pieces a 1000-node deployment needs around the pure
train step:

* ``StepWatchdog`` — monitors heartbeats from the training loop on a daemon
  thread; if a step exceeds ``stall_factor`` x EMA(step time) it fires the
  straggler callback (at scale: report the slow host to the job manager /
  trigger elastic shrink). Pure-python, unit-testable with fake clocks.
* ``PreemptionGuard`` — converts SIGTERM/SIGINT into a checked flag so the
  loop can write a final checkpoint and exit cleanly (TPU maintenance events
  arrive as SIGTERM).
* ``run_with_restarts`` — supervisor that restarts a step-loop from the
  latest checkpoint after transient failures, up to a retry budget.
"""
from __future__ import annotations

import dataclasses
import signal
import threading
import time
from typing import Callable, Optional


class StepWatchdog:
    def __init__(
        self,
        *,
        stall_factor: float = 3.0,
        min_stall_s: float = 10.0,
        on_straggler: Optional[Callable[[float, float], None]] = None,
        clock: Callable[[], float] = time.monotonic,
        poll_interval_s: float = 0.5,
    ):
        self.stall_factor = stall_factor
        self.min_stall_s = min_stall_s
        self.on_straggler = on_straggler or (lambda elapsed, ema: None)
        self.clock = clock
        self.poll_interval_s = poll_interval_s
        self._ema: Optional[float] = None
        self._last_beat: Optional[float] = None
        self._stop = threading.Event()
        self._fired_for_beat: Optional[float] = None
        self._thread: Optional[threading.Thread] = None
        self.straggler_events: list[tuple[float, float]] = []

    # -- called from the training loop ------------------------------------
    def beat(self):
        """Mark the completion of a step."""
        now = self.clock()
        if self._last_beat is not None:
            dt = now - self._last_beat
            self._ema = dt if self._ema is None else 0.9 * self._ema + 0.1 * dt
        self._last_beat = now

    # -- monitoring --------------------------------------------------------
    def check(self) -> bool:
        """One poll; returns True if a straggler event fired. Usable directly
        in tests (with a fake clock) or via the daemon thread."""
        if self._last_beat is None:
            return False
        elapsed = self.clock() - self._last_beat
        threshold = max(
            self.min_stall_s,
            self.stall_factor * self._ema if self._ema is not None else float("inf"),
        )
        if elapsed > threshold and self._fired_for_beat != self._last_beat:
            self._fired_for_beat = self._last_beat
            self.straggler_events.append((elapsed, self._ema or 0.0))
            self.on_straggler(elapsed, self._ema or 0.0)
            return True
        return False

    def start(self):
        def loop():
            while not self._stop.is_set():
                self.check()
                self._stop.wait(self.poll_interval_s)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)


class PreemptionGuard:
    """Latches SIGTERM/SIGINT; the loop polls ``should_stop``."""

    def __init__(self, install: bool = True):
        self._flag = threading.Event()
        self._prev = {}
        if install:
            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    self._prev[sig] = signal.signal(sig, self._handler)
                except ValueError:
                    pass  # non-main thread (tests)

    def _handler(self, signum, frame):
        self._flag.set()

    def trigger(self):  # for tests
        self._flag.set()

    @property
    def should_stop(self) -> bool:
        return self._flag.is_set()

    def restore(self):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)


@dataclasses.dataclass
class RestartReport:
    restarts: int
    completed: bool
    last_error: Optional[str]


def run_with_restarts(
    body: Callable[[int], None],
    *,
    max_restarts: int = 3,
    latest_step_fn: Callable[[], Optional[int]] = lambda: None,
    on_restart: Optional[Callable[[int, BaseException], None]] = None,
) -> RestartReport:
    """Supervise ``body(resume_step)``; restart from the latest checkpoint on
    transient failure. ``body`` must be idempotent from a checkpoint."""
    restarts = 0
    last_err: Optional[str] = None
    while True:
        resume = latest_step_fn() or 0
        try:
            body(resume)
            return RestartReport(restarts, True, last_err)
        except KeyboardInterrupt:
            raise
        except Exception as e:  # noqa: BLE001 — supervisor boundary
            last_err = f"{type(e).__name__}: {e}"
            if restarts >= max_restarts:
                return RestartReport(restarts, False, last_err)
            restarts += 1
            if on_restart:
                on_restart(restarts, e)
