"""Virtual time: the pluggable clock behind trace-driven serving.

Everything time-shaped in the serving stack (``Pool``, ``PowerSampler``,
request ledgers) takes a ``clock: Callable[[], float]``. The default is
``time.perf_counter`` — wall-clock serving, exactly the seed behaviour. A
``VirtualClock`` is the drop-in alternative: it returns a simulated
timestamp and only moves when something *advances* it.

Who advances it:

* a ``Pool`` running in virtual mode advances by the *modelled* duration of
  each phase call — ``OperatingPoint.profile.t_total`` at the pool's live
  operating point, so DVFS decisions (a lower lock -> a longer step) feed
  straight back into simulated latency;
* ``Cluster.run_trace`` advances across idle gaps between trace arrivals,
  so idle-floor joules accrue between bursts exactly as a wall-clock meter
  would see them.

Energy integrates over virtual time through ``PowerSampler``'s synchronous
path (``repro.core.metering``): no threads, every sample is taken at an
explicit clock movement or gauge change, and the trapezoid over the
resulting piecewise-constant trace is exact. Replays are therefore
deterministic: same trace + same seed -> byte-identical results.
"""
from __future__ import annotations


class VirtualClock:
    """A monotonic simulated clock. Call it for "now"; ``advance`` moves it.

    Ownership is per-POOL since the event-engine refactor: each fleet
    replica's prefill and decode pools hold independent ``VirtualClock``
    timelines that meet only at migration (``Pool.place``) and routing
    points, so admission prefills overlap concurrent decode
    (``repro.serving.events``). Sharing ONE instance across both pools
    remains valid — it recreates the single global timeline on which a
    cluster tick serialises admission against the decode step (the
    conservative colocated-device model the single-replica ``Cluster``
    facade keeps).
    """

    def __init__(self, start_s: float = 0.0):
        self._now = float(start_s)

    def __call__(self) -> float:
        return self._now

    @property
    def now_s(self) -> float:
        return self._now

    def advance(self, dt_s: float) -> float:
        """Move time forward by ``dt_s`` seconds; returns the new now."""
        if dt_s < 0:
            raise ValueError(f"cannot advance a clock backwards (dt={dt_s})")
        self._now += float(dt_s)
        return self._now

    def advance_to(self, t_s: float) -> float:
        """Move time forward to ``t_s`` (no-op if already past it)."""
        if t_s > self._now:
            self._now = float(t_s)
        return self._now
