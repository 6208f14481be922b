"""Fleet autoscaling: queue-aware drain / power-up with warm-up accounting.

The paper's fleet-level consequence: decode parks a 700 W part at
137–300 W, so the joules a fleet can actually shed live in *which replicas
are powered*, not in the power cap. PR 4 made drain/power-down a manual
lever (``Fleet.drain``); this module closes the loop — an ``Autoscaler``
watches the serving signals and decides when to park a replica into a
diurnal valley and when to power one up ahead of a peak. Under the
event engine it is ticked by timer events at its own ``tick_interval_s``
cadence (so hold windows and forecasts see idle valleys AS THEY ELAPSE);
the barrier driver ticks it once per fleet round and sub-steps idle gaps
at the same cadence.

Two policies, both deterministic functions of the fleet's visible state
(so seeded replays stay byte-identical):

* ``queue``    — reactive scaling on the latency ledger's rolling
  queue-delay p95 (admissions in a sliding window plus the live ages of
  still-waiting requests). Breach the target -> power one replica up.
  Hold ``slack`` headroom for a full ``hold_s`` window -> drain one.
  The window restarts on every scale event, so the policy can never flap
  (an up and the next down are always >= ``hold_s`` apart), and a fresh
  power-up must *prove itself* — observations taken under the old capacity
  are discarded, the same evidence-reset rule the SLO clock walk uses.
* ``schedule`` — anticipatory scaling on a Holt (EWMA level + trend)
  arrival-rate forecast. The forecast horizon is ``warmup_s + lead_s``:
  the policy asks "what rate will we see once a replica powered up *now*
  would be warm?", sizes the fleet for it at ``target_utilisation``, and
  powers up early enough that the warm-up window is paid *before* the
  ramp, not during it — the TTFT edge over ``queue`` on diurnal peaks.

Warm-up is a modelled cost, not a free transition: ``Fleet`` holds a
powering-up replica in a ``warming`` state for ``warmup_s`` during which
its pools draw idle-floor watts but the scheduler admits nothing, and the
routers prefer warm replicas while any exists. Every scale decision lands
in the fleet's ``scale_events`` log AND as a ``Transition`` on the
replica's own ``ClockController`` (lever ``power_up``/``drain``/...),
so warm-up joules are attributed in the same audit trail as DVFS moves.

``make_autoscaler`` builds from the ``AUTOSCALERS`` registry — the name an
``AutoscalerSpec.policy`` field carries. Policies are stateful (rolling
windows, forecast state); build a fresh one per fleet.
"""
from __future__ import annotations

import dataclasses
import math
from typing import TYPE_CHECKING, Optional, Protocol, Tuple

from repro_torch.core.latency import percentile
from repro_torch.serving.spec import AutoscalerSpec

if TYPE_CHECKING:                       # only for type hints; no import cycle
    from repro_torch.serving.fleet import Fleet

#: decision verbs a policy may return from ``tick`` (with a reason string)
SCALE_UP = "up"
SCALE_DOWN = "down"

#: actions the fleet records in ``scale_events`` / controller Transitions
#: (``reclaim`` = a scale-up cancelled an in-progress drain: the replica
#: never powered down, so it rejoins warm with NO warm-up window)
SCALE_ACTIONS = ("park", "power_up", "reclaim", "warm", "drain", "power_down")


@dataclasses.dataclass(frozen=True)
class ScaleEvent:
    """One autoscaler-driven state change on one replica (fleet ledger)."""

    t_s: float                  # fleet time of the decision
    action: str                 # one of SCALE_ACTIONS
    replica: str
    policy: str                 # the deciding policy ("queue"/"schedule"/...)
    reason: str                 # human-readable trigger, for the audit trail


class Autoscaler(Protocol):
    """Scaling policy: one decision per fleet round, applied by the fleet."""

    name: str
    warmup_s: float
    min_replicas: int

    def max_replicas(self, fleet: "Fleet") -> int:
        """The policy's replica ceiling for this fleet."""
        ...

    def tick(self, fleet: "Fleet", now_s: float) -> Optional[Tuple[str, str]]:
        """Inspect the fleet at ``now_s``; return ``(SCALE_UP|SCALE_DOWN,
        reason)`` or ``None``. The fleet picks WHICH replica moves."""
        ...


class _PolicyBase:
    """Shared spec plumbing: bounds, evaluation cadence, the hold timer."""

    def __init__(self, spec: AutoscalerSpec):
        self.spec = spec
        self.warmup_s = spec.warmup_s
        self.min_replicas = spec.min_replicas
        self._last_eval_s = -math.inf
        self._slack_since_s: Optional[float] = None

    def max_replicas(self, fleet: "Fleet") -> int:
        return self.spec.max_replicas or len(fleet.replicas)

    def _due(self, now_s: float) -> bool:
        if now_s - self._last_eval_s < self.spec.tick_interval_s:
            return False
        self._last_eval_s = now_s
        return True

    def _held_slack(self, now_s: float) -> bool:
        """True once the slack condition has been continuously met for a
        full ``hold_s`` window; the window restarts after every scale
        event (callers reset via ``_reset_hold``) — the no-flap guarantee:
        consecutive scale events in opposite directions are always at
        least ``hold_s`` apart."""
        if self._slack_since_s is None:
            self._slack_since_s = now_s
            return self.spec.hold_s == 0.0
        return now_s - self._slack_since_s >= self.spec.hold_s

    def _reset_hold(self):
        self._slack_since_s = None


class QueueAutoscaler(_PolicyBase):
    """Reactive: scale on the rolling queue-delay p95 the ledger reports.

    Scale-up is immediate on a breach (SLO first) but gated on "no replica
    is currently warming" — capacity already in flight must land and show
    up in the signal before more is added, which also paces a ramp at one
    warm-up per step. Scale-down needs the p95 to hold ``slack`` headroom
    for an unbroken ``hold_s`` window.
    """

    name = "queue"

    def __init__(self, spec: AutoscalerSpec):
        super().__init__(spec)
        # evidence measured before this instant saw the OLD capacity;
        # reset on every scale-up so a stale breach cannot cascade. The
        # fleet applies it to BOTH populations queue_delay_samples pools:
        # logged admissions are dropped, and live waiting ages re-measure
        # from the reset (a backlog queued before the scale-up must not
        # re-trigger the instant the warm-up window elapses)
        self._ignore_before_s = -math.inf

    def tick(self, fleet: "Fleet", now_s: float) -> Optional[Tuple[str, str]]:
        if not self._due(now_s):
            return None
        s = self.spec
        samples = fleet.queue_delay_samples(
            now_s, s.window_s, since_s=self._ignore_before_s)
        p95 = percentile(samples, 95.0)
        n = fleet.n_active()
        if p95 > s.queue_p95_target_s:
            self._reset_hold()
            if (n < self.max_replicas(fleet) and fleet.has_scale_up_target()
                    and fleet.n_warming() == 0):
                self._ignore_before_s = now_s
                return (SCALE_UP,
                        f"queue p95 {p95:.4f}s > target {s.queue_p95_target_s:.4f}s")
            return None
        if p95 > s.slack * s.queue_p95_target_s:
            # met, but without headroom: neither direction moves
            self._reset_hold()
            return None
        if self._held_slack(now_s) and n > self.min_replicas:
            self._reset_hold()
            return (SCALE_DOWN,
                    f"queue p95 {p95:.4f}s held {s.slack:.2f}x headroom "
                    f"for {s.hold_s:.3f}s")
        return None


class ScheduleAutoscaler(_PolicyBase):
    """Anticipatory: Holt (level + trend) arrival-rate forecast at the
    warm-up horizon sizes the fleet *before* the ramp arrives.

    Every ``sample_interval_s`` the observed arrival rate updates the
    forecast state; the desired replica count is the forecast rate at
    ``now + warmup_s + lead_s`` divided by the modelled per-replica
    capacity ``replica_rps * target_utilisation``. Ups are not gated on
    warming replicas — a steep ramp legitimately powers several up in
    consecutive rounds (the desired-count clamp bounds it); downs carry
    the same ``hold_s`` hysteresis as the queue policy.
    """

    name = "schedule"

    def __init__(self, spec: AutoscalerSpec):
        super().__init__(spec)
        self._level: Optional[float] = None     # rps
        self._trend = 0.0                       # rps per second
        self._last_sample_s: Optional[float] = None
        self._last_arrivals = 0

    def _observe(self, fleet: "Fleet", now_s: float):
        s = self.spec
        if self._last_sample_s is None:
            self._last_sample_s = now_s
            self._last_arrivals = fleet.arrivals_total
            return
        dt = now_s - self._last_sample_s
        if dt < s.sample_interval_s:
            return
        rate = (fleet.arrivals_total - self._last_arrivals) / dt
        if self._level is None:
            self._level = rate
        else:
            prev = self._level
            self._level = (s.ewma_alpha * rate
                           + (1.0 - s.ewma_alpha) * (self._level + self._trend * dt))
            self._trend = (s.trend_beta * (self._level - prev) / dt
                           + (1.0 - s.trend_beta) * self._trend)
        self._last_sample_s = now_s
        self._last_arrivals = fleet.arrivals_total

    def forecast_rps(self) -> float:
        """The rate the forecast expects once a replica powered up now
        would be warm (horizon = warmup + lead); 0 before any sample."""
        if self._level is None:
            return 0.0
        horizon = self.spec.warmup_s + self.spec.lead_s
        return max(0.0, self._level + self._trend * horizon)

    def desired_replicas(self, fleet: "Fleet") -> int:
        per_replica = self.spec.replica_rps * self.spec.target_utilisation
        want = int(math.ceil(self.forecast_rps() / per_replica))
        return max(self.min_replicas, min(self.max_replicas(fleet), want))

    def tick(self, fleet: "Fleet", now_s: float) -> Optional[Tuple[str, str]]:
        self._observe(fleet, now_s)
        if not self._due(now_s) or self._level is None:
            return None
        desired = self.desired_replicas(fleet)
        n = fleet.n_active()
        if desired > n:
            self._reset_hold()
            if fleet.has_scale_up_target():
                return (SCALE_UP,
                        f"forecast {self.forecast_rps():.3f} rps at the "
                        f"warm horizon needs {desired} replicas (have {n})")
            return None
        if desired == n:
            self._reset_hold()
            return None
        if self._held_slack(now_s) and n > self.min_replicas:
            self._reset_hold()
            return (SCALE_DOWN,
                    f"forecast {self.forecast_rps():.3f} rps needs only "
                    f"{desired} replicas (have {n}) for {self.spec.hold_s:.3f}s")
        return None


AUTOSCALERS = {
    QueueAutoscaler.name: QueueAutoscaler,
    ScheduleAutoscaler.name: ScheduleAutoscaler,
}


def make_autoscaler(spec, **kwargs) -> Autoscaler:
    """Build a fresh policy from an ``AutoscalerSpec`` — or, as a test
    convenience, from a policy name plus spec fields."""
    if isinstance(spec, str):
        spec = AutoscalerSpec(policy=spec, **kwargs)
    elif kwargs:
        raise TypeError("pass spec fields only with a policy name")
    try:
        cls = AUTOSCALERS[spec.policy]
    except KeyError:
        raise ValueError(
            f"unknown autoscaler policy {spec.policy!r}; "
            f"have {sorted(AUTOSCALERS)}") from None
    return cls(spec)
