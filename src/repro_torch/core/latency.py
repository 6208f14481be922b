"""Per-request latency ledger + percentile aggregation (TTFT / TBT).

The serving SLO vocabulary, stamped by the serving pool in both wall and
virtual clock modes:

* **TTFT** — time to first token: first-token emission minus arrival
  (queueing + admission prefill included).
* **TBT**  — time between tokens: the gap between consecutive emitted
  tokens of one request. On the cluster's serialised tick timeline a gap
  also absorbs any chunked-prefill admission that ran between the two
  decode steps — which is precisely the latency chunked prefill exists to
  bound.

``LatencyLedger`` is the event record one ``Request`` carries;
``summarize_latency`` folds a set of finished requests into the p50/p95/p99
numbers a benchmark reports and the SLO controller regulates against.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass(slots=True)
class LatencyLedger:
    """Event timestamps (seconds on the serving clock) for one request.

    ``slots=True``: a ledger is built per request and the event engine
    replays millions of them — slots cut per-instance memory and attribute
    lookups on the stamping hot path."""

    arrival_s: Optional[float] = None      # entered the waiting queue
    admitted_s: Optional[float] = None     # popped by the scheduler (prefill start)
    first_token_s: Optional[float] = None  # prefill's token placed in a slot
    finish_s: Optional[float] = None       # EOS / max_new_tokens reached
    token_s: List[float] = dataclasses.field(default_factory=list)
    # decode-token emission times (everything after the first token)

    # ------------------------------------------------------------- stamping
    def mark_arrival(self, t: float):
        self.arrival_s = float(t)

    def mark_admitted(self, t: float):
        self.admitted_s = float(t)

    def mark_first_token(self, t: float):
        self.first_token_s = float(t)

    def mark_token(self, t: float):
        self.token_s.append(float(t))

    def mark_finish(self, t: float):
        self.finish_s = float(t)

    def reset_service(self):
        """Preemption-by-eviction discards generated tokens; the ledger
        follows: service timestamps clear, the arrival stays, and TTFT ends
        up including the requeue + recompute delay."""
        self.admitted_s = None
        self.first_token_s = None
        self.finish_s = None
        self.token_s = []

    def reset(self):
        """Clear EVERY stamp (arrival included) — the request-freelist path
        (``repro.serving.pool.release_request``) recycles ledgers wholesale,
        unlike ``reset_service`` which preserves the arrival across a
        preemption."""
        self.arrival_s = None
        self.reset_service()

    # ------------------------------------------------------------- derived
    @property
    def queue_s(self) -> Optional[float]:
        if self.arrival_s is None or self.admitted_s is None:
            return None
        return self.admitted_s - self.arrival_s

    @property
    def ttft_s(self) -> Optional[float]:
        if self.arrival_s is None or self.first_token_s is None:
            return None
        return self.first_token_s - self.arrival_s

    @property
    def e2e_s(self) -> Optional[float]:
        if self.arrival_s is None or self.finish_s is None:
            return None
        return self.finish_s - self.arrival_s

    @property
    def tbt_s(self) -> List[float]:
        """Inter-token gaps: first->second, second->third, ..."""
        stamps = ([self.first_token_s] if self.first_token_s is not None else []) \
            + self.token_s
        return [b - a for a, b in zip(stamps, stamps[1:])]

    @property
    def last_tbt_s(self) -> Optional[float]:
        """The most recent inter-token gap (the SLO controller's live feed)."""
        if self.token_s and self.first_token_s is not None:
            prev = self.token_s[-2] if len(self.token_s) >= 2 else self.first_token_s
            return self.token_s[-1] - prev
        return None


def percentile(values: Sequence[float], q: float) -> float:
    """Deterministic linear-interpolation percentile; 0.0 on empty input."""
    if not len(values):
        return 0.0
    return float(np.percentile(np.asarray(values, np.float64), q))


@dataclasses.dataclass(frozen=True)
class LatencySummary:
    """Percentile roll-up over a set of requests (the SLO statement)."""

    n_requests: int
    n_tokens: int
    p50_ttft_s: float
    p95_ttft_s: float
    p99_ttft_s: float
    p50_tbt_s: float
    p95_tbt_s: float
    p99_tbt_s: float
    p50_e2e_s: float
    p99_e2e_s: float
    mean_ttft_s: float
    mean_tbt_s: float
    # queue delay (arrival -> admitted): the fraction of TTFT a router or
    # scheduler owns — fleet routing decisions are invisible without it
    p50_queue_s: float = 0.0
    p95_queue_s: float = 0.0
    p99_queue_s: float = 0.0
    mean_queue_s: float = 0.0
    p95_e2e_s: float = 0.0

    @classmethod
    def empty(cls) -> "LatencySummary":
        """The well-defined zero-observation summary: every percentile and
        mean is 0.0 and ``n_requests``/``n_tokens`` are 0. This is what
        ``summarize_latency`` returns when nothing finished — e.g. when an
        autoscaler parks the only replica mid-trace — so callers can always
        read fields without guarding against a crash; check ``n_requests``
        before treating the zeros (or a vacuous ``meets``) as a met SLO."""
        return cls(n_requests=0, n_tokens=0,
                   p50_ttft_s=0.0, p95_ttft_s=0.0, p99_ttft_s=0.0,
                   p50_tbt_s=0.0, p95_tbt_s=0.0, p99_tbt_s=0.0,
                   p50_e2e_s=0.0, p99_e2e_s=0.0,
                   mean_ttft_s=0.0, mean_tbt_s=0.0)

    def meets(self, *, ttft_s: Optional[float] = None,
              tbt_s: Optional[float] = None) -> bool:
        """Does this population meet a p99 SLO target pair? Vacuously True
        on an empty summary (no observations violate nothing) — gate on
        ``n_requests`` where an empty population must not count as met."""
        ok = True
        if ttft_s is not None:
            ok = ok and self.p99_ttft_s <= ttft_s
        if tbt_s is not None:
            ok = ok and self.p99_tbt_s <= tbt_s
        return ok


def summarize_latency(requests: Iterable) -> LatencySummary:
    """Fold ``Request``s (anything with a ``.ledger``) into a summary.

    Requests whose ledgers carry no finished observations contribute
    nothing but still count in ``n_requests``; an empty (or entirely
    unfinished) population folds to ``LatencySummary.empty()``-shaped
    zeros rather than crashing on empty percentile input."""
    ttfts: List[float] = []
    tbts: List[float] = []
    e2es: List[float] = []
    queues: List[float] = []
    n_tokens = 0
    n = 0
    for r in requests:
        n += 1
        led = r.ledger
        if led.ttft_s is not None:
            ttfts.append(led.ttft_s)
        tbts.extend(led.tbt_s)
        if led.e2e_s is not None:
            e2es.append(led.e2e_s)
        if led.queue_s is not None:
            queues.append(led.queue_s)
        n_tokens += len(getattr(r, "output", ()))
    if n == 0:
        return LatencySummary.empty()
    return LatencySummary(
        n_requests=n,
        n_tokens=n_tokens,
        p50_ttft_s=percentile(ttfts, 50),
        p95_ttft_s=percentile(ttfts, 95),
        p99_ttft_s=percentile(ttfts, 99),
        p50_tbt_s=percentile(tbts, 50),
        p95_tbt_s=percentile(tbts, 95),
        p99_tbt_s=percentile(tbts, 99),
        p50_e2e_s=percentile(e2es, 50),
        p99_e2e_s=percentile(e2es, 99),
        mean_ttft_s=float(np.mean(ttfts)) if ttfts else 0.0,
        mean_tbt_s=float(np.mean(tbts)) if tbts else 0.0,
        p50_queue_s=percentile(queues, 50),
        p95_queue_s=percentile(queues, 95),
        p99_queue_s=percentile(queues, 99),
        mean_queue_s=float(np.mean(queues)) if queues else 0.0,
        p95_e2e_s=percentile(e2es, 95),
    )
