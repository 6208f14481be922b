"""Discrete-event fleet engine: the per-fleet event heap over per-pool clocks.

Counterpart of ``repro.serving.events``. The barrier engine
(``Fleet.step``) advances every busy replica one tick per round and syncs
all clocks to the slowest — fidelity and throughput are both capped by the
round. This module replaces the round with a single min-heap of events
keyed on virtual time: trace arrivals, admission ticks, decode steps,
warm-up completions and autoscaler evaluations each fire when their OWN
dependencies are ready. Consequences:

* **Prefill overlaps decode.** Each replica's prefill pool runs on its own
  ``VirtualClock``; an admission prefill advances only that timeline, and
  the filled cache row is handed to the decode pool as a *pending
  placement* that joins the first decode step whose start time has reached
  the prefill's completion.
* **No global rounds.** Replicas interact only through arrivals (routing)
  and the autoscaler; a fast replica takes as many steps as fit in the
  time a slow one needs for one.
* **Fused homogeneous decode.** Decode events that pop at the same virtual
  time with the same model signature step in ONE fused dispatch: the
  member pools' decode steps (each a replay of the pool's own CUDA graph on
  a card) are issued back to back, and their tokens come back to the host
  together. Each pool still samples from its own generator and keeps its
  own accounting, so token streams are independent of grouping.
* **Batched replica axis** (``batch_replicas``, default on). The
  reference runs a fused group as one ``jax.vmap`` program over
  replica-stacked caches kept in a ``CacheBank``. The port does not
  restack: each pool's captured graph binds its own cache, and a padded
  repeat would write the first member's cache twice. So the batched
  dispatch issues the members' own steps and reads their tokens back in
  ONE stacked transfer. Pad members are counted (``pad_waste``), never run.
  ``batch_replicas=False`` is the tuple dispatch (one transfer per member),
  the reference's tuple-of-K baseline. ``batch_layout="shard_map"`` (the
  replica axis over several devices) is dropped: the port serves on one
  card, and it raises.
* **Fused admission prefill.** Admission events that pop at the same
  instant defer their prefills; the engine groups them by (config,
  params, prompt bucket) and issues each group's K independent batch-1
  prefills as one dispatch (never one batch-K prefill: another GEMM shape
  gives other bits), then replays the per-request accounting (clock
  advance, gauge bracketing, ledger stamps, sampling order, modelled
  joules) in exactly the serial order. ``fuse_prefill=False`` is the
  serial baseline.
* **Fusion quantum.** ``fusion_quantum_s=q`` widens decode fusion from
  exact ties to consecutive decode events at the top of the heap inside
  ``[t, t+q)``; each pool still advances its own clock by its own step
  time, so token streams are invariant under any quantum. ``q=0`` is the
  exact-tie engine.

Event ordering at equal times is fixed by kind priority (warm-up
completions < arrivals < admissions < decode steps < autoscaler timers)
then by insertion sequence — the replay is a pure function of the trace.

Scale plumbing: arrivals enter the heap LAZILY (one in flight, so the heap
stays O(replicas)); fused group sizes bucket to powers of two, as the
reference pads its programs (``pad_waste`` counts the pads); ``on_finish``
streams finished requests (pair it with
``repro_torch.serving.pool.release_request`` for a memory-flat replay);
``EngineStats`` counts events, dispatches, fusion coverage and heap depth,
and ``Fleet.last_engine_stats`` hands it to the benchmarks.

``EngineStats`` has the reference's counters on the same replay, with
these differences. The port has no jitted programs and no stacked bank, so
it keeps none of the reference's counters of them: ``fused_traces``
(programs built), ``bank_gathers`` / ``bank_rebuilds`` (bank re-stacks)
and ``batched_prefill_calls`` (vmapped prefills), nor its
``fused_cache_cap`` option. ``fused_decode_wall`` is wall seconds. Under
``batch_replicas`` the reference's ``pool_jit_dispatches`` (with it
``jit_dispatches``) also count the gathers that materialise a pool's row
out of a bank, so the port's count is the tuple dispatch's.

Semantics notes (parity with the barrier engine where timelines coincide):

* On a fleet whose pools share ONE clock (the single-replica ``Cluster``
  facade) prefill advances the decode timeline too, placements are always
  ready by the next decode pop, and the engine reproduces the barrier's
  step composition — token streams AND modelled joules are identical.
* Admission credit (``Scheduler``) accrues once per decode step — the
  barrier's chunked-prefill cadence. Arrival-time admission ticks only
  SPEND credit (``accrue=False``); an idle replica whose queue head needs
  more credit than one chunk spins zero-duration admission events, exactly
  like the barrier's zero-duration rounds.
* With an autoscaler, a timer event fires every ``tick_interval_s`` so
  hold windows and forecasts evaluate mid-gap (the barrier engine gets the
  same via ``Fleet._cross_idle_gap``).
"""
from __future__ import annotations

import dataclasses
import heapq
import time
from typing import (
    Any, Callable, Dict, List, Optional, Set, Tuple, TYPE_CHECKING,
)

import torch

from repro_torch.serving.pool import (
    Pool, Request, observe_latencies, requeue_front,
)

BATCH_LAYOUTS = ("vmap", "shard_map")

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.serving.fleet import Fleet, Replica

__all__ = ["EngineStats", "EventDrivenFleet"]

# pop order at equal virtual time: a warm-up that ends exactly when a
# request arrives must admit it; an admission decided at t feeds the decode
# step at t; the autoscaler sees the post-step world
PRIO_WARM, PRIO_ARRIVAL, PRIO_ADMIT, PRIO_DECODE, PRIO_SCALE = range(5)

_EPS = 1e-12


@dataclasses.dataclass(slots=True)
class EngineStats:
    """Counter block for one event-engine replay — the observability the
    scale work needs to see where the next bottleneck moves. Written into
    every serving benchmark's JSON artifact via ``as_dict``."""

    events: int = 0                    # heap pops, every kind
    events_by_kind: Dict[str, int] = dataclasses.field(default_factory=dict)
    peak_heap: int = 0                 # max heap length observed
    decode_steps: int = 0              # per-pool decode steps executed
    placements: int = 0                # cache rows placed into decode slots
    prefills: int = 0                  # admission prefills run
    fused_prefill_calls: int = 0       # grouped prefill dispatches
    serial_prefill_calls: int = 0      # one-request prefill dispatches
    fused_prefill_reqs: int = 0        # prefills served by fused dispatches
    fused_decode_calls: int = 0        # multi-pool decode dispatches
    serial_decode_calls: int = 0       # one-pool decode dispatches
    batched_decode_calls: int = 0      # fused decode dispatches that ran
                                       # batched (one stacked token read;
                                       # subset of fused_decode_calls)
    pad_waste: int = 0                 # pow2 pad slots across fused calls
                                       # (counted, never run)
    # measured wall seconds inside fused decode dispatches, keyed by the
    # pow2-padded group size as a string: size -> [calls, seconds]. Only
    # populated with ``time_dispatch=True`` (blocking on each dispatch
    # perturbs overlap, so the default replay never pays it)
    fused_decode_wall: Dict[str, List[float]] = dataclasses.field(
        default_factory=dict)
    pool_jit_dispatches: int = 0       # serial dispatches made by the pools
                                       # (prefill + scatter + serial decode)
    # prefix-sharing counters (pool lifetime, summed over decode pools at
    # run() end — all-zero on fleets with sharing off; the full breakdown
    # rides in ``prefix_stats``)
    prefix_hits: int = 0
    prefix_shared_blocks: int = 0
    prefix_cow_splits: int = 0
    saved_prefill_j: float = 0.0
    prefix_stats: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def jit_dispatches(self) -> int:
        """Total dispatches this replay paid (fused + serial)."""
        return (self.pool_jit_dispatches + self.fused_decode_calls
                + self.fused_prefill_calls)

    @property
    def fused_prefill_coverage(self) -> float:
        """Fraction of admission prefills served by a fused dispatch."""
        return self.fused_prefill_reqs / self.prefills if self.prefills else 0.0

    @property
    def fused_decode_coverage(self) -> float:
        """Fraction of pool decode steps served by a fused dispatch."""
        if not self.decode_steps:
            return 0.0
        return (self.decode_steps - self.serial_decode_calls) / self.decode_steps

    def as_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["jit_dispatches"] = self.jit_dispatches
        d["fused_prefill_coverage"] = self.fused_prefill_coverage
        d["fused_decode_coverage"] = self.fused_decode_coverage
        return d


class EventDrivenFleet:
    """One trace replay, event-driven. Build per ``run_trace`` call.

    ``fusion_quantum_s`` widens decode-dispatch fusion from exact virtual-
    time ties to the half-open window ``[t, t+q)`` (see module docstring);
    0 is byte-identical to the exact-tie engine. ``fuse_prefill`` toggles
    the batched admission-prefill path (True by default; False is the
    serial dispatch behaviour and the byte-identity baseline).
    ``max_fused_group`` caps how many pools one fused dispatch steps
    (rounded up to a power of two; larger batches chunk).
    ``on_finish`` streams each finished request to the callback INSTEAD of
    accumulating it in the returned list — the memory-flat path for
    million-request replays (pair with ``pool.release_request``)."""

    def __init__(self, fleet: "Fleet", *, fast_path_min: int = 4,
                 fusion_quantum_s: float = 0.0,
                 fuse_prefill: bool = True,
                 max_fused_group: int = 64,
                 batch_replicas: bool = True,
                 batch_layout: str = "vmap",
                 time_dispatch: bool = False,
                 on_finish: Optional[Callable[[Request], None]] = None):
        if not fleet.virtual:
            raise ValueError("the event engine needs VirtualClock replicas")
        if fusion_quantum_s < 0:
            raise ValueError("fusion_quantum_s must be >= 0")
        if max_fused_group < 1:
            raise ValueError("max_fused_group must be >= 1")
        if batch_layout not in BATCH_LAYOUTS:
            raise ValueError(f"batch_layout {batch_layout!r} not in "
                             f"{BATCH_LAYOUTS}")
        if batch_layout == "shard_map":
            raise ValueError(
                "batch_layout='shard_map' lays the replica axis over several "
                "devices; the port serves a fleet on one card (one CUDA "
                "device), where the reference falls back to 'vmap' too: pass "
                "batch_layout='vmap'")
        self.fleet = fleet
        self.fast_path_min = max(2, int(fast_path_min))
        self.fusion_quantum_s = float(fusion_quantum_s)
        self.fuse_prefill = bool(fuse_prefill)
        # pow2 so chunk sizes bucket onto themselves
        self.max_fused_group = 1 << (int(max_fused_group) - 1).bit_length()
        # batch_replicas=True (the default) reads each fused group's tokens
        # in one stacked transfer; False is the tuple dispatch — the
        # serial-fused byte-identity baseline
        self.batch_replicas = bool(batch_replicas)
        self.batch_layout = batch_layout
        self.time_dispatch = bool(time_dispatch)
        self.on_finish = on_finish
        self.stats = EngineStats()
        self._heap: List[Tuple[float, int, int, str, Any]] = []
        self._seq = 0
        self._real = 0                     # outstanding non-timer events
        # per replica: prefilled-but-not-placed rows as MUTABLE entries
        # [ready_s, req, cache1, first] in admission order (the fused
        # admission path appends placeholders during the scheduler tick and
        # fills them after the batched dispatch)
        self._pending: Dict[str, List[List[Any]]] = {
            r.name: [] for r in fleet.replicas}
        # per replica: virtual time of the scheduled decode event, or None
        self._decode_at: Dict[str, Optional[float]] = {
            r.name: None for r in fleet.replicas}
        # per replica: requests placed since its last decode step (the
        # TTFT population observe_latencies feeds the slo loop)
        self._obs: Dict[str, List[Request]] = {r.name: [] for r in fleet.replicas}
        # per replica: outstanding admission events. While one is in flight
        # an arrival just enqueues — the scheduled tick at >= t will see it,
        # exactly the barrier's release-then-tick round top
        self._admit_sched: Dict[str, int] = {r.name: 0 for r in fleet.replicas}
        self._warm_sched: Set[Tuple[str, float]] = set()
        self._scale_pending: Set[float] = set()
        self._steps = 0
        # lazy arrival feed: one trace arrival in the heap at a time
        self._trace: List[Any] = []
        self._next_arrival = 0
        self._tick_interval = 0.0
        if fleet.autoscaler is not None:
            self._tick_interval = float(getattr(
                getattr(fleet.autoscaler, "spec", None),
                "tick_interval_s", 0.0) or 0.0)

    # --------------------------------------------------------------- back-compat
    @property
    def fused_calls(self) -> int:
        """Fused decode dispatches (the engine's first counter name)."""
        return self.stats.fused_decode_calls

    # ----------------------------------------------------------- heap basics
    def _push(self, t: float, prio: int, kind: str, payload: Any):
        heapq.heappush(self._heap, (t, prio, self._seq, kind, payload))
        self._seq += 1
        if prio != PRIO_SCALE:
            self._real += 1
        if len(self._heap) > self.stats.peak_heap:
            self.stats.peak_heap = len(self._heap)

    def _pop(self):
        ev = heapq.heappop(self._heap)
        if ev[1] != PRIO_SCALE:
            self._real -= 1
        st = self.stats
        st.events += 1
        kind = ev[3]
        st.events_by_kind[kind] = st.events_by_kind.get(kind, 0) + 1
        return ev

    def _push_admit(self, name: str, t: float, accrue: bool):
        self._admit_sched[name] += 1
        self._push(t, PRIO_ADMIT, "admit", (name, accrue))

    def _push_next_arrival(self):
        """Feed the next trace arrival into the heap. Arrivals are sorted,
        so holding exactly one keeps the heap O(replicas) deep at 10^6
        requests while popping in the same order an eager fill would (heap
        ties only compare the insertion sequence WITHIN one (t, priority)
        class, and only one trace arrival is ever in flight)."""
        i = self._next_arrival
        if i < len(self._trace):
            self._next_arrival = i + 1
            self._push(self._t_start + self._trace[i].arrival_s,
                       PRIO_ARRIVAL, "arrival", i)

    @staticmethod
    def _pow2(n: int) -> int:
        return 1 << (n - 1).bit_length()

    # ------------------------------------------------------------ clock utils
    @staticmethod
    def _catch_up(pool: Pool, t: float):
        """Advance an idle/lagging pool timeline to the event time, sampling
        so the wait integrates at its gauge power (idle floor when empty)."""
        if pool.clock.now_s < t:
            pool.clock.advance_to(t)
            pool.sample_now()

    # ------------------------------------------------------------------- run
    def run(self, trace, *, max_steps: int = 1000000) -> List[Request]:
        fleet = self.fleet
        self._trace = sorted(trace, key=lambda t: t.arrival_s)
        self._t_start = t_start = fleet.now_s()
        base_dispatch = sum(p.jit_dispatches for r in fleet.replicas
                            for p in (r.prefill_pool, r.decode_pool))
        self._push_next_arrival()
        for r in fleet.replicas:
            if r.powered and r._warming_until_s is not None:
                self._schedule_warm(r)
            # work queued/live before run() (Cluster.submit + run_trace)
            if r.decode_pool.occupancy() > 0:
                self._ensure_decode(r)
            elif r.waiting:
                self._push_admit(r.name, r.max_clock_s(), True)
        if fleet.autoscaler is not None and self._tick_interval > 0:
            self._push(t_start + self._tick_interval, PRIO_SCALE, "scale", None)
        done: List[Request] = []
        quantum = self.fusion_quantum_s
        fleet.start_metering()
        try:
            while self._heap and self._steps < max_steps:
                t, prio, _, kind, payload = self._pop()
                if kind == "decode":
                    # batch decode events at the SAME instant — and, with a
                    # fusion quantum, every decode event at the top of the
                    # heap inside [t, t+q). A replica's decode event is
                    # always preceded by its own post-step ADMIT event at
                    # the same stamp, so the window also processes ADMIT
                    # events inside it for replicas NOT already drained
                    # (disjoint per-replica state: the reorder against an
                    # earlier replica's decode step is unobservable). Only
                    # dispatch grouping changes — each pool still steps at
                    # its own scheduled time on its own clock; arrivals,
                    # warm-ups, autoscaler events, or a repeat replica
                    # terminate the window, so routing and same-replica
                    # sequencing keep the exact-tie order
                    names = [payload]
                    seen = {payload}
                    win = t + quantum
                    while self._heap:
                        t0, p0 = self._heap[0][0], self._heap[0][1]
                        if (p0 == PRIO_DECODE
                                and (t0 <= t + _EPS or t0 < win)
                                and self._heap[0][4] not in seen):
                            names.append(self._pop()[4])
                            seen.add(names[-1])
                        elif (quantum > 0.0 and p0 == PRIO_ADMIT
                              and t0 < win
                              and self._heap[0][4][0] not in seen):
                            ev = self._pop()
                            name, accrue = ev[4]
                            self._admit_sched[name] -= 1
                            r = fleet.by_name[name]
                            self._admit(r, ev[0], accrue=accrue)
                            self._after_admit(r)
                        else:
                            break
                    finished = self._decode_batch(names, t)
                    if self.on_finish is not None:
                        for q in finished:
                            self.on_finish(q)
                    else:
                        done.extend(finished)
                elif kind == "arrival":
                    self._push_next_arrival()
                    self._handle_arrival(self._trace[payload], t)
                elif kind == "admit":
                    if not self.fuse_prefill:
                        name, accrue = payload
                        self._admit_sched[name] -= 1
                        r = fleet.by_name[name]
                        self._admit(r, t, accrue=accrue)
                        self._after_admit(r)
                    else:
                        # drain same-instant admission events for DISTINCT
                        # replicas: their scheduler ticks are independent,
                        # so the decided prefills can share one dispatch.
                        # A repeat of a replica ends the drain — its second
                        # tick depends on the first's placements
                        batch = [payload]
                        seen = {payload[0]}
                        while (self._heap
                               and self._heap[0][1] == PRIO_ADMIT
                               and self._heap[0][0] <= t + _EPS
                               and self._heap[0][4][0] not in seen):
                            ev = self._pop()
                            batch.append(ev[4])
                            seen.add(ev[4][0])
                        self._admit_batch(batch, t)
                elif kind == "warm":
                    self._handle_warm(fleet.by_name[payload], t)
                elif kind == "scale":       # the autoscaler's periodic timer
                    self._handle_scale(t)
                else:                       # "autoscale": one-shot round end
                    self._scale_pending.discard(t)
                    self._autoscale()
        finally:
            # pull every pool to the fleet's final time so lagging idle
            # floors integrate to the horizon the barrier would have reached
            t_end = fleet.now_s()
            for r in fleet.replicas:
                r.advance_all(t_end)
            fleet.stop_metering()
            st = self.stats
            st.decode_steps = self._steps
            st.pool_jit_dispatches = sum(
                p.jit_dispatches for r in fleet.replicas
                for p in (r.prefill_pool, r.decode_pool)) - base_dispatch
            ps = fleet.prefix_stats_total()
            st.prefix_hits = ps.hits
            st.prefix_shared_blocks = ps.shared_blocks
            st.prefix_cow_splits = ps.cow_splits
            st.saved_prefill_j = ps.saved_prefill_j
            st.prefix_stats = ps.as_dict()
            fleet.last_engine_stats = st
        return done

    # --------------------------------------------------------------- arrivals
    def _handle_arrival(self, tr, t: float):
        fleet = self.fleet
        if (fleet.autoscaler is not None and self._tick_interval <= 0
                and not fleet.busy()):
            # timer-less mode: the barrier autoscales once at the end of an
            # all-idle gap, after advancing every clock across it
            for r in fleet.replicas:
                r.advance_all(t)
            self._autoscale()
        req = fleet.submit(tr.prompt, tr.max_new_tokens,
                           temperature=tr.temperature, arrival_s=t,
                           bucket=tr.bucket)
        r = fleet.by_name[req.replica]
        if r._warming_until_s is not None and t < r._warming_until_s - _EPS:
            self._schedule_warm(r)          # admission fires when warm
        elif self._admit_sched[r.name] == 0:
            # spend-only tick: credit accrues per decode step (or on a
            # fresh, fully idle replica — the barrier's first round).
            # With an admission event already in flight the request just
            # enqueues: the scheduled tick sees it, the barrier's
            # release-arrivals-then-tick order at a round top
            fresh = (self._decode_at[r.name] is None
                     and not self._pending[r.name])
            self._admit(r, t, accrue=fresh)
            self._after_admit(r)

    # -------------------------------------------------------------- admission
    def _admit_tick(self, r: "Replica", t: float, *, accrue: bool,
                    collect: Optional[List[Tuple[Pool, Request, List[Any]]]] = None):
        """One scheduler tick at event time ``t`` on the replica's prefill
        timeline. Prefilled rows become pending placements; the decode
        timeline picks them up in ``_flush``.

        With ``collect`` given, the admission prefill DISPATCH is deferred:
        each admitted request appends a mutable placeholder to the pending
        list (the gate closure only reads entry count + prompt lengths, so
        capacity accounting is exact) and a job onto ``collect``; the
        caller runs the batched dispatch and then fills every placeholder
        through ``Pool.prefill_request(precomputed=...)`` in admission
        order — the per-pool clock/gauge/RNG/stamp sequence is untouched."""
        if not r.powered or (r._warming_until_s is not None
                             and t < r._warming_until_s - _EPS):
            return None
        pp, dp = r.prefill_pool, r.decode_pool
        self._catch_up(pp, t)
        if not r.waiting:
            r.scheduler.tick(r.waiting, pp, dp)     # credit reset, empty queue
            return None
        if r.controller is not None:
            r._step_no += 1
            r.controller.tick(r.pools(), r._step_no)
        pend = self._pending[r.name]
        st = self.stats

        def gate(req: Request) -> bool:
            # can_admit, minus capacity already promised to pending rows
            if len(dp.free_slots()) <= len(pend):
                return False
            if dp.paged:
                need = dp.allocator.blocks_for_tokens(len(req.prompt) + 1)
                extra = 0
                if dp._prefix is not None:
                    # shared entries the candidate would reuse need no fresh
                    # blocks; index pages NOT reused stay reclaimable. The
                    # pending rows' held stays the conservative full need
                    # (their hits are already acquired, so double-counting
                    # is impossible — just pessimistic)
                    entries, _ = dp._peek_fitted(req.prompt)
                    need = max(need - entries, 0)
                    extra = max(dp._prefix.reclaimable_blocks() - entries, 0)
                held = sum(dp.allocator.blocks_for_tokens(len(e[1].prompt) + 1)
                           for e in pend)
                return need + held <= dp.allocator.free_blocks + extra
            return True

        if collect is None:
            def admit(req: Request) -> None:
                hit = dp.prefix_acquire(req)
                first, cache1 = pp.prefill_request(req, shared=hit, donor=dp)
                pend.append([pp.clock.now_s, req, cache1, first])
                st.prefills += 1
                st.serial_prefill_calls += 1
        else:
            def admit(req: Request) -> None:
                # acquire NOW (tick order fixes capacity + stats order);
                # the dispatch itself is deferred to the fused phase. The
                # hit travels with the job — placement re-finds it via the
                # pool's own _pending_hits stash
                hit = dp.prefix_acquire(req)
                entry: List[Any] = [None, req, None, None]
                pend.append(entry)
                collect.append((pp, req, entry, hit, dp))

        admitted = r.scheduler.tick(r.waiting, pp, dp,
                                    admit=admit, gate=gate, accrue=accrue)
        return {"admitted": admitted, "gate": gate}

    def _admit_finish(self, r: "Replica", info: Optional[Dict[str, Any]]):
        """The post-tick half of an admission: log the tick's admissions
        (their ledgers are stamped by now even on the fused path) and spin
        a zero-duration admission event for a long queue head."""
        if info is None:
            return
        for req in info["admitted"]:
            r.admit_log.append((req.ledger.admitted_s, req.ledger.queue_s))
        pend = self._pending[r.name]
        if (r.waiting and not info["admitted"] and not pend
                and self._decode_at[r.name] is None
                and self._admit_sched[r.name] == 0
                and r.decode_pool.occupancy() == 0
                and info["gate"](r.waiting[0])
                and len(r.waiting[0].prompt) > r.scheduler._credit):
            # idle replica, long head: spin zero-duration admission events
            # until accrued credit covers the prompt — the barrier's
            # frozen-clock rounds, bounded at ceil(prompt/chunk) spins
            self._push_admit(r.name, r.prefill_pool.clock.now_s, True)

    def _admit(self, r: "Replica", t: float, *, accrue: bool):
        """Single-replica admission (arrival-path / warm-path / single
        ADMIT event). With ``fuse_prefill`` on, a tick that admits K
        requests still runs ONE grouped dispatch; with it off, every
        prefill dispatches inline inside the scheduler tick (the serial
        baseline)."""
        if not self.fuse_prefill:
            self._admit_finish(r, self._admit_tick(r, t, accrue=accrue))
            return
        jobs: List[Tuple[Pool, Request, List[Any], Any, Pool]] = []
        info = self._admit_tick(r, t, accrue=accrue, collect=jobs)
        if jobs:
            self._prefill_fused(jobs)
        self._admit_finish(r, info)

    def _admit_batch(self, batch: List[Tuple[str, bool]], t: float):
        """Process a drained batch of same-instant admission events for
        distinct replicas: collect every decided admission with its prefill
        dispatch deferred, run the grouped dispatches, then finish each
        replica in event order. Equivalent to processing the events
        serially because the ticks touch disjoint replica state, the
        deferred accounting replays in admission order, and every heap push
        (spin admits, decode events) happens in the finish phase in the
        same per-replica order the serial engine uses."""
        fleet = self.fleet
        jobs: List[Tuple[Pool, Request, List[Any], Any, Pool]] = []
        infos: List[Tuple["Replica", Optional[Dict[str, Any]]]] = []
        for name, accrue in batch:
            self._admit_sched[name] -= 1
            r = fleet.by_name[name]
            infos.append((r, self._admit_tick(r, t, accrue=accrue,
                                              collect=jobs)))
        if jobs:
            self._prefill_fused(jobs)
        for r, info in infos:
            self._admit_finish(r, info)
            self._after_admit(r)

    def _prefill_fused(self, jobs: List[Tuple[Pool, Request, List[Any], Any, Pool]]):
        """Run every deferred admission prefill in grouped dispatches
        and fill the pending-placement placeholders. Grouping is by
        (config, params, max_seq_len, prompt bucket); group sizes chunk at
        ``max_fused_group``; their pow2 padding (the reference's inert
        repeats of the first prompt) is counted, not run. The per-request
        accounting replays afterwards IN JOB ORDER — each pool sees its
        admissions in exactly the serial sequence.

        Prefix-hit jobs never join a fused group: a suffix prefill gathers
        from its donor's live paged cache, which the NEXT hit in the same
        batch may extend — so each one dispatches individually (counted
        serial) and only its accounting replays at its job-order slot."""
        st = self.stats
        groups: Dict[Tuple[Any, ...], List[Tuple[Pool, Any, Any, int, List[Any]]]] = {}
        order: List[Tuple[Any, ...]] = []
        for pp, req, entry, hit, dp in jobs:
            if hit is not None:
                continue
            toks, true_len, bucket = pp.prefill_tokens(req)
            # params_token (not id(params)): a stable monotonic identity
            # that a GC'd fleet can never hand to a different pool's weights
            sig = (pp.cfg, pp.params_token, pp.max_seq_len, bucket)
            g = groups.get(sig)
            if g is None:
                g = groups[sig] = []
                order.append(sig)
            g.append((pp, toks, true_len, bucket, entry))
        results: Dict[int, Tuple[Any, Any]] = {}
        for sig in order:
            items = groups[sig]
            for i in range(0, len(items), self.max_fused_group):
                self._prefill_fused_chunk(items[i:i + self.max_fused_group], results)
        for pp, req, entry, hit, dp in jobs:
            if hit is not None:
                first, cache1 = pp.prefill_request(req, shared=hit, donor=dp)
                st.serial_prefill_calls += 1
            else:
                first, cache1 = pp.prefill_request(
                    req, precomputed=results[id(entry)])
                st.fused_prefill_reqs += 1
            entry[0] = pp.clock.now_s
            entry[2] = cache1
            entry[3] = first
            st.prefills += 1

    @torch.inference_mode()
    def _prefill_fused_chunk(self, items, results: Dict[int, Any]):
        """One fused prefill dispatch: the chunk's K independent batch-1
        bucketed prefills issued back to back with no host read in between
        — the same computations as the serial ``prefill_row`` calls, only
        the dispatch is shared. The pow2 padding of the reference's program
        is counted (``pad_waste``), not run."""
        st = self.stats
        st.fused_prefill_calls += 1
        st.pad_waste += self._pow2(len(items)) - len(items)
        for pp, toks, true_len, _, entry in items:
            results[id(entry)] = pp.prefill_row(toks, true_len)

    def _flush(self, r: "Replica"):
        """Place pending prefilled rows whose handoff time the decode
        timeline has reached — every consecutively-ready row in ONE
        ``place_many`` scatter dispatch; an IDLE decode pool jumps forward
        to the earliest handoff instead (sampling its gauge across the
        wait)."""
        pend = self._pending[r.name]
        dp = r.decode_pool
        while pend:
            batch = []
            while pend:
                ready, req, cache1, first = pend[0]
                if ready is None or ready > dp.clock.now_s + _EPS:
                    break
                pend.pop(0)
                batch.append((req, cache1, first, len(req.prompt), ready))
            if batch:
                dp.place_many(batch)
                obs = self._obs[r.name]
                for item in batch:
                    obs.append(item[0])
                self.stats.placements += len(batch)
                continue                    # occupancy changed: re-evaluate
            ready = pend[0][0]
            if (ready is None or dp.occupancy() > 0
                    or self._decode_at[r.name] is not None):
                break                       # joins a later step
            self._catch_up(dp, ready)

    def _ensure_decode(self, r: "Replica"):
        """Schedule the replica's next decode event: now for live slots,
        the earliest handoff for a pool waiting on its first placement."""
        if self._decode_at[r.name] is not None:
            return
        if r.decode_pool.occupancy() > 0:
            t = r.decode_pool.clock.now_s
        elif self._pending[r.name]:
            # a handoff decided mid-step can be ready before the step's end;
            # the event still fires at the decode timeline's present
            t = max(self._pending[r.name][0][0], r.decode_pool.clock.now_s)
        else:
            return
        self._decode_at[r.name] = t
        self._push(t, PRIO_DECODE, "decode", r.name)

    def _after_admit(self, r: "Replica"):
        self._flush(r)
        self._ensure_decode(r)

    # ----------------------------------------------------------- decode steps
    def _decode_batch(self, names: List[str], t: float) -> List[Request]:
        fleet = self.fleet
        reps = [fleet.by_name[n] for n in names]
        for r in reps:
            self._decode_at[r.name] = None
            self._flush(r)
        live = [r for r in reps if r.decode_pool.occupancy() > 0]
        for r in live:
            if r.controller is not None:
                r._step_no += 1
                r.controller.tick(r.pools(), r._step_no)
        finished_by = self._run_decodes(live)
        done: List[Request] = []
        for r in live:
            finished = finished_by[r.name]
            if r.controller is not None:
                observe_latencies(r.controller, r.decode_pool,
                                  self._obs.pop(r.name, []), finished)
                self._obs[r.name] = []
            requeue_front(r.waiting, r.decode_pool.take_evicted())
            done.extend(finished)
            self._steps += 1
            # post-step admission as an ADMIT event at the step's end —
            # arrivals stamped inside the step pop first (earlier heap
            # times, lower prio at a tie), so the accrual tick sees them
            # enqueued: the barrier's release-then-tick round top
            self._push_admit(r.name, r.decode_pool.clock.now_s, True)
            self._ensure_decode(r)
        for r in reps:
            if r not in live:
                self._after_admit(r)        # pending handoff still ahead
        fleet._power_down_drained()
        if (fleet.autoscaler is not None and self._tick_interval <= 0
                and live):
            # timer-less mode evaluates once per "round", after the round's
            # admissions land — a one-shot event behind the admit events
            t_end = max(r.decode_pool.clock.now_s for r in live)
            if t_end not in self._scale_pending:
                self._scale_pending.add(t_end)
                self._push(t_end, PRIO_SCALE, "autoscale", None)
        return done

    def _run_decodes(self, live: List["Replica"]) -> Dict[str, List[Request]]:
        """Run one decode step on every live replica; homogeneous dense
        groups of >= fast_path_min pools sharing one params object go
        through fused dispatches."""
        finished_by: Dict[str, List[Request]] = {}
        groups: Dict[Tuple[Any, ...], List["Replica"]] = {}
        for r in live:
            dp = r.decode_pool
            sig = (dp.cfg.name, dp.params_token, dp.paged, dp.max_batch,
                   dp.max_seq_len)
            groups.setdefault(sig, []).append(r)
        for sig, rs in groups.items():
            if not sig[2] and len(rs) >= self.fast_path_min:
                finished_by.update(self._decode_fused(rs))
            else:
                for r in rs:
                    finished_by[r.name] = r.decode_pool.decode_once()
                    self.stats.serial_decode_calls += 1
        return finished_by

    @torch.inference_mode()
    def _decode_fused(self, reps: List["Replica"]) -> Dict[str, List[Request]]:
        """Fused steps over K homogeneous dense pools, in chunks of
        ``max_fused_group`` whose sizes bucket to powers of two (the
        padding is counted, never run). Each pool's sampling and
        accounting are byte for byte the per-pool path's — only the
        dispatch is shared: every member's step (a replay of its own graph
        on a card) and sampling are issued back to back, then
        ``batch_replicas`` (default) reads the chunk's tokens in one
        stacked transfer, and the tuple path (``batch_replicas=False``)
        reads each member's tokens on its own."""
        st = self.stats
        pools = [r.decode_pool for r in reps]
        pres = [p._decode_begin() for p in pools]
        finished: Dict[str, List[Request]] = {}
        for i in range(0, len(reps), self.max_fused_group):
            chunk_pools = pools[i:i + self.max_fused_group]
            chunk_pres = pres[i:i + self.max_fused_group]
            p2 = self._pow2(len(chunk_pools))
            t0 = time.perf_counter()
            toks = [p._sample(*p._run_decode_fn(), pre["temps"])
                    for p, pre in zip(chunk_pools, chunk_pres)]
            if self.batch_replicas:
                outs = list(torch.stack(toks).cpu().numpy())
                st.batched_decode_calls += 1
            else:
                outs = [t.cpu().numpy() for t in toks]
            if self.time_dispatch:              # the tokens are on the host by now
                ent = st.fused_decode_wall.setdefault(str(p2), [0, 0.0])
                ent[0] += 1
                ent[1] += time.perf_counter() - t0
            st.fused_decode_calls += 1
            st.pad_waste += p2 - len(chunk_pools)
            for r, p, pre, out in zip(reps[i:i + self.max_fused_group],
                                      chunk_pools, chunk_pres, outs):
                finished[r.name] = p._decode_finish(pre, out)
        return finished

    # ------------------------------------------------------ warm / autoscaler
    def _schedule_warm(self, r: "Replica"):
        key = (r.name, r._warming_until_s)
        if key not in self._warm_sched:
            self._warm_sched.add(key)
            self._push(r._warming_until_s, PRIO_WARM, "warm", r.name)

    def _handle_warm(self, r: "Replica", t: float):
        self._warm_sched.discard((r.name, t))
        if not r.powered or r._warming_until_s is None:
            return                          # powered down / already warm
        if t < r._warming_until_s - _EPS:
            self._schedule_warm(r)          # window moved; fire later
            return
        for p in r.pools().values():        # warm-up idle watts accrue
            self._catch_up(p, t)
        r._warming_until_s = None
        self.fleet._record_scale(t, "warm", r, "warm-up window elapsed")
        if self._admit_sched[r.name] == 0:
            self._admit(r, t, accrue=True)
            self._after_admit(r)

    def _handle_scale(self, t: float):
        fleet = self.fleet
        for r in fleet.replicas:            # queue ages measure against t
            r.advance_all(t)
        self._autoscale()
        if self._real > 0 or fleet.busy():
            self._push(t + self._tick_interval, PRIO_SCALE, "scale", None)

    def _autoscale(self):
        fleet = self.fleet
        fleet._autoscale()
        for r in fleet.replicas:
            if r.powered and r._warming_until_s is not None:
                self._schedule_warm(r)
