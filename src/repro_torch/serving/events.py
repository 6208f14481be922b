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
  time with the same model signature step in ONE fused dispatch; each pool
  still splits its own sampling key and keeps its own accounting, so
  token streams are independent of grouping.
* **Batched replica axis** (``batch_replicas``, default on). A fused group
  of K dense pools runs as ONE ``decode_step`` of batch ``p2 * B`` (p2 the
  power of two at or above K) over a ``CacheBank``
  (``repro_torch.serving.pool``): the members' caches stacked along the
  batch, whose rows the member pools hold as ``BankRow`` views between
  steps, so a stable group pays no restack and reads the weights once a
  step (the reference's ``vmap`` over replica-stacked caches with the
  params broadcast). On a card the bank's step is a CUDA graph of the
  bank's own, captured at its second step. Three ways in, as in the
  reference: *coherent* (every member views row j of one bank of size p2:
  no copy), *gather* (every member views some row of one bank: the rows
  are copied into another bank, ``bank_gathers``) and *rebuild* (rows on
  several banks or in the pools' own caches: copied in,
  ``bank_rebuilds``). A restack never writes a bank any pool still views;
  before a coherent step, a pool outside the group that still views one of
  the bank's pad rows with live slots copies its rows back into its own
  cache first (the reference's step writes over them). Each member samples
  its own slice of the logits, and the tokens come back in ONE stacked
  transfer. Admission prefill is batched the same way: one ``prefill`` of
  batch p over the group's stacked prompts (``batched_prefill_calls``),
  whose rows are handed over as batch-1 cache rows. The fold is bitwise
  equal to the member steps on the CPU, not on a card (the GEMMs run at
  another M); the batched prefill is not bitwise even on the CPU (logits
  within ~1e-6), so batched replays are held to equal tokens, not bits. A config with routed-MoE blocks runs the member steps even
  under ``batch_replicas``: the capacity dispatch would couple the rows of
  a folded batch, where the reference's ``vmap`` keeps one capacity per
  replica. ``batch_replicas=False`` is the tuple dispatch: each member's
  own step (its own graph on a card) and K batch-1 prefills, the
  reference's tuple-of-K baseline. ``batch_layout="shard_map"`` runs the
  bank too. In one process it is the whole bank, as the reference's
  ``shard_map`` over one device is its ``vmap``. Under a
  ``torch.distributed`` group of ``world > 1`` ranks (``process_group``,
  default the default group), every rank replays the same trace, and a
  bank whose p2 divides among the ranks is split over them
  (``pool.BankShards``): rank r holds and steps only members ``[r p2 /
  world, (r + 1) p2 / world)``, the local core of
  ``models.shard_map_replicas``, and samples those members with their own
  keys. Only the next tokens cross ranks on a coherent step (one
  all-gather); a gather or rebuild moves only the rows whose owner changes
  (point to point), and a pool that leaves its group takes its rows from
  the rank that holds them (a broadcast). The counters keep the
  reference's meaning on every rank.
* **Fused admission prefill.** Admission events that pop at the same
  instant defer their prefills; the engine groups them by (config,
  params, prompt bucket) and issues each group as one dispatch (batched as
  above, or K independent batch-1 prefills), then replays the per-request
  accounting (clock advance, gauge bracketing, ledger stamps, sampling
  order, modelled joules) in exactly the serial order.
  ``fuse_prefill=False`` is the serial baseline.
* **Fusion quantum.** ``fusion_quantum_s=q`` widens decode fusion from
  exact ties to consecutive decode events at the top of the heap inside
  ``[t, t+q)``; each pool still advances its own clock by its own step
  time, so token streams are invariant under any quantum. ``q=0`` is the
  exact-tie engine.

Event ordering at equal times is fixed by kind priority (warm-up
completions < arrivals < admissions < decode steps < autoscaler timers)
then by insertion sequence — the replay is a pure function of the trace.

Scale plumbing: arrivals enter the heap LAZILY (one in flight, so the heap
stays O(replicas)); fused group sizes bucket to powers of two (pad rows of
a bank run and are thrown away; a tuple dispatch counts its pads in
``pad_waste`` and runs none); the per-engine program cache is a capped
LRU (``fused_cache_cap``) over a process-wide one, whose bank sets (each
(signature, p2)'s banks with their graphs) fresh engines over the same
fleet shape reuse without capturing again, until
``pool.clear_program_caches()``; ``on_finish`` streams finished requests
(pair it with ``repro_torch.serving.pool.release_request`` for a
memory-flat replay); ``EngineStats`` counts events, dispatches, fusion
coverage and heap depth, and ``Fleet.last_engine_stats`` hands it to the
benchmarks.

``EngineStats`` has the reference's counters, equal on the same replay:
``fused_traces`` counts inserts into the per-engine cache under the
reference's keys, and ``pool_jit_dispatches`` counts each bank row copied
back into a pool's own cache as the reference counts its gathers.
``fused_decode_wall`` is wall seconds. ``Fleet.last_batched_calls`` adds,
per config, the replay's bank steps, their graph captures and replays and
the kernel launches the replays ran (a capture puts the wrappers' counts
back, as a pool's does), and its batched prefill calls with the requests
they served: what a count of kernel launches needs.

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
import functools
import heapq
import time
from collections import Counter, OrderedDict
from typing import (
    Any, Callable, Dict, List, Optional, Set, Tuple, TYPE_CHECKING,
)

import numpy as np
import torch

from repro_torch.serving.pool import (
    BankRow, BankShards, CacheBank, Pool, Request, cache_rows, observe_latencies, requeue_front,
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

# Process-wide fused programs, keyed on what they depend on: for a decode
# group the bank set of its (signature, p2) (the banks carry the graphs,
# which bind their trees, the params and their static inputs), for a
# batched prefill the eager call itself. The per-engine ``_fused_cache``
# keeps the reference's capped-LRU bookkeeping on top, so a benchmark that
# replays one fleet shape through several fresh engines captures each
# bank's graph once per process, not once per engine. Capped LRU; it holds
# the banks (and the weights their graphs bind) until evicted or
# ``pool.clear_program_caches()``.
_PROGRAM_CACHE_CAP = 128
_PROGRAM_CACHE: "OrderedDict[Tuple[Any, ...], Any]" = OrderedDict()


def _program(key: Tuple[Any, ...], make: Callable[[], Any]):
    fn = _PROGRAM_CACHE.get(key)
    if fn is None:
        fn = _PROGRAM_CACHE[key] = make()
        while len(_PROGRAM_CACHE) > _PROGRAM_CACHE_CAP:
            _PROGRAM_CACHE.popitem(last=False)
    else:
        _PROGRAM_CACHE.move_to_end(key)
    return fn


def _foldable(cfg) -> bool:
    """Whether a group's rows may share one batch: every kind but routed
    MoE, whose capacity dispatch ranks the tokens of the whole batch."""
    return not any("moe" in k for k in cfg.block_kinds_flat())


class _BankSet:
    """The banks of one (decode signature, p2), each with its own graph.
    ``acquire`` hands out a bank no pool views (so never one a pool
    outside the new group still reads) and drops the other free ones, or
    allocates a bank when none is free."""

    def __init__(self, pool: Pool, size: int, shards: Optional[BankShards] = None):
        self.make = functools.partial(
            CacheBank, pool.cfg, pool.params, size, pool.max_batch, pool.max_seq_len,
            device=pool.device, cuda_graphs=pool.cuda_graphs, shards=shards)
        self.banks: List[CacheBank] = []

    def acquire(self) -> CacheBank:
        free = [b for b in self.banks if not b.viewers]
        for extra in free[1:]:
            self.banks.remove(extra)
        if free:
            return free[0]
        self.banks.append(self.make())
        return self.banks[-1]


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
                                       # as ONE step over a bank (subset of
                                       # fused_decode_calls)
    batched_prefill_calls: int = 0     # ditto for fused admission prefill
    bank_gathers: int = 0              # churned groups re-stacked by a row
                                       # gather off ONE bank
    bank_rebuilds: int = 0             # batched groups re-stacked from
                                       # mixed banks / pools' own caches
    fused_traces: int = 0              # fused programs built (LRU inserts)
    pad_waste: int = 0                 # pow2 pad slots across fused calls
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
                 fused_cache_cap: int = 64,
                 batch_replicas: bool = True,
                 batch_layout: str = "vmap",
                 time_dispatch: bool = False,
                 on_finish: Optional[Callable[[Request], None]] = None,
                 process_group: Any = None):
        if not fleet.virtual:
            raise ValueError("the event engine needs VirtualClock replicas")
        if fusion_quantum_s < 0:
            raise ValueError("fusion_quantum_s must be >= 0")
        if max_fused_group < 1:
            raise ValueError("max_fused_group must be >= 1")
        if batch_layout not in BATCH_LAYOUTS:
            raise ValueError(f"batch_layout {batch_layout!r} not in "
                             f"{BATCH_LAYOUTS}")
        self.fleet = fleet
        self.fast_path_min = max(2, int(fast_path_min))
        self.fusion_quantum_s = float(fusion_quantum_s)
        self.fuse_prefill = bool(fuse_prefill)
        # pow2 so chunk sizes bucket onto themselves
        self.max_fused_group = 1 << (int(max_fused_group) - 1).bit_length()
        self.fused_cache_cap = max(4, int(fused_cache_cap))
        # batch_replicas=True (the default) steps each fused group as ONE
        # decode step over a replica bank; False is the tuple dispatch — the
        # serial-fused byte-identity baseline
        self.batch_replicas = bool(batch_replicas)
        self.batch_layout = batch_layout
        # the ranks a "shard_map" bank is split over: the process group's,
        # when torch.distributed runs more than one (every rank replays the
        # same trace); None steps every bank whole in this process
        self._group = process_group
        self._ranks: Optional[Tuple[int, int]] = None
        if batch_layout == "shard_map":
            import torch.distributed as dist

            if dist.is_available() and dist.is_initialized():
                world = dist.get_world_size(process_group)
                if world > 1:
                    self._ranks = (dist.get_rank(process_group), world)
        # member rows this rank received from another over the replay (a
        # restack or gather of a sharded bank moves only those)
        self.bank_rows_received = 0
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
        # capped LRU of fused programs, keyed (kind, sig, pow2 size, ...)
        self._fused_cache: "OrderedDict[Tuple[Any, ...], Any]" = OrderedDict()
        # per config name: bank steps, graph captures and replays, the
        # launches the replays ran, batched prefill calls and the requests
        # they served (``Fleet.last_batched_calls``)
        self._batched_calls: Dict[str, Dict[str, Any]] = {}
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

    def _fused_fn(self, key: Tuple[Any, ...], build: Callable[[], Any]):
        """Capped-LRU lookup of a fused program."""
        cache = self._fused_cache
        fn = cache.get(key)
        if fn is None:
            fn = cache[key] = build()
            self.stats.fused_traces += 1
            while len(cache) > self.fused_cache_cap:
                cache.popitem(last=False)
        else:
            cache.move_to_end(key)
        return fn

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
            fleet.last_batched_calls = self._batched_calls
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
                self._prefill_fused_chunk(sig, items[i:i + self.max_fused_group],
                                          results)
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
    def _prefill_fused_chunk(self, sig, items, results: Dict[int, Any]):
        """One fused prefill dispatch of K requests, pow2-padded to p.

        With ``batch_replicas`` ONE ``prefill`` of batch p over the stacked
        (p, bucket) prompts and true lengths, the pad rows repeating row 0
        (thrown away); each request's logits row and cache rows (views of
        the batch's cache) are handed over as a batch-1 result. Without it
        (or for a routed-MoE config, ``_foldable``) the K batch-1 prefills
        are issued back to back with no host read in between — the same
        computations as the serial ones; its pads are counted, not run."""
        st = self.stats
        k = len(items)
        p = self._pow2(k)
        pp0, toks0, len0, _, _ = items[0]
        # the reference's program-cache entry (``fused_traces`` counts it);
        # the port's program is the eager prefill itself
        fn = self._fused_fn(("prefill", sig, p), lambda: Pool.prefill_rows)
        if self.batch_replicas and _foldable(pp0.cfg):
            toks = np.concatenate([it[1] for it in items] + [toks0] * (p - k))
            lens = np.concatenate([it[2] for it in items] + [len0] * (p - k))
            logits, cache = fn(pp0, toks, lens)
            for i, it in enumerate(items):
                results[id(it[4])] = (logits[i:i + 1], cache_rows(cache, i, i + 1))
            st.batched_prefill_calls += 1
            ent = self._batched(pp0.cfg.name)
            ent["prefill_calls"] += 1
            ent["prefill_requests"] += k
        else:
            for pp, toks, true_len, _, entry in items:
                results[id(entry)] = fn(pp, toks, true_len)
        st.fused_prefill_calls += 1
        st.pad_waste += p - k

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
                finished_by.update(self._decode_fused(sig, rs))
            else:
                for r in rs:
                    finished_by[r.name] = r.decode_pool.decode_once()
                    self.stats.serial_decode_calls += 1
        return finished_by

    @torch.inference_mode()
    def _decode_fused(self, sig, reps: List["Replica"]) -> Dict[str, List[Request]]:
        """Fused steps over K homogeneous dense pools, in chunks of
        ``max_fused_group`` whose sizes bucket to powers of two. Each
        pool's sampling and accounting are byte for byte the per-pool
        path's — only the dispatch is shared. ``batch_replicas`` (default)
        runs each chunk as ONE step over a replica bank
        (``_decode_chunk_batched``); the tuple path
        (``batch_replicas=False``, and routed-MoE configs) issues each
        member's own step (``_decode_chunk_tuple``)."""
        st = self.stats
        pools = [r.decode_pool for r in reps]
        batched = self.batch_replicas and _foldable(pools[0].cfg)
        pres = [p._decode_begin(keep_view=batched) for p in pools]
        finished: Dict[str, List[Request]] = {}
        for i in range(0, len(reps), self.max_fused_group):
            chunk_pools = pools[i:i + self.max_fused_group]
            chunk_pres = pres[i:i + self.max_fused_group]
            t0 = time.perf_counter()
            if batched:
                outs, p2 = self._decode_chunk_batched(sig, chunk_pools, chunk_pres)
            else:
                outs, p2 = self._decode_chunk_tuple(sig, chunk_pools, chunk_pres)
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

    def _decode_chunk_tuple(self, sig, pools: List[Pool],
                            pres: List[dict]) -> Tuple[List[Any], int]:
        """The members' own steps (each a replay of its own graph on a
        card) issued back to back, each member's tokens read on its own."""
        p2 = self._pow2(len(pools))
        # the reference's program-cache entry; the program is each pool's step
        step = self._fused_fn(("decode", sig, p2), lambda: Pool._run_decode_fn)
        toks = [p._sample(*step(p), pre["temps"], pre["key"]) for p, pre in zip(pools, pres)]
        return [t.cpu().numpy() for t in toks], p2

    def _bank_coherent(self, pools: List[Pool], p2: int) -> Optional[CacheBank]:
        """The chunk's bank, if every member still views row j of ONE bank
        of exactly this pow2 size: last step's bank IS this step's input."""
        c0 = pools[0].cache
        if not isinstance(c0, BankRow) or c0.bank.size != p2 or c0.index != 0:
            return None
        bank = c0.bank
        for j, p in enumerate(pools[1:], start=1):
            c = p.cache
            if not isinstance(c, BankRow) or c.bank is not bank or c.index != j:
                return None
        return bank

    @staticmethod
    def _bank_rows_common(pools: List[Pool]):
        """(bank, row indices) if every member views SOME row of one common
        bank, in any order: the membership-churn shape."""
        c0 = pools[0].cache
        if not isinstance(c0, BankRow):
            return None
        bank = c0.bank
        idx = [c0.index]
        for p in pools[1:]:
            c = p.cache
            if not isinstance(c, BankRow) or c.bank is not bank:
                return None
            idx.append(c.index)
        return bank, idx

    def _shards(self, p2: int) -> Optional[BankShards]:
        """The split of a bank of p2 members over the ranks, as the
        reference's ``_batched_core`` lays ``shard_map`` over its devices:
        only where more than one rank runs and p2 divides among them."""
        if self._ranks is None or p2 % self._ranks[1]:
            return None
        return BankShards(self._group, *self._ranks)

    @staticmethod
    def _leaf_list(tree) -> List[torch.Tensor]:
        return [t for sc in tree["stages"] for blk in sc.values() for t in blk.values()]

    def _move_rows(self, dst: CacheBank, src, src_rows: List[int], dst_rows: List[int]):
        """Member rows ``src_rows`` of ``src`` (a ``CacheBank``, or one
        pool's own cache tree: member 0, which every rank holds) into member
        rows ``dst_rows`` of ``dst`` (each ``dst.batch`` rows of every
        leaf). A pair whose both ends this process holds is one gather and
        one scatter a leaf; on sharded banks a row whose owner changes moves
        once, point to point from the rank holding it to the rank that needs
        it, and nothing else crosses ranks."""
        import torch.distributed as dist

        b = dst.batch
        src_bank = src if isinstance(src, CacheBank) else None
        src_leaves = self._leaf_list(src.tree if src_bank is not None else src)
        dst_leaves = self._leaf_list(dst.tree)
        shards = dst.shards or (src_bank.shards if src_bank is not None else None)
        src_first = src_bank.first if src_bank is not None else 0
        src_split = src_bank is not None and src_bank.shards is not None

        def rows(members, first):
            return torch.tensor([(m - first) * b + s for m in members for s in range(b)],
                                dtype=torch.int64, device=dst.device)

        local: List[Tuple[int, int]] = []
        sends: Dict[int, List[Tuple[int, int]]] = {}
        recvs: Dict[int, List[Tuple[int, int]]] = {}
        for i, j in zip(src_rows, dst_rows):
            have = not src_split or src_bank.holds(i)
            if have and dst.holds(j):
                local.append((i, j))
            elif dst.holds(j):
                recvs.setdefault(src_bank.shards.owner(i, src_bank.size), []).append((i, j))
            if have and src_split:
                needers = ([dst.shards.owner(j, dst.size)] if dst.shards is not None
                           else range(shards.world))
                for r in needers:
                    if r != shards.rank:
                        sends.setdefault(r, []).append((i, j))
        if local:
            si = rows([i for i, _ in local], src_first)
            di = rows([j for _, j in local], dst.first)
            for st, dt_ in zip(src_leaves, dst_leaves):
                dt_.index_copy_(1, di, st.index_select(1, si))
        if not (sends or recvs):
            return
        ops, landed = [], []
        for r, pairs in sorted(sends.items()):
            si = rows([i for i, _ in pairs], src_first)
            for tag, st in enumerate(src_leaves):
                ops.append(dist.P2POp(dist.isend, st.index_select(1, si).contiguous(),
                                      shards.global_rank(r), shards.group, tag))
        for r, pairs in sorted(recvs.items()):
            di = rows([j for _, j in pairs], dst.first)
            for tag, dt_ in enumerate(dst_leaves):
                buf = dt_.new_empty((dt_.shape[0], len(di)) + tuple(dt_.shape[2:]))
                ops.append(dist.P2POp(dist.irecv, buf, shards.global_rank(r), shards.group, tag))
                landed.append((dt_, di, buf))
            self.bank_rows_received += len(pairs)
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        for dt_, di, buf in landed:
            dt_.index_copy_(1, di, buf)

    def _decode_chunk_batched(self, sig, pools: List[Pool],
                              pres: List[dict]) -> Tuple[List[Any], int]:
        """ONE decode step of batch ``p2 * B`` over a replica bank: member j
        at rows ``[j * B, (j + 1) * B)``, pad members (p2 - K of them) on
        the bank's own rows with member 0's tokens and lengths, their
        results thrown away.

        Coherent path — the members already view rows 0..K-1 of one bank of
        size p2: the step runs on it in place, so a stable group pays no
        restack; a pool outside the group that still views a pad row and
        holds live slots copies its rows back into its own cache first.
        Gather path — every member views some row of one bank: those rows
        are copied into a bank no pool views (``bank_gathers``), the source
        left as it is for the pools that left the group. Rebuild path —
        rows on several banks or in the pools' own caches: copied in the
        same way (``bank_rebuilds``), counting one dispatch per source bank
        on its first member, as the reference counts its row gathers.

        Each member samples its own logits slice with its own key and
        temperatures; the tokens come back in ONE stacked transfer, and
        every member's cache becomes a ``BankRow`` of the bank."""
        st = self.stats
        k = len(pools)
        p2 = self._pow2(k)
        pool0 = pools[0]

        shards = self._shards(p2)

        def bank_set():
            return _program(("bank", sig, p2, pool0.cuda_graphs, shards),
                            lambda: _BankSet(pool0, p2, shards))

        bank = self._bank_coherent(pools, p2)
        if bank is not None and bank.shards != shards:
            bank = None                     # another split: restack it below
        if bank is not None:
            self._fused_fn(("decode", sig, p2), bank_set)
            group = set(pools)
            # in row order: on a sharded bank every rank takes the same
            # broadcasts in the same order
            for p in sorted(bank.viewers, key=lambda v: v.cache.index):
                if p not in group and p.occupancy() > 0:
                    p.materialize_cache()
        elif (common := self._bank_rows_common(pools)) is not None:
            src, idx = common
            bank = self._fused_fn(("decode_gather", sig, p2, src.size), bank_set).acquire()
            self._move_rows(bank, src, idx, list(range(k)))
            st.bank_gathers += 1
        else:
            bank = self._fused_fn(("decode_restack", sig, p2), bank_set).acquire()
            sources: Dict[CacheBank, List[int]] = {}
            for j, p in enumerate(pools):
                c = p.cache
                if isinstance(c, BankRow):
                    sources.setdefault(c.bank, []).append(j)
                else:
                    self._move_rows(bank, c, [0], [j])
            for src, js in sources.items():
                pools[js[0]].jit_dispatches += 1
                self._move_rows(bank, src, [pools[j].cache.index for j in js], js)
            st.bank_rebuilds += 1
        pad = [pool0] * (p2 - k)
        replays = bank.graph_replays
        logits, greedy = bank.decode(
            np.concatenate([p._host_cur_token for p in pools + pad]),
            np.concatenate([p._host_lengths for p in pools + pad]))
        self._count_bank_step(bank, replays)
        b = pool0.max_batch
        # each member samples on the rank that holds its rows, with its own
        # key (every rank split every member's key: the host loops agree)
        own = lambda t, j: t[(j - bank.first) * b:(j - bank.first + 1) * b]
        toks = {j: p._sample(own(logits, j), own(greedy, j), pre["temps"], pre["key"])
                for j, (p, pre) in enumerate(zip(pools, pres)) if bank.holds(j)}
        for j, p in enumerate(pools):
            p.cache = BankRow(bank, j)
            p.bank_steps += 1
        st.batched_decode_calls += 1
        if bank.shards is None:
            return list(torch.stack([toks[j] for j in range(k)]).cpu().numpy()), p2
        # the host loop reads the next tokens alone (the lengths are its own
        # mirrors): one all-gather of (local, B) tokens, pad members' greedy
        import torch.distributed as dist

        mine = torch.stack([toks[j] if j in toks else own(greedy, j)
                            for j in range(bank.first, bank.first + bank.local)])
        parts = [torch.empty_like(mine) for _ in range(bank.shards.world)]
        dist.all_gather(parts, mine, group=bank.shards.group)
        return list(torch.cat(parts)[:k].cpu().numpy()), p2

    def _batched(self, cfg_name: str) -> Dict[str, Any]:
        return self._batched_calls.setdefault(cfg_name, {
            "decode_steps": 0, "captures": 0, "replays": 0, "replay_launches": Counter(),
            "prefill_calls": 0, "prefill_requests": 0})

    def _count_bank_step(self, bank: CacheBank, replays_before: int) -> None:
        ent = self._batched(bank.cfg.name)
        ent["decode_steps"] += 1
        if bank.graph_replays > replays_before:
            ent["replays"] += 1
            ent["captures"] += replays_before == 0
            ent["replay_launches"].update(bank.captured_launches)

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
