"""Fleet serving: N prefill/decode replicas behind a pluggable router.

The paper's per-architecture DVFS policy table becomes a *serving* lever at
fleet scale: with replicas of different architectures behind one router,
"send long-context traffic to the arch with the flattest energy curve" and
"power a replica down between bursts instead of underclocking all of them"
are schedulable decisions, not table rows. This module holds the two
runtime pieces of the spec-first fleet API (``repro_torch.serving.spec``):

* ``Replica`` — one prefill/decode pool pair with its own ``Scheduler``,
  waiting queue and ``ClockController`` (each replica walks its own SLO
  loop). This is exactly the machinery ``Cluster`` used to hard-wire; the
  cluster is now a thin single-replica facade over it. Replicas add the
  drain/power gating a fleet needs: ``drain()`` stops new placements while
  in-flight work finishes, ``power_down()`` zeroes the idle floor so a
  parked replica accrues NO joules (not even idle watts), ``power_up()``
  rejoins the routable set.
* ``Fleet`` — the replica set plus a ``Router`` (``repro_torch.serving.router``)
  and, optionally, an ``Autoscaler`` (``repro_torch.serving.autoscaler``) that
  the fleet ticks every barrier round: it drains replicas into diurnal
  valleys and powers them up ahead of peaks, with a modelled ``warmup_s``
  during which a powering-up replica draws idle watts but admits nothing.
  ``Fleet.run_trace`` subsumes ``Cluster.run_trace``: arrivals release as
  the serving clock crosses their stamps, the router picks each request's
  replica, and every busy replica takes one tick per round.

Timeline model: replicas are separate devices, and since the event-engine
refactor each POOL owns its timeline — ``Fleet.from_spec`` gives every
replica a decode ``VirtualClock`` and an independent prefill
``VirtualClock`` that meet only at migration (``place``). Two engines run
the same replicas:

* ``run_trace(engine="events")`` (default) — the discrete-event engine in
  ``repro_torch.serving.events``: arrivals, admissions, decode steps,
  warm-up completions and autoscaler evaluations pop from one per-fleet
  heap in virtual-time order, so admission prefills genuinely overlap
  concurrent decode and nothing waits for the slowest replica's round.
* ``step()`` / ``run_trace(engine="barrier")`` — the legacy lockstep
  engine: every busy replica takes one concurrent tick, the fleet syncs
  all pool clocks to the round maximum at a barrier (idle and faster
  replicas burn their gauge power across the lag, so a powered-up replica
  is never free — what makes power-down-vs-underclock an honest
  comparison), and WITHIN a replica admission serialises against decode
  (``Replica.sync_clocks``) — the conservative colocated-device view.

A fleet built around one shared clock (the single-replica ``Cluster``
facade) keeps both pools on one timeline; under the barrier engine that
degenerates to exactly the pre-fleet behaviour.

Counterpart of ``repro.serving.fleet``, the same code but in one place:
``Replica.from_spec`` draws random weights from a ``torch.Generator``
seeded with ``spec.rng_seed`` (other values than ``jax.random`` gives for
the same seed: carry weights across with ``params=`` / ``params_for=``). Replicas,
fleets and their builders take ``device=`` (default ``"cuda"``) for their
pools, and a ``Replica`` takes ``cuda_graphs=False`` to run its decode
step eagerly on a card.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Deque, Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np

from repro_torch.core.clock import VirtualClock
from repro_torch.core.traces import TracedRequest
from repro_torch.models.config import ModelConfig
from repro_torch.serving.autoscaler import Autoscaler, ScaleEvent, make_autoscaler
from repro_torch.serving.controller import ClockController
from repro_torch.serving.pool import (
    PhaseStats,
    Pool,
    PrefixStats,
    Request,
    acquire_request,
    head_validator,
    observe_latencies,
    popleft,
    requeue_front,
)
from repro_torch.serving.router import JoinShortestQueue, Router, make_router
from repro_torch.serving.spec import FleetSpec, ReplicaSpec


class Scheduler:
    """Chunked-prefill admission with a per-tick prefill token budget.

    Credits accrue ``chunk_tokens`` per tick while requests wait AND a
    decode slot is free, capped at ``max(chunk_tokens, head prompt
    length)``; a request is admitted (prefilled + migrated) only once
    accrued credit covers its prompt. Long prompts therefore spread their
    prefill admission over several decode ticks — the Sarathi-style
    interleaving knob — while the queue is drained in FIFO order (several
    small requests can admit in one tick as long as they fit the chunk
    budget). The cap plus the reset on an empty queue mean neither an idle
    cluster nor a full decode pool can bank credit that would later
    release one giant prefill burst.
    """

    def __init__(self, chunk_tokens: int = 256):
        if chunk_tokens < 1:
            raise ValueError("chunk_tokens must be >= 1")
        self.chunk_tokens = chunk_tokens
        self.migrations = 0
        self._credit = 0.0

    def tick(
        self,
        waiting: List[Request],
        prefill_pool: Pool,
        decode_pool: Pool,
        *,
        admit: Optional[Callable[[Request], None]] = None,
        gate: Optional[Callable[[Request], bool]] = None,
        accrue: bool = True,
    ) -> List[Request]:
        """One admission tick. The three keyword hooks exist for the event
        engine: ``admit`` replaces the default prefill-then-place handoff
        (the engine defers placement until the decode timeline reaches the
        prefill's completion), ``gate`` replaces ``decode_pool.can_admit``
        (the engine must also count placements still in flight), and
        ``accrue=False`` spends existing credit without banking more (the
        engine calls extra ticks at arrival events; credit still accrues
        once per decode step, the barrier's cadence)."""
        if not waiting:
            self._credit = 0.0
            return []
        if gate is None:
            gate = decode_pool.can_admit
        if admit is None:
            def admit(req: Request) -> None:
                # prefix sharing: pin any shared-prefix hit on the decode
                # pool first, prefill only the un-shared suffix (gathered
                # from the donor's pages), and place with the shared table
                # entries. With sharing off the hit is None and this is the
                # legacy handoff, byte for byte.
                hit = decode_pool.prefix_acquire(req)
                first, cache1 = prefill_pool.prefill_request(
                    req, shared=hit, donor=decode_pool)
                decode_pool.place(
                    req, cache1, first, len(req.prompt), shared=hit,
                    # with split pool clocks the first token exists when the
                    # PREFILL timeline produced it; on a shared clock this
                    # is exactly the legacy stamp
                    first_token_s=(prefill_pool.clock()
                                   if prefill_pool.virtual else None))
        validated_head = head_validator(waiting, decode_pool)
        # fail fast even when admission is impossible this tick
        head = validated_head()
        if gate(head) and accrue:
            # accrue only while admission is possible, capped at
            # max(chunk, head need) — a full decode pool must not bank
            # credit that later releases one giant prefill burst.
            # can_admit is the continuous-batching gate: on a paged pool it
            # asks the block allocator, not a fixed slot count.
            self._credit = min(
                self._credit + self.chunk_tokens,
                max(float(self.chunk_tokens),
                    float(decode_pool.prefill_cost_tokens(head))),
            )
        admitted: List[Request] = []
        while waiting and gate(waiting[0]):
            req = validated_head()
            # charge the tokens prefill will actually compute — the suffix
            # only, under a prefix hit (identical to len(prompt) otherwise)
            need = decode_pool.prefill_cost_tokens(req)
            if need > self._credit:
                break
            popleft(waiting)
            self._credit -= need
            admit(req)
            self.migrations += 1
            admitted.append(req)
        return admitted


class Replica:
    """One disaggregated prefill/decode pair: a fleet's unit of placement."""

    def __init__(
        self,
        cfg: ModelConfig,
        params: Any,
        *,
        name: str = "replica0",
        controller: Optional[ClockController] = None,
        prefill_batch: int = 1,
        decode_batch: int = 8,
        max_seq_len: int = 4096,
        prefill_chunk_tokens: int = 256,
        rng_seed: int = 0,
        clock: Callable[[], float] = time.perf_counter,
        prefill_clock: Optional[Callable[[], float]] = None,
        meter_interval_s: float = 0.050,
        paged: bool = False,
        kv_block_size: int = 16,
        kv_blocks: Optional[int] = None,
        prefix_sharing: bool = False,
        device="cuda",
        cuda_graphs: bool = True,
    ):
        self.cfg = cfg
        self.name = name
        self.arch = cfg.name
        # per-pool timelines: ``clock`` is the decode pool's (and the
        # replica's reference clock); ``prefill_clock`` defaults to the same
        # object — the legacy colocated-device view where admission prefills
        # serialise against decode. Pass a second VirtualClock to give the
        # prefill pool an independent timeline (the event engine's overlap).
        self.prefill_clock = prefill_clock if prefill_clock is not None else clock
        if isinstance(self.prefill_clock, VirtualClock) != isinstance(clock, VirtualClock):
            raise ValueError(
                "replica pool clocks must be both virtual or both wall")
        self.prefill_pool = Pool(
            cfg, params, role="prefill", max_batch=max(1, prefill_batch),
            max_seq_len=max_seq_len, rng_seed=rng_seed,
            clock=self.prefill_clock,
            meter_interval_s=meter_interval_s, device=device,
        )
        # only the decode pool pages its cache: prefill is batch-1 scratch
        # whose row is handed off (copy-on-migrate) at admission
        self.decode_pool = Pool(
            cfg, params, role="decode", max_batch=decode_batch,
            max_seq_len=max_seq_len, rng_seed=rng_seed, clock=clock,
            meter_interval_s=meter_interval_s,
            paged=paged, kv_block_size=kv_block_size, kv_blocks=kv_blocks,
            prefix_sharing=prefix_sharing, device=device, cuda_graphs=cuda_graphs,
        )
        self.controller = controller
        self.scheduler = Scheduler(prefill_chunk_tokens)
        self.clock = clock
        self.virtual = isinstance(clock, VirtualClock)
        # deque: admission pops the head per request — O(1) instead of the
        # list's O(n) shuffle, which at 10^6 queued requests is the
        # difference between a replay and a quadratic stall
        self.waiting: Deque[Request] = deque()
        self.draining = False
        self.powered = True
        # warm-up window end (fleet clock): set by power_up(warmup_s=...);
        # while the clock is inside it the replica draws idle-floor watts
        # but admits nothing — the autoscaler's modelled power-up cost
        self._warming_until_s: Optional[float] = None
        # (admit time, queue delay) of recent admissions — the rolling
        # queue-delay signal the queue autoscaler evaluates
        self.admit_log: Deque[Tuple[float, float]] = deque(maxlen=4096)
        self._uid = 0
        self._step_no = 0
        if controller is not None:
            # a powered-up replica is never free: prime the idle floor so
            # intervals before the first controller tick (and replicas the
            # router never touches) still burn idle watts
            for pool in self.pools().values():
                pool.set_idle_power(controller.emodel.spec.p_idle)

    # -------------------------------------------------------------- builders
    @classmethod
    def from_spec(
        cls,
        spec: ReplicaSpec,
        *,
        emodel=None,
        clock: Callable[[], float] = time.perf_counter,
        prefill_clock: Optional[Callable[[], float]] = None,
        params: Any = None,
        meter_interval_s: float = 0.050,
        device="cuda",
        cfg: Any = None,
    ) -> "Replica":
        """Build a live replica from a declarative spec. ``params`` may be
        shared across replicas of the same arch; when omitted they are
        initialised from ``spec.rng_seed`` through a ``torch.Generator`` on
        ``device`` (other values than the reference's ``jax.random`` init).
        The controller's policy table always resolves the FULL config;
        ``spec.reduced`` only picks the config the pools execute, and
        ``cfg`` overrides that pick (another dtype of the same model)."""
        import torch

        from repro_torch.configs import get_config, reduced_config
        from repro_torch.core.energy import EnergyModel
        from repro_torch.device import resolve_device
        from repro_torch.hw import H200_SXM
        from repro_torch.models import init_params

        emodel = emodel if emodel is not None else EnergyModel(H200_SXM)
        full = get_config(spec.arch)
        if cfg is None:
            cfg = reduced_config(spec.arch) if spec.reduced else full
        if params is None:
            dev = resolve_device(device)
            params = init_params(cfg, torch.Generator(dev).manual_seed(spec.rng_seed),
                                 device=dev)
        controller = ClockController(emodel, full, **spec.clock.controller_kwargs())
        return cls(
            cfg, params,
            name=spec.name,
            controller=controller,
            prefill_batch=spec.prefill.batch,
            decode_batch=spec.decode.batch,
            max_seq_len=spec.max_seq_len,
            prefill_chunk_tokens=spec.prefill_chunk_tokens,
            rng_seed=spec.rng_seed,
            clock=clock,
            prefill_clock=prefill_clock,
            meter_interval_s=meter_interval_s,
            paged=spec.decode.paged,
            kv_block_size=spec.decode.kv_block_size,
            kv_blocks=spec.decode.kv_blocks,
            prefix_sharing=spec.decode.prefix_sharing,
            device=device,
        )

    # ------------------------------------------------------------------ api
    def submit(
        self,
        prompt: np.ndarray,
        max_new_tokens: int = 32,
        *,
        temperature: float = 0.0,
        eos_token_id: Optional[int] = None,
        arrival_s: Optional[float] = None,
        bucket: str = "mixed",
    ) -> Request:
        """Queue a request. ``arrival_s`` overrides the arrival stamp (the
        trace replay passes the trace's own timestamp so queueing delay that
        happened *during* a long step is still charged to TTFT)."""
        req = acquire_request(self._uid, np.asarray(prompt, np.int32),
                              max_new_tokens=max_new_tokens,
                              temperature=temperature,
                              eos_token_id=eos_token_id,
                              bucket=bucket, replica=self.name)
        req.ledger.mark_arrival(self.clock() if arrival_s is None else arrival_s)
        self._uid += 1
        self.waiting.append(req)
        return req

    def pools(self) -> Dict[str, Pool]:
        return {"prefill": self.prefill_pool, "decode": self.decode_pool}

    def sync_clocks(self):
        """Pull this replica's pool clocks to their shared maximum, sampling
        each laggard so the wait integrates at its gauge power. A no-op when
        both pools share one clock (the legacy Cluster arrangement) or on
        wall clocks — the barrier engine calls this to keep its serialised
        within-replica semantics under split pool clocks."""
        if not self.virtual:
            return
        t = max(p.clock.now_s for p in self.pools().values())
        for p in self.pools().values():
            if p.clock.now_s < t:
                p.clock.advance_to(t)
                p.sample_now()

    def max_clock_s(self) -> float:
        """The furthest-ahead pool timeline on this replica."""
        if not self.virtual:
            return self.clock()
        return max(p.clock.now_s for p in self.pools().values())

    def advance_all(self, t1: float):
        """Advance every lagging pool clock to ``t1`` and (if any moved)
        sample both pools — the barrier's round sync, per replica."""
        if not self.virtual:
            return
        moved = False
        for p in self.pools().values():
            if p.clock.now_s < t1:
                p.clock.advance_to(t1)
                moved = True
        if moved:
            self.sample_pools()

    def step(self) -> List[Request]:
        """One replica tick: retune clocks, admit/migrate, decode. This is
        the BARRIER engine's body: admission prefills serialise against the
        decode step on one timeline (``sync_clocks`` after admission), the
        legacy colocated-device view. The event engine overlaps the two
        timelines instead — see ``repro_torch.serving.events``."""
        self._step_no += 1
        self.sync_clocks()
        if self.warming():
            # inside the warm-up window: idle-floor watts accrue (the
            # barrier samples this replica's pools) but nothing admits —
            # queued work waits until the fleet marks the replica warm
            return []
        if self.controller is not None:
            self.controller.tick(self.pools(), self._step_no)
        admitted = self.scheduler.tick(self.waiting, self.prefill_pool, self.decode_pool)
        for req in admitted:
            self.admit_log.append((req.ledger.admitted_s, req.ledger.queue_s))
        if self.controller is not None and admitted:
            # admission changed decode occupancy: re-resolve so this step's
            # tokens are priced at the true post-admission operating point
            self.controller.tick(self.pools(), self._step_no)
        # under split pool clocks the prefill timeline ran ahead: the
        # barrier's decode step starts only after admission completes
        self.sync_clocks()
        finished = self.decode_pool.decode_once()
        if self.controller is not None:
            observe_latencies(self.controller, self.decode_pool, admitted, finished)
        # preempted requests go back to the queue head: they are the oldest
        # work in flight, and FIFO admission re-prefills them first
        requeue_front(self.waiting, self.decode_pool.take_evicted())
        return finished

    def busy(self) -> bool:
        return bool(self.waiting) or self.decode_pool.occupancy() > 0

    def queue_depth(self) -> int:
        """Waiting + in-flight work: the router's load signal."""
        return len(self.waiting) + self.decode_pool.occupancy()

    def run_to_completion(self, max_steps: int = 100000) -> List[Request]:
        done: List[Request] = []
        steps = 0
        self.start_metering()
        try:
            while self.busy() and steps < max_steps:
                done.extend(self.step())
                steps += 1
        finally:
            self.stop_metering()
        return done

    # ------------------------------------------------- drain / power gating
    def routable(self) -> bool:
        """May the router place NEW work here? Warming replicas stay
        routable — queued work simply waits out the warm-up — but every
        router prefers warm replicas while any exists."""
        return self.powered and not self.draining

    def warming(self) -> bool:
        """Inside the modelled warm-up window: powered (idle-floor watts
        accrue) but admitting nothing until the window elapses."""
        return (self.powered and self._warming_until_s is not None
                and self.clock() < self._warming_until_s - 1e-12)

    def drain(self):
        """Stop accepting new placements; in-flight work keeps serving.
        The fleet powers a drained replica down once it runs dry — an
        already-idle replica parks immediately (no idle-floor accrual
        between the drain decision and the next round)."""
        self.draining = True
        if self.powered and not self.busy():
            self.power_down()

    def power_down(self):
        """Park an idle replica at zero watts: no operating point, no idle
        floor — the ``drain -> power down`` alternative to underclocking.
        Refuses while work is queued or in flight (drain first)."""
        if self.busy():
            raise RuntimeError(
                f"power_down on busy replica {self.name!r} — drain it first")
        self.powered = False
        self._warming_until_s = None
        for pool in self.pools().values():
            pool.set_idle_power(0.0)

    def power_up(self, warmup_s: float = 0.0):
        """Rejoin the routable set; the idle floor is restored immediately
        (power-up is never free, even before work arrives). A non-zero
        ``warmup_s`` models the power-up cost: the replica draws idle-floor
        watts for that long while admitting nothing (``warming()``)."""
        self.powered = True
        self.draining = False
        self._warming_until_s = (
            self.clock() + warmup_s if warmup_s > 0 else None)
        if self.controller is not None:
            for pool in self.pools().values():
                pool.set_idle_power(self.controller.emodel.spec.p_idle)

    # ------------------------------------------------------------- metering
    def start_metering(self):
        for pool in self.pools().values():
            pool.start_metering()

    def stop_metering(self) -> Dict[str, float]:
        """Stop both samplers; return cumulative joules per pool."""
        return {name: p.stop_metering() for name, p in self.pools().items()}

    def measured_energy_j(self) -> Dict[str, float]:
        """Cumulative per-pool joules across all runs — same lifetime scope
        as ``stats``, so measured and modelled energy stay comparable even
        when the replica is run in several batches."""
        return {name: p.measured_energy_j() for name, p in self.pools().items()}

    def sample_pools(self):
        """Record a synchronous power sample on both pools at the current
        clock (the fleet calls this after advancing across idle gaps)."""
        for pool in self.pools().values():
            pool.sample_now()

    # ----------------------------------------------------------------- stats
    @property
    def prefill_stats(self) -> PhaseStats:
        return self.prefill_pool.stats

    @property
    def decode_stats(self) -> PhaseStats:
        return self.decode_pool.stats

    @property
    def stats(self) -> PhaseStats:
        """Replica-wide phase totals (clock fields are the decode pool's —
        the phase the paper's capping claim is about)."""
        return self.decode_pool.stats.merged_with(self.prefill_pool.stats)


class Fleet:
    """N replicas sharing one serving clock, behind a routing policy."""

    def __init__(
        self,
        replicas: Iterable[Replica],
        *,
        router: Optional[Router] = None,
        autoscaler: Optional[Autoscaler] = None,
        engine_opts: Optional[Dict[str, Any]] = None,
    ):
        self.replicas: List[Replica] = list(replicas)
        # default EventDrivenFleet options for run_trace(engine="events");
        # per-call engine_opts override key-by-key (FleetSpec.engine_opts
        # lands here via from_spec, so a spec pins its replay mode)
        self.engine_opts: Dict[str, Any] = dict(engine_opts or {})
        if not self.replicas:
            raise ValueError("a Fleet needs at least one replica")
        # the last event-engine replay's EngineStats counter block (None
        # until run_trace(engine="events") completes) — what the serving
        # benchmarks write into their JSON artifacts
        self.last_engine_stats = None
        # and its batched calls (bank steps, prefills) per config
        self.last_batched_calls = None
        names = [r.name for r in self.replicas]
        if len(set(names)) != len(names):
            raise ValueError(f"replica names must be unique, got {names}")
        virtuals = {r.virtual for r in self.replicas}
        if len(virtuals) != 1:
            raise ValueError("fleet replicas must be all-virtual or all-wall")
        self.virtual = virtuals.pop()
        # Clock-sharing audit, by LIVE identity (``is`` over objects we hold
        # strong references to — never ``id()``, whose values outlive their
        # object and can be recycled by the allocator onto a different
        # clock): collect the distinct clock objects and which replicas use
        # each.
        clock_owners: List[Tuple[Any, set]] = []
        for ri, r in enumerate(self.replicas):
            for c in (r.clock, r.prefill_clock):
                for ent in clock_owners:
                    if ent[0] is c:
                        ent[1].add(ri)
                        break
                else:
                    clock_owners.append((c, {ri}))
        if not self.virtual:
            # wall-clock replicas tick on real time; only one process clock
            # keeps their ledgers on one timeline
            if len(clock_owners) != 1:
                raise ValueError("wall-clock fleet replicas must share one clock")
        elif len(clock_owners) != 1:
            # virtual replicas either share ONE clock fleet-wide (the
            # single-replica Cluster facade: ticks serialise, exactly the
            # pre-fleet behaviour) or keep their clocks private to a replica
            # (per-replica or split prefill/decode timelines — what the
            # event engine schedules against). A VirtualClock shared by SOME
            # replicas but not all would let one replica's steps silently
            # advance another's timeline mid-replay, corrupting both the
            # barrier rounds and the event heap's stamps — reject it.
            shared = sorted(ri for c, owners in clock_owners
                            if len(owners) > 1 for ri in owners)
            if shared:
                names = [self.replicas[ri].name for ri in shared]
                raise ValueError(
                    f"virtual fleet clocks partially shared across replicas "
                    f"{names}: share ONE clock fleet-wide or give each "
                    f"replica its own clocks")
        self.clock = self.replicas[0].clock
        self.router: Router = router if router is not None else JoinShortestQueue()
        self.by_name: Dict[str, Replica] = {r.name: r for r in self.replicas}
        # ---- autoscaling: scale ledger + the policy, ticked per round ----
        self.autoscaler = autoscaler
        self.scale_events: List[ScaleEvent] = []
        self.arrivals_total = 0          # the schedule policy's rate signal
        self._round = 0
        if autoscaler is not None:
            # the fleet starts at the policy floor: replicas beyond
            # min_replicas park immediately (zero joules until powered up)
            for r in self.replicas[max(1, autoscaler.min_replicas):]:
                if not r.busy():
                    r.drain()            # idle at build time -> parks now
                    self._record_scale(self.now_s(), "park", r,
                                       "fleet starts at min_replicas")

    # -------------------------------------------------------------- builder
    @classmethod
    def from_spec(
        cls,
        spec: FleetSpec,
        *,
        emodel=None,
        clock: Optional[Callable[[], float]] = None,
        params_for: Optional[Mapping[str, Any]] = None,
        meter_interval_s: float = 0.050,
        device="cuda",
        configs: Optional[Mapping[str, Any]] = None,
    ) -> "Fleet":
        """Build N live replicas + the router from a declarative spec.

        ``clock`` defaults to a fresh ``VirtualClock`` (the fleet harness is
        trace-replay-first); ``params_for`` maps arch name -> params so
        same-arch replicas (and repeated builds in a benchmark) can share
        one initialisation instead of paying it per replica. ``device`` goes
        to every replica's pools; ``configs`` maps arch name -> the config
        its pools run, where it is not the spec's pick (``Replica.from_spec``).
        """
        if clock is None:
            # TWO VirtualClocks per replica — decode and prefill are
            # separate timelines (separate devices, and within a replica
            # the pools only meet at migration): the event engine overlaps
            # them, the barrier engine re-serialises via sync_clocks
            clock_pairs: List[Tuple[Callable[[], float], Callable[[], float]]] = [
                (VirtualClock(), VirtualClock()) for _ in spec.replicas]
        else:
            clock_pairs = [(clock, clock)] * len(spec.replicas)
        params_for = params_for or {}
        configs = configs or {}
        replicas = [
            Replica.from_spec(
                rs, emodel=emodel, clock=c, prefill_clock=pc,
                params=params_for.get(rs.arch),
                meter_interval_s=meter_interval_s,
                device=device, cfg=configs.get(rs.arch),
            )
            for rs, (c, pc) in zip(spec.replicas, clock_pairs)
        ]
        return cls(
            replicas,
            router=make_router(spec.router, **spec.router_args),
            autoscaler=(make_autoscaler(spec.autoscaler)
                        if spec.autoscaler is not None else None),
            engine_opts=spec.engine_opts,
        )

    # ------------------------------------------------------------------ api
    def route(self, *, prompt_len: int, max_new_tokens: int,
              bucket: str = "mixed",
              prompt: Optional[np.ndarray] = None) -> Replica:
        """Ask the router for this request's replica (routable ones only;
        with everything drained, powered-up replicas are the fallback).
        ``prompt`` carries the token ids for content-aware policies (the
        prefix router scores candidates by shared-prefix coverage)."""
        candidates = [r for r in self.replicas if r.routable()]
        if not candidates:
            candidates = [r for r in self.replicas if r.powered]
        if not candidates:
            raise RuntimeError("no powered replica to route to — power_up first")
        return self.router.route(candidates, prompt_len=prompt_len,
                                 max_new_tokens=max_new_tokens, bucket=bucket,
                                 prompt=prompt)

    def submit(
        self,
        prompt: np.ndarray,
        max_new_tokens: int = 32,
        *,
        temperature: float = 0.0,
        eos_token_id: Optional[int] = None,
        arrival_s: Optional[float] = None,
        bucket: str = "mixed",
    ) -> Request:
        """Route + queue one request; returns the stamped ``Request``
        (its ``replica`` field records the placement)."""
        prompt = np.asarray(prompt, np.int32)
        self.arrivals_total += 1
        replica = self.route(prompt_len=len(prompt),
                             max_new_tokens=max_new_tokens, bucket=bucket,
                             prompt=prompt)
        return replica.submit(prompt, max_new_tokens, temperature=temperature,
                              eos_token_id=eos_token_id, arrival_s=arrival_s,
                              bucket=bucket)

    def busy(self) -> bool:
        return any(r.busy() for r in self.replicas)

    def now_s(self) -> float:
        """The fleet timeline's current time. Replica clocks agree at round
        barriers; between them the furthest-ahead pool defines "now"."""
        if self.virtual:
            return max(r.max_clock_s() for r in self.replicas)
        return self.clock()

    def _sync_round(self):
        """Barrier: pull every lagging pool clock up to the round's
        maximum, sampling its pools so the lag integrates at gauge power —
        op power while slots are live, the idle floor (or a powered-down
        replica's zero watts) otherwise. With one shared clock this is a
        no-op and ticks stay serialised (the Cluster facade's behaviour)."""
        if not self.virtual:
            return
        t1 = max(r.max_clock_s() for r in self.replicas)
        for r in self.replicas:
            r.advance_all(t1)

    def step(self) -> List[Request]:
        """One fleet round — the single definition of round semantics, also
        the body of ``run_trace``/``run_to_completion``: every busy replica
        takes one concurrent tick (each on its own clock), the barrier
        re-syncs the timeline, drained replicas that ran dry power off,
        then the autoscaler (if any) takes its scale decision."""
        finished: List[Request] = []
        t_before = self.now_s() if self.virtual else 0.0
        for r in self.replicas:
            if r.busy():
                finished.extend(r.step())
        self._sync_round()
        if self.virtual and self.now_s() == t_before:
            # every busy replica sat inside its warm-up window, so nothing
            # modelled a duration this round: jump to the earliest warm-up
            # completion (sampling idle watts across it) or the fleet would
            # spin at a frozen clock
            ends = [r._warming_until_s for r in self.replicas
                    if r.busy() and r.warming()]
            if ends:
                t1 = min(ends)
                for r in self.replicas:
                    r.advance_all(t1)
        self._power_down_drained()
        self._autoscale()
        return finished

    def drain(self, name: str):
        """Operator-driven drain — audited exactly like an autoscaler
        decision (``scale_events`` + the controller's Transition trail),
        with policy ``"manual"``."""
        r = self.by_name[name]
        was_powered = r.powered
        r.drain()
        now = self.now_s()
        self._record_scale(now, "drain", r, "operator drain", policy="manual")
        if was_powered and not r.powered:
            self._record_scale(now, "power_down", r, "drained dry",
                               policy="manual")

    def power_up(self, name: str, warmup_s: float = 0.0):
        """Operator-driven power-up/reclaim — audited with policy
        ``"manual"`` (a powered replica still draining rejoins as a
        ``reclaim``, matching the autoscaler's vocabulary)."""
        r = self.by_name[name]
        action = "reclaim" if (r.powered and r.draining) else "power_up"
        r.power_up(warmup_s=warmup_s)
        self._record_scale(self.now_s(), action, r, "operator power_up",
                           policy="manual", configured=warmup_s)

    def _power_down_drained(self):
        for r in self.replicas:
            if r.draining and r.powered and not r.busy():
                r.power_down()
                self._record_scale(self.now_s(), "power_down", r,
                                   "drained dry")

    # --------------------------------------------------------- autoscaling
    def n_active(self) -> int:
        """Replicas carrying or accepting load: powered, not draining
        (warming ones count — their capacity is already committed)."""
        return sum(r.powered and not r.draining for r in self.replicas)

    def n_warming(self) -> int:
        return sum(r.warming() for r in self.replicas)

    def n_parked(self) -> int:
        return sum(not r.powered for r in self.replicas)

    def has_scale_up_target(self) -> bool:
        """Is there a replica a scale-up could add? Either a parked one
        (full power-up + warm-up) or a powered one still draining (a
        reclaim: cancel the drain, rejoin warm, zero warm-up cost)."""
        return any(not r.powered or r.draining for r in self.replicas)

    def queue_delay_samples(self, now_s: float, window_s: float,
                            since_s: float = float("-inf")) -> List[float]:
        """The rolling queue-delay population the queue policy evaluates:
        delays of requests admitted inside the window (and after
        ``since_s``), plus the live age of every still-waiting request —
        so a backlog is visible *before* anything gets admitted."""
        cut = max(now_s - window_s, since_s)
        xs: List[float] = []
        for r in self.replicas:
            xs.extend(q for t, q in r.admit_log
                      if t >= cut and q is not None)
            # live waiting ages measure from max(arrival, since_s): queueing
            # that predates a scale-up's evidence reset saw the OLD capacity
            # and must not re-trigger the next scale-up the instant the
            # warm-up window elapses (the cascade bug) — only the age the
            # backlog has accrued SINCE the reset is admissible evidence
            xs.extend(max(0.0, now_s - max(req.ledger.arrival_s, since_s))
                      for req in r.waiting
                      if req.ledger.arrival_s is not None)
        return xs

    def _record_scale(self, now_s: float, action: str, replica: Replica,
                      reason: str, *, policy: Optional[str] = None,
                      configured: Optional[float] = None):
        """Append to the scale ledger and the replica controller's
        Transition trail. ``policy`` overrides the attributed policy name
        (``"manual"`` for operator-driven changes on an autoscaled fleet);
        ``configured`` overrides the warm-up seconds attributed to a
        power-up (default: the autoscaler's, 0 otherwise)."""
        if configured is None:
            configured = (self.autoscaler.warmup_s
                          if self.autoscaler is not None and policy is None
                          and action == "power_up" else 0.0)
        if policy is None:
            policy = (self.autoscaler.name if self.autoscaler is not None
                      else "manual")
        self.scale_events.append(ScaleEvent(
            t_s=now_s, action=action, replica=replica.name,
            policy=policy, reason=reason))
        if replica.controller is not None:
            replica.controller.note_scale_event(
                self._round, action, configured=configured)

    def _pick_power_up(self) -> Optional[Replica]:
        """The cheapest capacity to add, deterministically: a powered
        replica still draining rejoins warm for free (reclaim — it never
        powered down, so a burst arriving mid-drain must not pay
        drain-dry + a full warm-up), else the first parked replica in
        fleet order."""
        if (self.autoscaler is not None
                and self.n_active() >= self.autoscaler.max_replicas(self)):
            return None
        for r in self.replicas:
            if r.powered and r.draining:
                return r
        for r in self.replicas:
            if not r.powered:
                return r
        return None

    def _pick_drain(self) -> Optional[Replica]:
        """The cheapest replica to give up: a still-warming one first
        (nothing invested beyond its warm-up watts), then the lightest
        queue, ties broken toward the highest fleet index so the head of
        the fleet stays the sticky base."""
        floor = max(1, self.autoscaler.min_replicas) if self.autoscaler else 1
        cands = [(i, r) for i, r in enumerate(self.replicas)
                 if r.powered and not r.draining]
        if len(cands) <= floor:
            return None
        return min(cands, key=lambda ir: (
            not ir[1].warming(), ir[1].queue_depth(), -ir[0]))[1]

    def _autoscale(self):
        """One autoscaler round: finish elapsed warm-ups, then apply the
        policy's decision (at most one replica moves per round). Every
        state change lands in ``scale_events`` and as a ``Transition`` on
        the replica's controller — warm-up joules are attributed, not
        free."""
        if self.autoscaler is None:
            return
        self._round += 1
        now = self.now_s()
        for r in self.replicas:
            if (r.powered and r._warming_until_s is not None
                    and not r.warming()):
                r._warming_until_s = None
                self._record_scale(now, "warm", r, "warm-up window elapsed")
        decision = self.autoscaler.tick(self, now)
        if decision is None:
            return
        kind, reason = decision
        if kind == "up":
            r = self._pick_power_up()
            if r is not None:
                if r.powered:           # reclaim a drain-in-progress: warm,
                    r.power_up()        # routable now, no warm-up window
                    self._record_scale(now, "reclaim", r, reason)
                else:
                    r.power_up(warmup_s=self.autoscaler.warmup_s)
                    self._record_scale(now, "power_up", r, reason)
        elif kind == "down":
            r = self._pick_drain()
            if r is not None:
                r.drain()
                self._record_scale(now, "drain", r, reason)
                if not r.powered:       # was idle: parked immediately
                    self._record_scale(now, "power_down", r, "drained dry")

    # -------------------------------------------------------- trace replay
    def _advance_idle(self, dt_s: float):
        """Cross an idle gap between trace arrivals. Virtual: jump every
        replica clock to the gap's end and sample its pools so idle-floor
        joules accrue over the gap (zero on powered-down replicas); wall:
        actually wait it out."""
        if dt_s <= 0:
            return
        if self.virtual:
            target = self.now_s() + dt_s
            for r in self.replicas:
                for p in r.pools().values():
                    p.clock.advance_to(target)
                r.sample_pools()
        else:
            time.sleep(dt_s)

    def _cross_idle_gap(self, gap_s: float):
        """Cross an all-idle stretch between arrivals. With an autoscaler
        the gap is sub-stepped at its ``tick_interval_s`` cadence (bounded
        at 10k sub-steps) so ``hold_s`` hysteresis windows and the Holt
        forecast's sampling see the valley AS IT ELAPSES — a sustained-slack
        drain fires mid-gap, not at the gap's edge. Without an autoscaler a
        single jump accrues the idle joules exactly (piecewise-constant
        power integrates the same either way)."""
        if gap_s <= 0:
            return
        tick = 0.0
        if self.autoscaler is not None:
            tick = float(getattr(getattr(self.autoscaler, "spec", None),
                                 "tick_interval_s", 0.0) or 0.0)
        if not self.virtual or tick <= 0.0 or gap_s <= tick:
            self._advance_idle(gap_s)
            self._autoscale()
            return
        step = max(tick, gap_s / 10_000.0)
        left = gap_s
        while left > 1e-12:
            d = min(step, left)
            self._advance_idle(d)
            self._autoscale()
            left -= d

    def run_trace(
        self,
        trace: Iterable[TracedRequest],
        *,
        max_steps: int = 1000000,
        engine: str = "events",
        engine_opts: Optional[Dict[str, Any]] = None,
    ) -> List[Request]:
        """Replay an arrival trace across the fleet: each entry joins the
        router-chosen replica's queue when the serving clock crosses its
        ``arrival_s`` (relative to replay start). With a ``VirtualClock``
        the whole replay is deterministic — service time is the modelled
        step time at each pool's live operating point, and idle joules
        accrue across arrival gaps on every powered replica.

        ``engine`` picks how the trace is replayed:

        * ``"events"`` (default) — the discrete-event engine
          (``repro_torch.serving.events``): arrivals, admissions, decode
          steps, warm-up completions and autoscaler evaluations fire from
          one per-fleet heap in virtual-time order, per-pool timelines
          overlap prefill with decode, and homogeneous replica decode steps
          share one fused dispatch. Wall-clock fleets fall back to the
          barrier (real time cannot be event-skipped).
        * ``"barrier"`` — the legacy lockstep engine: every busy replica
          takes one tick per round and the round syncs to the slowest.

        ``engine_opts`` are forwarded to the ``EventDrivenFleet``
        constructor (``fusion_quantum_s``, ``fuse_prefill``,
        ``batch_replicas``, ``on_finish``, ...) on top of the fleet's own
        defaults (``FleetSpec.engine_opts``), overriding key-by-key;
        ignored by the barrier engine.
        """
        if self.virtual and any(r.controller is None for r in self.replicas):
            raise ValueError(
                "virtual-time replay needs a ClockController: without an "
                "operating point the pools cannot model step durations")
        if engine not in ("events", "barrier"):
            raise ValueError(f"unknown engine {engine!r}: "
                             "expected 'events' or 'barrier'")
        if engine == "events" and self.virtual:
            from repro_torch.serving.events import EventDrivenFleet
            opts = {**self.engine_opts, **(engine_opts or {})}
            return EventDrivenFleet(self, **opts).run(
                trace, max_steps=max_steps)
        pending = sorted(trace, key=lambda t: t.arrival_s)
        t_start = self.now_s()
        done: List[Request] = []
        i = 0
        steps = 0
        self.start_metering()
        try:
            while (i < len(pending) or self.busy()) and steps < max_steps:
                now = self.now_s() - t_start
                while i < len(pending) and pending[i].arrival_s <= now:
                    t = pending[i]
                    i += 1
                    self.submit(t.prompt, t.max_new_tokens,
                                temperature=t.temperature,
                                arrival_s=t_start + t.arrival_s,
                                bucket=t.bucket)
                if not self.busy():
                    if i >= len(pending):
                        break
                    # nothing in flight anywhere: idle until the next
                    # arrival; the autoscaler ticks at its own cadence
                    # inside the gap so a diurnal valley's sustained slack
                    # drains replicas mid-gap
                    self._cross_idle_gap(pending[i].arrival_s - now)
                    continue
                steps += sum(r.busy() for r in self.replicas)
                done.extend(self.step())
        finally:
            self.stop_metering()
        return done

    def run_to_completion(self, max_steps: int = 100000) -> List[Request]:
        done: List[Request] = []
        steps = 0
        self.start_metering()
        try:
            while self.busy() and steps < max_steps:
                steps += sum(r.busy() for r in self.replicas)
                done.extend(self.step())
        finally:
            self.stop_metering()
        return done

    # ------------------------------------------------------------- metering
    def start_metering(self):
        for r in self.replicas:
            r.start_metering()

    def stop_metering(self) -> Dict[str, Dict[str, float]]:
        """Stop every sampler; cumulative joules per replica per pool."""
        return {r.name: r.stop_metering() for r in self.replicas}

    def measured_energy_j(self) -> Dict[str, Dict[str, float]]:
        return {r.name: r.measured_energy_j() for r in self.replicas}

    def total_energy_j(self) -> float:
        """Fleet-wide measured joules (both pools, every replica, idle
        floors included) — THE number the routing policies compete on."""
        return sum(sum(pools.values())
                   for pools in self.measured_energy_j().values())

    # ----------------------------------------------------------------- stats
    @property
    def stats(self) -> PhaseStats:
        """Fleet-wide phase totals (clock fields are replica 0's decode)."""
        total = self.replicas[0].stats
        for r in self.replicas[1:]:
            total = total.merged_with(r.stats)
        return total

    def stats_by_replica(self) -> Dict[str, PhaseStats]:
        return {r.name: r.stats for r in self.replicas}

    def prefix_stats_total(self) -> PrefixStats:
        """Fleet-wide prefix-sharing counters (decode pools own the index;
        all-zero on fleets with sharing off)."""
        total = PrefixStats()
        for r in self.replicas:
            total.merge(r.decode_pool.prefix_stats)
        return total
