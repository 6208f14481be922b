"""Phase-disaggregated serving: the single-replica facade over the fleet.

The paper's deployment recipe (§7.1) made executable: prefill and decode
run on separate pools so each can hold its phase-optimal operating point
statically — decode never engages a power cap, so only a clock lock can
save energy there, while prefill genuinely needs the high clock.

Since the fleet refactor all replica machinery — the prefill/decode pool
pair, chunked-prefill ``Scheduler``, waiting queue, per-replica
``ClockController`` loop, metering — lives in ``repro_torch.serving.fleet``
(``Replica``), and trace replay is ``Fleet.run_trace`` (arrival release +
routing + per-round ticks). Counterpart of ``repro.serving.cluster``:
``Cluster`` is the single-replica deployment shape kept as a thin facade:
the constructor signature, attributes
(``prefill_pool``/``decode_pool``/``scheduler``/``waiting``) and methods
(``submit``/``step``/``run_trace``/``run_to_completion``/stats/metering)
are unchanged from before the fleet existed, and every call delegates to
one ``Replica`` inside a one-replica ``Fleet``. Multi-replica serving —
declarative specs, heterogeneous architectures, pluggable routers,
drain/power-down — is ``repro_torch.serving.spec`` +
``repro_torch.serving.fleet``.

Topology (one replica)::

    submit() -> waiting queue
                  |  Scheduler (chunked-prefill admission: a token budget
                  |  per tick bounds how much prefill work is launched,
                  v  so decode latency stays bounded under prompt bursts)
            prefill pool  -- batch-1 bucketed prefill -->  cache row
                  |                                           |
                  |        migration (in-place copy into a free slot)
                  v                                           v
            decode pool   -- one step over ALL slots per tick (a CUDA
                             graph replay on a card) -->

With ``clock=VirtualClock()`` the cluster replays in virtual time exactly
as before: ``run_trace`` releases a seeded arrival trace as simulated time
crosses each stamp, pools advance the shared clock by modelled step
durations, idle joules accrue across gaps, and the controller's ``slo``
mode closes the loop on measured TTFT/TBT percentiles. Replay runs on the
discrete-event engine (``repro_torch.serving.events``) by default; because
both cluster pools share ONE clock, the event schedule degenerates to the
legacy round order and tokens/modelled joules equal the barrier engine's
(``engine="barrier"``). The pools run on ``device`` (default ``"cuda"``);
``cuda_graphs=False`` runs the decode step eagerly on a card.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Deque, Dict, Iterable, List, Optional

import numpy as np

from repro_torch.core.traces import TracedRequest
from repro_torch.models.config import ModelConfig
from repro_torch.serving.controller import ClockController
from repro_torch.serving.fleet import Fleet, Replica, Scheduler
from repro_torch.serving.pool import PhaseStats, Pool, Request
from repro_torch.serving.spec import ReplicaSpec

__all__ = ["Cluster", "Scheduler"]


class Cluster:
    """Disaggregated prefill/decode serving over one model replica pair."""

    def __init__(
        self,
        cfg: ModelConfig,
        params: Any,
        *,
        controller: Optional[ClockController] = None,
        prefill_batch: int = 1,
        decode_batch: int = 8,
        max_seq_len: int = 4096,
        prefill_chunk_tokens: int = 256,
        rng_seed: int = 0,
        clock: Callable[[], float] = time.perf_counter,
        meter_interval_s: float = 0.050,
        paged: bool = False,
        kv_block_size: int = 16,
        kv_blocks: Optional[int] = None,
        device="cuda",
        cuda_graphs: bool = True,
    ):
        self._adopt(Replica(
            cfg, params, name="replica0", controller=controller,
            prefill_batch=prefill_batch, decode_batch=decode_batch,
            max_seq_len=max_seq_len,
            prefill_chunk_tokens=prefill_chunk_tokens, rng_seed=rng_seed,
            clock=clock, meter_interval_s=meter_interval_s, paged=paged,
            kv_block_size=kv_block_size, kv_blocks=kv_blocks,
            device=device, cuda_graphs=cuda_graphs,
        ))

    def _adopt(self, replica: Replica):
        self._replica = replica
        self._fleet = Fleet([replica])

    @classmethod
    def from_spec(
        cls,
        spec: ReplicaSpec,
        *,
        emodel=None,
        params: Any = None,
        clock: Callable[[], float] = time.perf_counter,
        meter_interval_s: float = 0.050,
        device="cuda",
    ) -> "Cluster":
        """Build the single-replica cluster from a declarative spec (the
        same ``ReplicaSpec`` a ``FleetSpec`` carries N of)."""
        self = cls.__new__(cls)
        self._adopt(Replica.from_spec(
            spec, emodel=emodel, clock=clock, params=params,
            meter_interval_s=meter_interval_s, device=device,
        ))
        return self

    # ----------------------------------------------------- replica plumbing
    @property
    def cfg(self) -> ModelConfig:
        return self._replica.cfg

    @property
    def prefill_pool(self) -> Pool:
        return self._replica.prefill_pool

    @property
    def decode_pool(self) -> Pool:
        return self._replica.decode_pool

    @property
    def controller(self) -> Optional[ClockController]:
        return self._replica.controller

    @property
    def scheduler(self) -> Scheduler:
        return self._replica.scheduler

    @property
    def clock(self) -> Callable[[], float]:
        return self._replica.clock

    @property
    def virtual(self) -> bool:
        return self._replica.virtual

    @property
    def waiting(self) -> "Deque[Request]":
        return self._replica.waiting

    # ------------------------------------------------------------------ api
    def submit(
        self,
        prompt: np.ndarray,
        max_new_tokens: int = 32,
        *,
        temperature: float = 0.0,
        eos_token_id: Optional[int] = None,
        arrival_s: Optional[float] = None,
    ) -> Request:
        """Queue a request. ``arrival_s`` overrides the arrival stamp (the
        trace replay passes the trace's own timestamp so queueing delay that
        happened *during* a long step is still charged to TTFT)."""
        return self._replica.submit(
            prompt, max_new_tokens, temperature=temperature,
            eos_token_id=eos_token_id, arrival_s=arrival_s,
        )

    def pools(self) -> Dict[str, Pool]:
        return self._replica.pools()

    def step(self) -> List[Request]:
        """One cluster tick: retune clocks, admit/migrate, decode."""
        return self._replica.step()

    def busy(self) -> bool:
        return self._replica.busy()

    # -------------------------------------------------------- trace replay
    def run_trace(
        self,
        trace: Iterable[TracedRequest],
        *,
        max_steps: int = 1000000,
        engine: str = "events",
        engine_opts: Optional[Dict[str, Any]] = None,
    ) -> List[Request]:
        """Replay an arrival trace on the one replica — subsumed by (and
        delegated to) ``Fleet.run_trace``. ``engine`` picks the engine
        (``"events"`` or ``"barrier"``); with the cluster's single shared
        clock the two produce identical token streams and modelled joules
        (measured joules may part in the last bits: ``ROADMAP.md``).
        ``engine_opts`` forward to the event engine (fusion quantum,
        fused-prefill toggle, streaming ``on_finish``)."""
        return self._fleet.run_trace(trace, max_steps=max_steps,
                                     engine=engine, engine_opts=engine_opts)

    def run_to_completion(self, max_steps: int = 100000) -> List[Request]:
        return self._replica.run_to_completion(max_steps=max_steps)

    # ------------------------------------------------------------- metering
    def start_metering(self):
        self._replica.start_metering()

    def stop_metering(self) -> Dict[str, float]:
        """Stop both samplers; return cumulative joules per pool."""
        return self._replica.stop_metering()

    def measured_energy_j(self) -> Dict[str, float]:
        """Cumulative per-pool joules across all runs — same lifetime scope
        as ``stats``, so measured and modelled energy stay comparable even
        when the cluster is run in several batches."""
        return self._replica.measured_energy_j()

    # ----------------------------------------------------------------- stats
    @property
    def prefill_stats(self) -> PhaseStats:
        return self._replica.prefill_stats

    @property
    def decode_stats(self) -> PhaseStats:
        return self._replica.decode_stats

    @property
    def stats(self) -> PhaseStats:
        """Cluster-wide phase totals (clock fields are the decode pool's —
        the phase the paper's capping claim is about)."""
        return self._replica.stats
