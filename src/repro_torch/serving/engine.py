"""Serving engine: the single-pool facade over the phase-pool machinery.

Counterpart of ``repro.serving.engine``. Phase-aware by construction: every
prefill and every decode step is accounted separately in ``PhaseStats`` —
wall time, token counts and (when a ``ClockController`` is attached) joules
at the pool's current operating point. One pool runs both phases (the
colocated deployment the paper measures). The public API is the
reference's: ``submit`` / ``step`` / ``run_to_completion`` / ``stats``,
and ``from_spec`` builds it from a ``ReplicaSpec``. On a card the pool
replays its decode step from a CUDA graph; ``cuda_graphs=False`` runs it
eagerly, as the comparison for the graph (``Pool``). With
``prefix_sharing=True`` admission prefills only the suffix a prefix hit
leaves, the one pool being donor and target alike. With ``trace=True`` the
engine and its pool record spans, device regions and counters into one
``Tracer`` (``tracer``; ``serving/tracing.py``), read by
``tracer.summary(t0, t1)``.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Deque, List, Optional

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.serving.controller import ClockController
from repro_torch.serving.pool import (
    EOS,
    PhaseStats,
    Pool,
    Request,
    head_validator,
    observe_latencies,
    popleft,
    requeue_front,
)
from repro_torch.serving.spec import ReplicaSpec
from repro_torch.serving.tracing import Tracer

__all__ = ["EOS", "PhaseStats", "Request", "ServingEngine"]


class ServingEngine:
    def __init__(
        self,
        cfg: ModelConfig,
        params: Any,
        *,
        max_batch: int = 8,
        max_seq_len: int = 4096,
        rng_seed: int = 0,
        clock: Callable[[], float] = time.perf_counter,
        controller: Optional[ClockController] = None,
        paged: bool = False,
        kv_block_size: int = 16,
        kv_blocks: Optional[int] = None,
        prefix_sharing: bool = False,
        device="cuda",
        cuda_graphs: bool = True,
        trace: bool = False,
    ):
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.max_seq_len = max_seq_len
        self.clock = clock
        # "mixed": one pool runs both phases at one lever — the colocated
        # baseline. A controller prices prefill/decode tokens separately.
        self.pool = Pool(
            cfg, params, role="mixed", max_batch=max_batch,
            max_seq_len=max_seq_len, rng_seed=rng_seed, clock=clock,
            paged=paged, kv_block_size=kv_block_size, kv_blocks=kv_blocks,
            prefix_sharing=prefix_sharing, device=device, cuda_graphs=cuda_graphs,
        )
        self.controller = controller
        self.tracer: Optional[Tracer] = Tracer(clock, self.pool.device) if trace else None
        self.pool.tracer = self.tracer
        self.waiting: Deque[Request] = deque()
        self._uid = 0
        self._step_no = 0

    @classmethod
    def from_spec(
        cls,
        spec: ReplicaSpec,
        *,
        emodel=None,
        params: Any = None,
        clock: Callable[[], float] = time.perf_counter,
        device="cuda",
    ) -> "ServingEngine":
        """Build the colocated engine from a declarative spec: the decode
        ``PoolSpec`` sizes the one mixed-phase pool (a colocated deployment
        has no separate prefill pool to budget), and ``spec.clock`` builds
        the controller against the FULL config's policy table. Without
        ``params`` the weights come from a ``torch.Generator`` on
        ``device`` seeded with ``spec.rng_seed`` (other values than the
        reference's ``jax.random`` init)."""
        from repro_torch.configs import get_config, reduced_config
        from repro_torch.core.energy import EnergyModel
        from repro_torch.device import resolve_device
        from repro_torch.hw import H200_SXM
        from repro_torch.models import init_params

        emodel = emodel if emodel is not None else EnergyModel(H200_SXM)
        full = get_config(spec.arch)
        cfg = reduced_config(spec.arch) if spec.reduced else full
        if params is None:
            dev = resolve_device(device)
            params = init_params(cfg, torch.Generator(dev).manual_seed(spec.rng_seed),
                                 device=dev)
        controller = ClockController(emodel, full, **spec.clock.controller_kwargs())
        return cls(
            cfg, params,
            max_batch=spec.decode.batch,
            max_seq_len=spec.max_seq_len,
            rng_seed=spec.rng_seed,
            clock=clock,
            controller=controller,
            paged=spec.decode.paged,
            kv_block_size=spec.decode.kv_block_size,
            kv_blocks=spec.decode.kv_blocks,
            prefix_sharing=spec.decode.prefix_sharing,
            device=device,
        )

    # ------------------------------------------------------------------ api
    @property
    def stats(self) -> PhaseStats:
        return self.pool.stats

    @property
    def slot_req(self) -> List[Optional[Request]]:
        return self.pool.slot_req

    def submit(
        self,
        prompt: np.ndarray,
        max_new_tokens: int = 32,
        *,
        temperature: float = 0.0,
        eos_token_id: Optional[int] = None,
        arrival_s: Optional[float] = None,
    ) -> Request:
        """Queue a request. ``arrival_s`` (on the engine's clock) is when it
        arrived, for a caller that submits it later than that; by default,
        now."""
        req = Request(uid=self._uid, prompt=np.asarray(prompt, np.int32),
                      max_new_tokens=max_new_tokens,
                      temperature=temperature, eos_token_id=eos_token_id)
        req.ledger.mark_arrival(self.clock() if arrival_s is None else arrival_s)
        self._uid += 1
        self.waiting.append(req)
        return req

    def _admit(self) -> List[Request]:
        if not self.waiting:
            return []
        if self.tracer is not None:
            with self.tracer.span("serve.admit"):
                return self._admit_waiting()
        return self._admit_waiting()

    def _admit_waiting(self) -> List[Request]:
        validated_head = head_validator(self.waiting, self.pool)
        validated_head()    # fail fast even when admission is impossible
        admitted: List[Request] = []
        while self.waiting and self.pool.can_admit(self.waiting[0]):
            req = validated_head()
            popleft(self.waiting)
            # colocated engine: the one pool is donor and target alike
            hit = self.pool.prefix_acquire(req)
            first, cache1 = self.pool.prefill_request(req, shared=hit)
            self.pool.place(req, cache1, first, len(req.prompt), shared=hit)
            admitted.append(req)
        return admitted

    @torch.inference_mode()
    def step(self) -> List[Request]:
        """Admit waiting requests, run one decode step, return finished ones."""
        if self.tracer is not None:
            with self.tracer.span("serve.step"):
                return self._step()
        return self._step()

    def _step(self) -> List[Request]:
        self._step_no += 1
        if self.controller is not None:
            self.controller.tick({"mixed": self.pool}, self._step_no)
        admitted = self._admit()
        if self.controller is not None and admitted:
            # re-resolve at the true post-admission occupancy
            self.controller.tick({"mixed": self.pool}, self._step_no)
        finished = self.pool.decode_once()
        if self.controller is not None:
            observe_latencies(self.controller, self.pool, admitted, finished)
        requeue_front(self.waiting, self.pool.take_evicted())
        return finished

    def run_to_completion(self, max_steps: int = 100000) -> List[Request]:
        done: List[Request] = []
        steps = 0
        while (self.waiting or self.pool.occupancy() > 0) and steps < max_steps:
            done.extend(self.step())
            steps += 1
        return done
