"""Phase pool: the slot/cache machinery one serving phase runs on.

Counterpart of ``repro.serving.pool`` in PyTorch. A ``Pool`` owns the slot
pool, the KV cache on the device and the model calls, plus the energy side:
``PhaseStats`` with per-phase joules and the configured-vs-actual clock of
the lever applied to the pool, a power gauge + ``PowerSampler`` metering
the pool's current operating point, and the ``OperatingPoint`` a
``ClockController`` writes.

Two cache layouts, as in the reference:

* **dense** — one ``(B, max_len, ...)`` row per slot, preallocated.
* **paged** (``paged=True``) — K/V live in fixed-size token blocks
  (``BlockAllocator``) shared by all slots through per-slot block tables;
  admission is block-bound, growth allocates a block at a time, exhaustion
  preempts the youngest slot (recompute-style eviction). Every block a
  decode step touches is metered in the pool's ``TrafficCounter``.

Prefill runs batch-1 with the prompt padded to a power-of-2 bucket into a
``(1, max_seq_len)`` cache row, and ``place`` moves that row into a slot: a
slot copy for the dense cache, a page scatter for the paged one. Decode
runs one step over ALL slots (per-slot lengths, active mask); the
attention inside it is the hand-written CUDA kernel on a card.

The decode step is one function over buffers the pool allocates once,
beside its cache (``_decode_fn``): static inputs (tokens, lengths and, for
the paged layout, the active mask and block tables), into which
``_decode_begin`` copies the host mirrors, and outputs (fp32 logits, the
greedy argmax). On a CUDA device it is the counterpart of the reference's
jitted ``_jit_decode`` / ``_jit_decode_paged``: the pool's first decode
step runs it eagerly (the warm-up: kernels' libraries bound, cuBLAS
handles made), the second captures it into a ``torch.cuda.CUDAGraph`` and
every later step replays that graph. The graph belongs to the pool, not to
a process-wide cache as ``_JIT_CACHE`` does, because it binds this pool's
own cache, parameter and buffer addresses: nothing may reallocate them
(``defrag`` moves pages in place). ``cuda_graphs=False`` runs the step
eagerly on the card, as the comparison for the graph; on the CPU the
function is always called directly. ``jit_dispatches`` counts one per
prefill, ``place`` / ``place_many``, decode step, copy-on-write split and
bank row copied back (``materialize_cache``), as the reference counts its
dispatches.

Prefix sharing (``prefix_sharing=True``, paged attention-family pools
only), as in the reference: a ``PrefixIndex`` holds refcounted pages of
finished transcripts; ``prefix_acquire`` pins a hit's pages for an
admitted request, whose prefill then computes only the un-shared suffix
over the hit's pages gathered into a batch-1 row (``shared_prefill``), and
``place`` writes the hit's page ids into the slot's table row without
copying them. A shared page is never written: before a decode step
``_cow_guard`` copies a shared page the step would write into a fresh one
(copy-on-write). Both go through the host mirror of the tables and copy
pages in place, on the stream the graph replays on, so a captured decode
step keeps every address it bound.

Replica banks, as in the reference: the event engine's batched fused
decode keeps the dense caches of a fused group in one ``CacheBank`` (one
cache of batch ``size * max_batch``, member ``j``'s rows at ``[:, j * B:
(j + 1) * B]`` of every leaf) and steps them all with ONE ``decode_step``,
a CUDA graph of the bank's own on a card. Between steps a member pool's
``cache`` is a ``BankRow``: a cache tree of views of its rows, so
``place`` / ``place_many`` write straight through to the bank. The pool
keeps its own cache beside it (the tensors its graph binds);
``materialize_cache`` copies the rows back into those tensors when the
pool steps on its own again.

Differences from the reference: caches are updated in place; the bucketed
prefill runs eagerly (no graph per bucket yet); greedy sampling is
``argmax`` (first maximum, as ``jnp.argmax``), and a temperature above 0
samples outside the step, with the reference's Gumbel-max over
``jax.random``'s threefry bits (``serving/prng.py``): the key stays on the
host and splits where the reference's does, once a decode step and once a
sampled prefill, and the (B, vocab) draw runs on the device only in a step
where some slot samples. The process-wide program cache that
``clear_program_caches`` empties holds the event engine's banks and their
graphs (the reference's holds jitted programs); prefill and placement run
eagerly, so there is no per-pool program cache.

A ``ServingEngine`` built with ``trace=True`` hands the pool its
``Tracer`` (``serving/tracing.py``): spans, device regions and counters
around ``prefill_request``, ``place`` and ``decode_once``; ``tracer`` is
None otherwise.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
import weakref
from collections import OrderedDict, deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.clock import VirtualClock
from repro_torch.core.dvfs import OperatingPoint
from repro_torch.core.energy import joules_from_hbm_traffic
from repro_torch.core.latency import LatencyLedger
from repro_torch.core.metering import GaugeSource, PowerSampler
from repro_torch.core.workload import weight_stream_bytes
from repro_torch.device import resolve_device
from repro_torch.kernels import COUNTED_KERNELS, prefill_attention
from repro_torch.models import (
    decode_step,
    decode_step_paged,
    init_cache,
    init_paged_cache,
    kv_cache_bytes_per_token,
    paged_layout,
    prefill,
    prefill_suffix,
    recurrent_state_bytes,
)
from repro_torch.models.config import ModelConfig
from repro_torch.serving import prng
from repro_torch.serving.paged_cache import NULL_PAGE, BlockAllocator, TrafficCounter
from repro_torch.serving.prefix import PrefixHit, PrefixIndex, PrefixStats
from repro_torch.serving.tracing import Tracer

# Attention paradigms whose KV rows depend only on their own prefix — the
# precondition for sharing cached pages across requests. Recurrent/MoE-state
# blocks carry slot-indexed O(1) state that is NOT position-addressable, so
# a pool holding any other kind refuses prefix sharing loudly.
SHAREABLE_KINDS = ("attn", "attn_global", "shared_attn")

# Back-compat default: seed code stopped on token id 0. The real stop id now
# comes from ``ModelConfig.eos_token_id`` (per-request override on Request).
EOS = 0


# ---------------------------------------------------------------------------
# Stable params identity. Fused-dispatch group signatures need "same weights"
# as a hashable token that (unlike ``id(params)``) can never be recycled onto
# a different pool's weights after a GC. Tokens come from one monotonic
# counter; the registry is a small LRU keyed on ``id(params)``, so repeated
# pool constructions over the same object share a token. An evicted and
# re-registered params gets a FRESH token: the failure mode is a missed
# fusion, never a wrong grouping. The reference's registry holds each params
# tree strongly; on a card that would keep up to 64 models' weights alive, so
# an entry here holds a weak reference to the tree's first leaf (a tensor:
# the weights themselves), and a recycled id is recognised by that leaf. A
# tree whose first leaf cannot be weakly referenced (a scalar) is held
# strongly, as in the reference.
_PARAMS_TOKEN_CAP = 64
_PARAMS_TOKENS: "OrderedDict[int, Tuple[Callable[[], Any], int]]" = OrderedDict()
_params_token_counter = itertools.count(1)


def _params_anchor(params: Any) -> Tuple[Any, Callable[[], Any]]:
    """(what identifies ``params``, a reference the registry may keep to it)."""
    leaf = params
    while isinstance(leaf, (dict, list, tuple)) and leaf:
        leaf = next(iter(leaf.values())) if isinstance(leaf, dict) else leaf[0]
    try:
        return leaf, weakref.ref(leaf)
    except TypeError:
        return params, lambda: params


def params_token_for(params: Any) -> int:
    """The stable monotonic token for this exact params object."""
    anchor, ref = _params_anchor(params)
    ent = _PARAMS_TOKENS.get(id(params))
    if ent is not None and ent[0]() is anchor:
        _PARAMS_TOKENS.move_to_end(id(params))
        return ent[1]
    tok = next(_params_token_counter)
    _PARAMS_TOKENS[id(params)] = (ref, tok)
    while len(_PARAMS_TOKENS) > _PARAMS_TOKEN_CAP:
        _PARAMS_TOKENS.popitem(last=False)
    return tok


def _leaves(cache, layout):
    """(stage-block dict, key, is_paged) for every cache leaf."""
    for sc, sl in zip(cache["stages"], layout["stages"]):
        for name, blk in sc.items():
            for key in blk:
                yield blk, key, sl[name][key]


def cache_rows(cache, start: int, stop: int) -> Dict:
    """Views of batch rows ``[start, stop)`` of a dense cache tree (every
    leaf has its batch on dim 1)."""
    return {"stages": [{name: {key: t[:, start:stop] for key, t in blk.items()}
                        for name, blk in sc.items()} for sc in cache["stages"]]}


def clear_program_caches() -> None:
    """Drop the event engine's process-wide program cache: the replica
    banks of each (decode signature, group size) with their CUDA graphs,
    and the batched-prefill entries. Benchmark sweeps call this between
    sweep points so each point pays its own captures instead of riding
    (and retaining) the previous point's. A bank a live pool still views
    stays alive with that pool, so clearing never breaks an engine
    mid-replay: the next restack takes a new bank."""
    from repro_torch.serving import events as _events
    _events._PROGRAM_CACHE.clear()


# ---------------------------------------------------------------------------
# The decode step as a CUDA graph: the pool's own step and a replica bank's.
class _GraphedStep:
    """A decode step over static buffers (``_decode_fn``, given by the
    subclass, which sets ``device`` first): eager on the CPU and with
    ``cuda_graphs`` off; on a card eager at the first step (on the side
    stream the graph is captured on), captured at the second and replayed
    from then on. A failed capture or replay raises."""

    def _init_graph(self, cuda_graphs: bool) -> None:
        self.cuda_graphs = cuda_graphs and self.device.type == "cuda"
        self._decode_steps_run = 0
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._graph_out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._graph_stream = None
        self.graph_replays = 0
        self.captured_launches: dict = {}   # counted wrapper -> launches per replay
        self.graph_capture_ms = 0.0

    def _run_decode_fn(self) -> Tuple[torch.Tensor, torch.Tensor]:
        self._decode_steps_run += 1
        if not self.cuda_graphs:
            return self._decode_fn()
        if self._graph is None:
            if self._graph_stream is None:
                self._graph_stream = torch.cuda.Stream(self.device)
            side, main = self._graph_stream, torch.cuda.current_stream(self.device)
            if self._decode_steps_run == 1:
                side.wait_stream(main)
                with torch.cuda.stream(side):
                    out = self._decode_fn()
                main.wait_stream(side)
                return out
            self._capture(side)
        self._graph.replay()
        self.graph_replays += 1
        return self._graph_out

    def _capture(self, stream) -> None:
        """Capture ``_decode_fn`` into the graph. Capture records and runs
        nothing, so the counted kernel wrappers' launch counts are put back
        where they were, and how far each moved is kept as the launches of
        one replay (``captured_launches``)."""
        t0 = time.perf_counter()
        before = {fn.__name__: fn.launches for fn in COUNTED_KERNELS}
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            out = self._decode_fn()
        self.captured_launches = {fn.__name__: fn.launches - before[fn.__name__]
                                  for fn in COUNTED_KERNELS}
        for fn in COUNTED_KERNELS:
            fn.launches = before[fn.__name__]
        self._graph, self._graph_out = graph, out
        self.graph_capture_ms = (time.perf_counter() - t0) * 1e3


@dataclasses.dataclass(frozen=True)
class BankShards:
    """The ranks a bank's members are split over: ``world`` ranks of the
    ``torch.distributed`` process ``group`` (None: the default group), this
    process being ``rank`` in it. A bank of ``size`` members gives each rank
    ``size // world`` consecutive members, rank r members ``[r * size /
    world, (r + 1) * size / world)``: the reference's ``shard_map`` over the
    replica axis."""

    group: Any
    rank: int
    world: int

    def owner(self, index: int, size: int) -> int:
        return index // (size // self.world)

    def global_rank(self, rank: int) -> int:
        import torch.distributed as dist

        return rank if self.group is None else dist.get_global_rank(self.group, rank)


class CacheBank(_GraphedStep):
    """The dense caches of one batched fused-decode group: one
    ``init_cache`` tree of batch ``size * batch`` (``size`` a power of two),
    member ``j``'s ``batch`` rows at ``[:, j * batch:(j + 1) * batch]`` of
    every leaf. Rows past the members' are pad rows: a step runs them with
    member 0's tokens and lengths and its results there are thrown away.

    ``decode`` is ONE ``decode_step`` over the whole tree from static token
    and length buffers, like a pool's step, and on a card a CUDA graph of
    the bank's own (eager first, captured at the second step, replayed
    after). The graph binds the tree, so the tree is never reallocated: a
    restack copies rows into it. ``viewers`` are the live pools whose
    ``cache`` is a ``BankRow`` of this bank.

    With ``shards`` the members are split over ranks (``BankShards``): this
    process's tree holds only its own ``local`` members, from member
    ``first`` on (``holds``), and ``decode`` steps those rows alone: the
    local core of ``models.shard_map_replicas``, with no cache leaf crossing
    ranks."""

    def __init__(self, cfg: ModelConfig, params: Any, size: int, batch: int,
                 max_seq_len: int, *, device, cuda_graphs: bool = True,
                 shards: Optional[BankShards] = None):
        self.cfg, self.params = cfg, params
        self.size, self.batch = size, batch
        self.shards = shards
        self.local = size if shards is None else size // shards.world
        self.first = 0 if shards is None else shards.rank * self.local
        self.device = resolve_device(device)
        self.tree = init_cache(cfg, self.local * batch, max_seq_len, device=self.device)
        self.viewers: "weakref.WeakSet[Pool]" = weakref.WeakSet()
        on_card = self.device.type == "cuda"
        n = self.local * batch
        self._step_host = {k: torch.zeros(n, dtype=torch.int32, pin_memory=on_card)
                           for k in ("tokens", "lengths")}
        self._step_in = ({k: torch.zeros(n, dtype=torch.int32, device=self.device)
                          for k in self._step_host} if on_card else self._step_host)
        self._init_graph(cuda_graphs)

    def holds(self, index: int) -> bool:
        """Whether member ``index``'s rows are in this process's tree."""
        return self.first <= index < self.first + self.local

    def rows(self, index: int) -> Dict:
        """Views of member ``index``'s rows of every leaf (held here)."""
        j = index - self.first
        return cache_rows(self.tree, j * self.batch, (j + 1) * self.batch)

    def _decode_fn(self) -> Tuple[torch.Tensor, torch.Tensor]:
        s = self._step_in
        logits, _, _ = decode_step(self.params, self.cfg, s["tokens"], self.tree,
                                   s["lengths"])
        return logits, torch.argmax(logits, dim=-1).to(torch.int32)

    def decode(self, tokens: np.ndarray, lengths: np.ndarray
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One step of every row held here, from the tokens and lengths of
        all ``size * batch`` rows: (logits (local * batch, V) fp32, greedy).
        The staging buffers are written again only after the previous
        step's tokens were read back, as a pool's are."""
        host = self._step_host
        lo, hi = self.first * self.batch, (self.first + self.local) * self.batch
        host["tokens"].numpy()[:] = tokens[lo:hi]
        host["lengths"].numpy()[:] = lengths[lo:hi]
        if self._step_in is not host:
            for key, dst in self._step_in.items():
                dst.copy_(host[key], non_blocking=True)
        return self._run_decode_fn()


class BankRow(dict):
    """A member pool's cache between batched steps: row ``index`` of
    ``bank``, as a cache tree (``{"stages": ...}``) whose leaves are views
    of that member's rows, so the pool's own indexing writes through to
    the bank. A row another rank holds (a sharded bank) is a tree with no
    stages: a placement into it writes nothing here, and its owner writes
    the same rows."""

    __slots__ = ("bank", "index")

    def __init__(self, bank: CacheBank, index: int):
        super().__init__(bank.rows(index) if bank.holds(index) else {"stages": []})
        self.bank = bank
        self.index = index


# -------------------------------------------------------- queue primitives
def popleft(waiting) -> "Request":
    """Pop the queue head from a deque (O(1)) or a list (legacy O(n)) —
    the one admission-queue pop used by scheduler/engine/validator code so
    deque-backed queues and user-supplied lists both work."""
    if isinstance(waiting, deque):
        return waiting.popleft()
    return waiting.pop(0)


def requeue_front(waiting, evicted: Sequence["Request"]) -> None:
    """Put preempted requests back at the queue head (oldest first), on a
    deque or a list alike."""
    if not evicted:
        return
    if isinstance(waiting, deque):
        waiting.extendleft(reversed(evicted))
    else:
        waiting[:0] = evicted


@dataclasses.dataclass(slots=True)
class Request:
    uid: int
    prompt: np.ndarray                     # (L,) int32
    max_new_tokens: int = 32
    temperature: float = 0.0
    eos_token_id: Optional[int] = None     # None -> the pool's ModelConfig id
    bucket: str = "mixed"                  # trace length-bucket tag (routing)
    replica: Optional[str] = None          # fleet replica that served it
    # filled by the pool/scheduler
    output: List[int] = dataclasses.field(default_factory=list)
    prefill_s: float = 0.0
    decode_s: float = 0.0
    prefill_j: float = 0.0                 # modelled joules at the pool's op
    decode_j: float = 0.0
    decode_read_bytes: int = 0             # paged pools: measured HBM traffic
    decode_write_bytes: int = 0
    preemptions: int = 0                   # times evicted + restarted
    prefix_tokens: int = 0                 # prompt positions served from shared pages
    saved_prefill_j: float = 0.0           # prefill joules sharing avoided (side-channel:
                                           # NOT part of energy_j — conservation holds)
    done: bool = False
    # event ledger (arrival/admitted/first-token/finish + per-token stamps),
    # stamped by the pool on the serving clock — wall or virtual alike
    ledger: LatencyLedger = dataclasses.field(default_factory=LatencyLedger)

    @property
    def energy_j(self) -> float:
        return self.prefill_j + self.decode_j

    @property
    def decode_bytes(self) -> int:
        return self.decode_read_bytes + self.decode_write_bytes

    @property
    def ttft_s(self) -> Optional[float]:
        return self.ledger.ttft_s

    @property
    def tbt_s(self) -> List[float]:
        return self.ledger.tbt_s

    @property
    def e2e_s(self) -> Optional[float]:
        return self.ledger.e2e_s


# ------------------------------------------------------- request freelist
# Replaying 10^6 requests builds (and drops) 10^6 Request + LatencyLedger
# pairs; the freelist recycles them once a streaming consumer is done with
# one. Only such a consumer calls ``release_request``: the barrier engine
# never does, so its replays hand out fresh requests.
_REQUEST_FREELIST: List[Request] = []
_REQUEST_FREELIST_CAP = 8192


def acquire_request(uid: int, prompt: np.ndarray, *, max_new_tokens: int = 32,
                    temperature: float = 0.0,
                    eos_token_id: Optional[int] = None,
                    bucket: str = "mixed",
                    replica: Optional[str] = None) -> Request:
    """A fresh-looking Request, recycled from the freelist when one is
    available (fields fully reset by ``release_request``)."""
    if _REQUEST_FREELIST:
        req = _REQUEST_FREELIST.pop()
        req.uid = uid
        req.prompt = prompt
        req.max_new_tokens = max_new_tokens
        req.temperature = temperature
        req.eos_token_id = eos_token_id
        req.bucket = bucket
        req.replica = replica
        return req
    return Request(uid=uid, prompt=prompt, max_new_tokens=max_new_tokens,
                   temperature=temperature, eos_token_id=eos_token_id,
                   bucket=bucket, replica=replica)


def release_request(req: Request) -> None:
    """Return a FINISHED request to the freelist. The caller promises to
    hold no further references: output, ledger stamps and energy fields are
    wiped here so the next ``acquire_request`` hands out a blank."""
    if len(_REQUEST_FREELIST) >= _REQUEST_FREELIST_CAP:
        return
    req.output = []
    req.prefill_s = req.decode_s = 0.0
    req.prefill_j = req.decode_j = 0.0
    req.decode_read_bytes = req.decode_write_bytes = 0
    req.preemptions = 0
    req.prefix_tokens = 0
    req.saved_prefill_j = 0.0
    req.done = False
    req.ledger.reset()
    _REQUEST_FREELIST.append(req)


@dataclasses.dataclass
class PhaseStats:
    prefill_tokens: int = 0
    prefill_s: float = 0.0
    prefill_calls: int = 0
    decode_tokens: int = 0
    decode_s: float = 0.0
    decode_steps: int = 0
    # energy attribution at the pool's operating point (0 when unmetered)
    prefill_j: float = 0.0
    decode_j: float = 0.0
    # block-level HBM traffic behind decode_j (0 on dense/unmetered pools)
    decode_read_bytes: int = 0
    decode_write_bytes: int = 0
    # lever state last applied to the pool that produced these stats
    configured_clock_mhz: float = 0.0
    actual_clock_mhz: float = 0.0
    lever_engaged: bool = False

    def merge_prefill(self, tokens: int, secs: float, joules: float = 0.0):
        self.prefill_tokens += tokens
        self.prefill_s += secs
        self.prefill_calls += 1
        self.prefill_j += joules

    def merge_decode(self, tokens: int, secs: float, joules: float = 0.0,
                     read_bytes: int = 0, write_bytes: int = 0):
        self.decode_tokens += tokens
        self.decode_s += secs
        self.decode_steps += 1
        self.decode_j += joules
        self.decode_read_bytes += read_bytes
        self.decode_write_bytes += write_bytes

    def note_operating_point(self, op: OperatingPoint):
        self.actual_clock_mhz = float(op.actual_clock_mhz)
        # OperatingPoint.clock_gap_mhz owns the "configured is only MHz for
        # locks" rule; don't reimplement it here
        self.configured_clock_mhz = self.actual_clock_mhz + op.clock_gap_mhz
        self.lever_engaged = bool(op.engaged)

    @property
    def clock_gap_mhz(self) -> float:
        """Configured-vs-actual lock gap (the §5.2 'double disguise')."""
        return self.configured_clock_mhz - self.actual_clock_mhz

    @property
    def energy_j(self) -> float:
        return self.prefill_j + self.decode_j

    @property
    def decode_bytes(self) -> int:
        return self.decode_read_bytes + self.decode_write_bytes

    def merged_with(self, other: "PhaseStats") -> "PhaseStats":
        """Fieldwise token/time/energy sum; clock fields keep ``self``'s."""
        return PhaseStats(
            prefill_tokens=self.prefill_tokens + other.prefill_tokens,
            prefill_s=self.prefill_s + other.prefill_s,
            prefill_calls=self.prefill_calls + other.prefill_calls,
            decode_tokens=self.decode_tokens + other.decode_tokens,
            decode_s=self.decode_s + other.decode_s,
            decode_steps=self.decode_steps + other.decode_steps,
            prefill_j=self.prefill_j + other.prefill_j,
            decode_j=self.decode_j + other.decode_j,
            decode_read_bytes=self.decode_read_bytes + other.decode_read_bytes,
            decode_write_bytes=self.decode_write_bytes + other.decode_write_bytes,
            configured_clock_mhz=self.configured_clock_mhz,
            actual_clock_mhz=self.actual_clock_mhz,
            lever_engaged=self.lever_engaged,
        )


def _bucket(n: int, buckets=(32, 64, 128, 256, 512, 1024, 2048, 4096)) -> int:
    for b in buckets:
        if n <= b:
            return b
    return int(2 ** np.ceil(np.log2(n)))


def head_validator(waiting: List[Request], pool: "Pool") -> Callable[[], Request]:
    """The single admission-validation path, shared by ``Scheduler.tick``
    and ``ServingEngine._admit``: returns a closure that validates the
    current queue head exactly once, dropping a poison request (one that
    could never be served, so admission gates would stay closed forever and
    livelock the queue) before the error surfaces."""
    validated: Optional[Request] = None

    def validated_head() -> Request:
        nonlocal validated
        req = waiting[0]
        if req is not validated:
            try:
                pool.validate(req)
            except ValueError:
                popleft(waiting)
                raise
            validated = req
        return req

    return validated_head


def observe_latencies(controller, pool: "Pool", admitted: List[Request],
                      finished: List[Request]) -> None:
    """Feed one step's measured latencies back to the controller — the slo
    mode's closed loop, shared by ``Cluster.step`` and
    ``ServingEngine.step``: TTFT of everything admitted this tick, plus the
    inter-token gap every request (still live or just finished) saw from
    this decode step."""
    live = [r for r in pool.slot_req if r is not None]
    controller.observe(
        ttft_s=[r.ledger.ttft_s for r in admitted
                if r.ledger.ttft_s is not None],
        tbt_s=[t for r in live + finished
               if (t := r.ledger.last_tbt_s) is not None],
    )


class Pool(_GraphedStep):
    """Slot pool + model calls + phase/energy accounting for one phase."""

    def __init__(
        self,
        cfg: ModelConfig,
        params: Any,
        *,
        role: str = "decode",              # "prefill" | "decode" | "mixed"
        max_batch: int = 8,
        max_seq_len: int = 4096,
        rng_seed: int = 0,
        clock: Callable[[], float] = time.perf_counter,
        meter_interval_s: float = 0.050,
        paged: bool = False,
        kv_block_size: int = 16,
        kv_blocks: Optional[int] = None,   # default: dense-equivalent budget
        prefix_sharing: bool = False,
        device="cuda",
        cuda_graphs: bool = True,
    ):
        self.cfg = cfg
        self.params = params
        # stable weights identity for fused-dispatch grouping: pools built
        # over the SAME params object share it
        self.params_token = params_token_for(params)
        self.device = resolve_device(device)
        self.role = role
        self.max_batch = max_batch
        self.max_seq_len = max_seq_len
        self.clock = clock
        # virtual mode: the clock only moves when this pool advances it by
        # the modelled duration of each phase call (needs an operating
        # point, i.e. a ClockController); metering goes synchronous.
        self.virtual = isinstance(clock, VirtualClock)
        self.stats = PhaseStats()
        self.eos_token_id = cfg.eos_token_id

        # energy side: operating point is written by a ClockController; the
        # gauge feeds this pool's sampler so the metering stack sees the
        # modelled power of whatever point the pool currently runs at, or
        # the idle floor while the pool has no work.
        self.op: Optional[OperatingPoint] = None
        self.prefill_op: Optional[OperatingPoint] = None
        self.idle_power_w: float = 0.0
        self.hbm_bw_eff: float = 0.0       # set by the controller; enables
                                           # traffic-derived decode joules
        self.gauge = GaugeSource(0.0)
        self.sampler = PowerSampler(
            self.gauge, interval_s=meter_interval_s, clock=clock,
            synchronous=self.virtual,
        )
        self._in_phase_call = False
        self._metering_active = False
        self._measured_j_total = 0.0

        # the decode cache allocates lazily on first placement, so a
        # prefill-role pool never holds an unused stacked KV cache. Between
        # batched fused steps ``cache`` is a ``BankRow``; ``_own_cache`` is
        # the pool's own cache all the same (its graph binds it)
        self._cache = None
        self._own_cache = None
        self.bank_steps = 0                 # decode steps taken inside a bank
        self.slot_req: List[Optional[Request]] = [None] * max_batch
        self.peak_occupancy = 0
        # the sampling key (temperature > 0), held on the host as the
        # reference's ``PRNGKey(rng_seed)``: split once a decode step and
        # once a sampled prefill, at the reference's points
        self._key = prng.PRNGKey(rng_seed)

        # paged-cache side: allocator + per-slot block tables (host side;
        # the stacked (B, nb) table goes to the device once per step)
        self.paged = paged
        self.kv_block_size = kv_block_size
        self.allocator: Optional[BlockAllocator] = None
        self.traffic = TrafficCounter()
        self.evicted: List[Request] = []
        self._layout = paged_layout(cfg)
        if paged:
            if max_seq_len % kv_block_size:
                raise ValueError(
                    f"max_seq_len {max_seq_len} not a multiple of "
                    f"kv_block_size {kv_block_size}"
                )
            n_blocks = kv_blocks if kv_blocks is not None else (
                max_batch * max_seq_len // kv_block_size
            )
            self.allocator = BlockAllocator(n_blocks, kv_block_size)
            nb_per_slot = max_seq_len // kv_block_size
            self.block_tables = np.zeros((max_batch, nb_per_slot), np.int32)
            # byte-accuracy constants (per token / per request / per step)
            self._kv_token_bytes = kv_cache_bytes_per_token(cfg)
            self._state_read_bytes = recurrent_state_bytes(cfg)
            self._state_write_bytes = recurrent_state_bytes(cfg, mutable_only=True)
            self._weight_bytes = weight_stream_bytes(cfg)
        # prefix sharing: the index holds refcounted page references on THIS
        # pool's allocator; ``prefix_acquire`` hands shared table entries to
        # admitted requests, and ``prefix_stats`` meters what the reuse
        # avoided (side-channel, never added to totals)
        self.prefix_sharing = prefix_sharing
        self._prefix: Optional[PrefixIndex] = None
        self.prefix_stats = PrefixStats()
        self._pending_hits: Dict[int, PrefixHit] = {}
        if prefix_sharing:
            if not paged:
                raise ValueError("prefix_sharing requires paged=True")
            bad = sorted(set(k for k in cfg.block_kinds_flat()
                             if k not in SHAREABLE_KINDS))
            if bad:
                raise ValueError(
                    f"prefix_sharing supports attention-family blocks only "
                    f"({'/'.join(SHAREABLE_KINDS)}); config has {bad}"
                )
            self._prefix = PrefixIndex(self.allocator)
        self._host_lengths = np.zeros(max_batch, np.int64)
        self._admit_seq = np.zeros(max_batch, np.int64)
        self._admit_counter = 0
        # per-slot sampling temperature (0 = greedy), set at placement so a
        # mixed batch decodes each slot at its own Request.temperature
        self._slot_temp = np.zeros(max_batch, np.float32)
        # host mirror of the current-token vector: placements write here and
        # ``_decode_begin`` ships the mirrors to the device once per step
        self._host_cur_token = np.zeros(max_batch, np.int32)
        # prefill + place + decode-step + copy-on-write dispatches made by
        # this pool (the event engine's fused dispatches count on its side)
        self.jit_dispatches = 0

        # the decode step's static buffers (allocated with the cache) and,
        # on a card, its CUDA graph: captured at the second decode step,
        # replayed at every later one
        self._step_host: dict = {}          # staging (pinned on a card)
        self._step_in: dict = {}            # what the step reads
        self._init_graph(cuda_graphs)
        # spans, device regions and counters (``serving/tracing.py``); set
        # by a ``ServingEngine`` built with ``trace=True``
        self.tracer: Optional[Tracer] = None

    # ----------------------------------------------------- bank-view cache
    @property
    def cache(self):
        return self._cache

    @cache.setter
    def cache(self, value) -> None:
        # a bank knows which pools view it: a restack never takes a bank
        # some pool still reads
        if isinstance(self._cache, BankRow):
            self._cache.bank.viewers.discard(self)
        if isinstance(value, BankRow):
            value.bank.viewers.add(self)
        self._cache = value

    def cache_is_view(self) -> bool:
        return isinstance(self._cache, BankRow)

    @torch.inference_mode()
    def materialize_cache(self) -> None:
        """Copy a ``BankRow`` view's rows into this pool's own cache (the
        tensors its graph binds, never new ones) and hold that again,
        counted as one dispatch as the reference counts its gather. No-op
        when the cache is the pool's own."""
        row = self._cache
        if not isinstance(row, BankRow):
            return
        for (dst, key, _), (src, _, _) in zip(_leaves(self._own_cache, self._layout),
                                              _leaves(row, self._layout)):
            dst[key].copy_(src[key])
        shards = row.bank.shards
        if shards is not None:
            # a sharded bank's rows come from the rank that holds them: every
            # rank runs this pool's steps, so every rank takes its cache
            import torch.distributed as dist

            src = shards.global_rank(shards.owner(row.index, row.bank.size))
            for dst, key, _ in _leaves(self._own_cache, self._layout):
                dist.broadcast(dst[key], src=src, group=shards.group)
        self.cache = self._own_cache
        self.jit_dispatches += 1

    # ------------------------------------------------------------- internals
    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _sample(self, logits: torch.Tensor, greedy: torch.Tensor,
                temperature: np.ndarray, key: np.ndarray) -> torch.Tensor:
        """Per-slot sampling, the reference's ``_sample``: ``temperature`` is
        a (B,) host vector; slots at 0 take ``greedy`` (the step's argmax),
        the rest draw Gumbel-max at their own temperature over
        ``jax.random.uniform(key, logits.shape)``'s bits (``prng``). The
        all-greedy batch skips the draw: no device work, no sync."""
        if not (temperature > 0.0).any():
            return greedy
        t = self._tensor(np.maximum(temperature, 1e-6))[:, None]
        u = prng.uniform(key, logits.shape, device=logits.device)
        gumbel = -torch.log(-torch.log(u + 1e-9) + 1e-9)
        s = torch.argmax(logits / t + gumbel, dim=-1).to(torch.int32)
        return torch.where(self._tensor(temperature > 0.0), s, greedy)

    # ------------------------------------------------------- energy plumbing
    def set_operating_point(self, op: OperatingPoint, prefill_op: Optional[OperatingPoint] = None):
        """Apply a controller-resolved point; ``prefill_op`` prices prefill
        tokens separately when one pool runs both phases (colocated engine)."""
        self.op = op
        self.prefill_op = prefill_op if prefill_op is not None else op
        self.stats.note_operating_point(op)
        self._refresh_gauge()

    def _refresh_gauge(self):
        # inside a prefill call the device burns prefill power; between
        # ticks a pool holding live slots burns its decode-point power;
        # an empty pool sits at the idle floor
        if self._in_phase_call and self.prefill_op is not None:
            watts = self.prefill_op.power_w
        elif self.op is not None and self.occupancy() > 0:
            watts = self.op.power_w
        else:
            watts = self.idle_power_w
        if (self.sampler.synchronous and self._metering_active
                and watts != self.gauge()):
            # bracket the step change so the trapezoid integrates the
            # piecewise-constant power signal exactly: close the old level
            # at (now, w_old), open the new one at (now, w_new)
            self.sampler.sample_once()
            self.gauge.set(watts)
            self.sampler.sample_once()
        else:
            self.gauge.set(watts)

    def set_idle_power(self, watts: float):
        """Set the no-work power floor this pool idles at and refresh the
        gauge (bracketed with samples under synchronous metering)."""
        self.idle_power_w = float(watts)
        self._refresh_gauge()

    def sample_now(self):
        """Synchronous-metering hook: record a sample at the current clock
        (callers advance the shared VirtualClock, then sample each pool)."""
        if self.sampler.synchronous and self._metering_active:
            self.sampler.advance()

    def advance_time(self, dt_s: float):
        """Advance this pool's (virtual) clock by a modelled duration and
        take a synchronous power sample, so energy integrates over virtual
        time without threads. No-op on a wall clock."""
        if not self.virtual or dt_s <= 0:
            return
        self.clock.advance(dt_s)
        self.sample_now()

    @property
    def current_power_w(self) -> float:
        return self.gauge()

    def _mj_per_token(self, phase: str = "decode") -> float:
        op = self.prefill_op if phase == "prefill" else self.op
        return op.energy_per_token_mj if op is not None else 0.0

    def start_metering(self):
        if self._metering_active:
            return
        self._metering_active = True
        self.sampler.start()                 # resets the trace for this window

    def stop_metering(self) -> float:
        """Stop the sampler; bank the window's joules; return the total."""
        if self._metering_active:
            self._metering_active = False
            self.sampler.stop()
            self._measured_j_total += self.sampler.trace.integrate_trapezoid()
        return self._measured_j_total

    def measured_energy_j(self) -> float:
        """Joules across ALL metering windows (plus the live one, if any)."""
        live = self.sampler.trace.integrate_trapezoid() if self._metering_active else 0.0
        return self._measured_j_total + live

    # ------------------------------------------------------------- occupancy
    def free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req) if r is None]

    def has_free_slot(self) -> bool:
        return any(r is None for r in self.slot_req)

    def can_admit(self, req: Request) -> bool:
        """Admission test: a slot AND (paged) blocks for prompt + first
        token. Growth past that is served by alloc-or-preempt, so this is
        the continuous-batching gate: admit whenever blocks are free.

        A prefix-sharing pool admits on *private* need — shared table
        entries cost nothing — and may count index-only pages it could
        evict; the count excludes the hit's own pages, which acquisition
        pins (refcount 2) and so makes unreclaimable."""
        if not self.has_free_slot():
            return False
        if not self.paged:
            return True
        need = self.allocator.blocks_for_tokens(len(req.prompt) + 1)
        if self._prefix is not None:
            entries, _ = self._peek_fitted(req.prompt)
            avail = self.allocator.free_blocks + max(
                self._prefix.reclaimable_blocks() - entries, 0)
            return max(need - entries, 0) <= avail
        return self.allocator.can_alloc(need)

    def occupancy(self) -> int:
        return sum(r is not None for r in self.slot_req)

    def mean_context(self) -> float:
        mask = self.active_mask()
        if not mask.any():
            return 0.0
        return float(self._host_lengths[mask].mean())

    def _ensure_decode_state(self):
        if self._cache is None:
            if self.paged:
                self._own_cache = init_paged_cache(
                    self.cfg, self.max_batch,
                    self.allocator.num_blocks + 1,   # + the null page
                    self.kv_block_size, device=self.device,
                )
            else:
                self._own_cache = init_cache(self.cfg, self.max_batch, self.max_seq_len,
                                             device=self.device)
            self.cache = self._own_cache
            self._alloc_step_buffers()

    def _alloc_step_buffers(self):
        """The decode step's static inputs, allocated once: ``_step_in`` on
        the device, which the step reads, and ``_step_host`` on the host,
        which ``_decode_begin`` fills from the mirrors (pinned on a card, so
        that the copies are asynchronous; the same tensors on the CPU). The
        dense step reads no active mask: ``decode_step`` takes none."""
        b = self.max_batch
        spec = {"tokens": ((b,), torch.int32), "lengths": ((b,), torch.int32)}
        if self.paged:
            spec["active"] = ((b,), torch.bool)
            spec["tables"] = (self.block_tables.shape, torch.int32)
        on_card = self.device.type == "cuda"
        self._step_host = {k: torch.zeros(shape, dtype=dtype, pin_memory=on_card)
                           for k, (shape, dtype) in spec.items()}
        self._step_in = ({k: torch.zeros(shape, dtype=dtype, device=self.device)
                          for k, (shape, dtype) in spec.items()}
                         if on_card else self._step_host)

    def active_mask(self) -> np.ndarray:
        return np.array([r is not None for r in self.slot_req])

    def validate(self, req: Request):
        l = len(req.prompt)
        if l + req.max_new_tokens > self.max_seq_len:
            raise ValueError(
                f"request {req.uid}: prompt {l} + max_new {req.max_new_tokens} "
                f"exceeds engine max_seq_len {self.max_seq_len}"
            )
        if self.paged:
            need = self.allocator.blocks_for_tokens(l + req.max_new_tokens)
            if need > self.allocator.num_blocks:
                raise ValueError(
                    f"request {req.uid}: needs {need} cache blocks, pool has "
                    f"{self.allocator.num_blocks} — unservable even alone"
                )

    # ------------------------------------------------------- paged plumbing
    def _slot_blocks(self, slot: int) -> List[int]:
        row = self.block_tables[slot]
        return [int(b) for b in row[row != NULL_PAGE]]

    def _evict(self, slot: int):
        """Preempt-by-eviction (recompute style): free the slot's blocks,
        reset the request, park it on ``self.evicted`` for the scheduler to
        requeue. Greedy decoding makes the recompute token-identical."""
        req = self.slot_req[slot]
        self.allocator.free(self._slot_blocks(slot), owner=req.uid)
        self.block_tables[slot] = NULL_PAGE
        self.slot_req[slot] = None
        self._host_lengths[slot] = 0
        self._slot_temp[slot] = 0.0
        req.output = []
        req.ledger.reset_service()   # TTFT will span the recompute, too
        req.preemptions += 1
        self.evicted.append(req)
        self._refresh_gauge()

    def take_evicted(self) -> List[Request]:
        out, self.evicted = self.evicted, []
        return out

    def _youngest_active_slot(self) -> Optional[int]:
        live = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not live:
            return None
        return max(live, key=lambda i: self._admit_seq[i])

    def _grow_tables(self):
        """Allocate the next block for every slot whose write position has
        crossed a block boundary; preempt the youngest slot on exhaustion.
        Oldest-admitted slots grow first, so under contention the pool
        drains FIFO-ish instead of livelocking."""
        order = sorted(
            (i for i, r in enumerate(self.slot_req) if r is not None),
            key=lambda i: self._admit_seq[i],
        )
        bs = self.kv_block_size
        for slot in order:
            if self.slot_req[slot] is None:      # evicted by an older slot
                continue
            ln = int(self._host_lengths[slot])
            if ln % bs != 0:
                continue
            want = ln // bs
            if want < len(self._slot_blocks(slot)):
                continue
            while True:
                blk = self.allocator.alloc_one(owner=self.slot_req[slot].uid)
                if blk is not None:
                    self.block_tables[slot, want] = blk
                    break
                if self._evict_index_one():
                    continue                      # index page reclaimed; retry
                victim = self._youngest_active_slot()
                self._evict(victim)
                if victim == slot:
                    break                         # evicted ourselves; requeued

    # ------------------------------------------------------- prefix sharing
    def _evict_index_one(self) -> bool:
        """Reclaim one index-only page (allocator pressure relief: tried
        before preempting a live slot). False when sharing is off or the
        index holds nothing reclaimable."""
        if self._prefix is None or not self._prefix.evict_one():
            return False
        self.prefix_stats.evictions += 1
        self.prefix_stats.index_blocks = self._prefix.held_blocks
        return True

    def _alloc_blocks(self, n: int, owner: int) -> List[int]:
        """``allocator.alloc`` with index eviction under pressure — the
        placement-time twin of ``can_admit``'s reclaimable accounting."""
        while not self.allocator.can_alloc(n) and self._evict_index_one():
            pass
        return self.allocator.alloc(n, owner)

    def _fits(self, prefix_tokens: int, prompt_len: int) -> bool:
        """Does the suffix bucket fit the cache row after ``prefix_tokens``
        shared positions (so the suffix write is never clamped)?"""
        bucket = min(_bucket(prompt_len - prefix_tokens), self.max_seq_len)
        return prefix_tokens + bucket <= self.max_seq_len

    def _fitted_entries(self, entries: int, prompt_len: int) -> int:
        """The most whole shared blocks (at most ``entries``, never the
        prompt's last token) whose suffix bucket fits the cache row."""
        bs = self.kv_block_size
        n = min(entries, (prompt_len - 1) // bs)
        while n > 0 and not self._fits(n * bs, prompt_len):
            n -= 1
        return n

    def _fit_hit(self, hit: Optional[PrefixHit],
                 prompt_len: int) -> Optional[PrefixHit]:
        """Cap a hit so the suffix bucket still fits the cache row:
        ``prefix_len + bucket(suffix) <= max_seq_len`` keeps the suffix
        write un-clamped. Demotes to fewer whole shared blocks (never a
        partial boundary) or to a miss."""
        if hit is None or self._fits(hit.prefix_tokens, prompt_len):
            return hit
        n = self._fitted_entries(len(hit.full_blocks), prompt_len)
        if n == 0:
            return None
        bs = self.kv_block_size
        return PrefixHit(hit.full_blocks[:n], None, n * bs, n * bs)

    def _peek_fitted(self, prompt) -> Tuple[int, int]:
        """Non-mutating (shared_entries, prefix_tokens) the prompt would
        get after the bucket-fit cap — for admission gates, scheduler token
        budgets and the prefix router."""
        if self._prefix is None:
            return 0, 0
        entries, pt = self._prefix.peek(prompt)
        if entries == 0:
            return 0, 0
        if self._fits(pt, len(prompt)):
            return entries, pt
        n = self._fitted_entries(entries, len(prompt))
        return n, n * self.kv_block_size

    def prefix_acquire(self, req: Request) -> Optional[PrefixHit]:
        """Look the prompt up in the prefix index and pin the hit: one
        allocator reference per shared table entry, owned by ``req.uid`` —
        the same references the block table will carry, so eviction and
        finish free them through the normal table path. Returns None when
        sharing is off or nothing matched. Call only on the admission path;
        every acquired hit MUST flow into ``place(..., shared=hit)``."""
        if self._prefix is None:
            return None
        self.prefix_stats.lookups += 1
        hit = self._fit_hit(self._prefix.match(req.prompt), len(req.prompt))
        if hit is None:
            self.prefix_stats.misses += 1
            return None
        for b in hit.table_blocks:
            self.allocator.retain(b, req.uid)
        self._pending_hits[req.uid] = hit
        self.prefix_stats.hits += 1
        self.prefix_stats.shared_blocks += hit.shared_entries
        self.prefix_stats.shared_tokens += hit.prefix_tokens
        return hit

    def prefill_cost_tokens(self, req: Request) -> int:
        """Prompt tokens prefill will actually compute for ``req`` — the
        scheduler's token-budget charge (suffix only under a prefix hit;
        at least one token is always recomputed)."""
        if self._prefix is None:
            return len(req.prompt)
        _, pt = self._peek_fitted(req.prompt)
        return max(len(req.prompt) - pt, 1)

    def suffix_tokens(self, req: Request,
                      prefix_tokens: int) -> Tuple[np.ndarray, np.ndarray, int]:
        """The (tokens, true_len, bucket) triple for a suffix-only prefill:
        the un-shared tail of the prompt, padded to its own bucket."""
        sl = len(req.prompt) - prefix_tokens
        bucket = min(_bucket(sl), self.max_seq_len)
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :sl] = req.prompt[prefix_tokens:]
        return toks, np.asarray([sl], np.int32), bucket

    def shared_prefill(self, params, toks, true_len, hit: PrefixHit):
        """Donor side of a suffix prefill over THIS pool's paged cache:
        gather the hit's pages into a dense batch-1 row (null-page padding
        fills the unused entries; those rows sit above ``prefix_len``,
        where the causal mask never looks), then run ``prefill_suffix`` for
        the un-shared tokens. Returns (logits, cache row) shaped like the
        plain prefill's, so placement is uniform. Runs on the current
        stream, after every decode step issued before it."""
        nb, bs = self.block_tables.shape[1], self.kv_block_size
        gather = hit.gather_blocks(bs)
        page_map = np.full(nb, NULL_PAGE, np.int64)
        page_map[:len(gather)] = gather
        pages = self._tensor(page_map)
        cache1 = init_cache(self.cfg, 1, self.max_seq_len, device=self.device)
        for (row_blk, key, is_paged), (pool_blk, _, _) in zip(
                _leaves(cache1, self._layout), _leaves(self.cache, self._layout)):
            if is_paged:
                rows = pool_blk[key][:, pages]                  # (n_units, nb, bs, ...)
                row_blk[key][:, 0] = rows.reshape(rows.shape[0], nb * bs, *rows.shape[3:])
        logits, cache1, _ = prefill_suffix(
            params, self.cfg, self._tensor(toks), cache1,
            prefix_len=self._tensor(np.asarray([hit.prefix_tokens], np.int32)),
            suffix_lengths=self._tensor(true_len))
        return logits, cache1

    def _register_finished(self, req: Request, slot: int):
        """Donate a finished request's cached transcript to the prefix
        index (prompt + all generated tokens whose KV was written). Runs
        BEFORE the request's blocks are freed, so the pages the index newly
        retains survive the free."""
        cached_len = int(self._host_lengths[slot])
        if cached_len < self.kv_block_size:
            return
        toks = np.concatenate([
            np.asarray(req.prompt, np.int64),
            np.asarray(req.output[:-1], np.int64),
        ])[:cached_len]
        self._prefix.register(toks, self._slot_blocks(slot), cached_len)
        self.prefix_stats.registrations += 1
        self.prefix_stats.index_blocks = self._prefix.held_blocks

    def _cow_guard(self):
        """Copy-on-write: before a decode step, any live slot whose write
        target page is shared (refcount > 1) gets a private copy — alloc a
        fresh page (evicting index entries, then preempting the youngest
        slot, under pressure), copy the page in place in every paged cache
        leaf, swap the host table entry, drop the shared reference. Shared
        pages are thereby never written. The copy runs on the current
        stream, before the step's tables reach the device."""
        bs = self.kv_block_size
        block_bytes = bs * self._kv_token_bytes
        for slot, req in enumerate(self.slot_req):
            if req is None:
                continue
            entry = int(self._host_lengths[slot]) // bs
            blk = int(self.block_tables[slot, entry])
            if blk == NULL_PAGE or not self.allocator.is_shared(blk):
                continue
            while True:
                fresh = self.allocator.alloc_one(owner=req.uid)
                if fresh is not None:
                    break
                if self._evict_index_one():
                    continue
                victim = self._youngest_active_slot()
                self._evict(victim)
                if victim == slot:
                    break
            if self.slot_req[slot] is None:       # preempted ourselves
                continue
            for leaf_blk, key, is_paged in _leaves(self.cache, self._layout):
                if is_paged:
                    leaf_blk[key][:, fresh] = leaf_blk[key][:, blk]
            self.jit_dispatches += 1
            self.block_tables[slot, entry] = fresh
            self.allocator.release(blk, owner=req.uid)
            self.prefix_stats.cow_splits += 1
            # the split physically moves one block through HBM
            self.traffic.count_reads(1, block_bytes)
            self.traffic.count_writes(1, block_bytes)

    # ------------------------------------------------------------ phase work
    def prefill_tokens(self, req: Request) -> Tuple[np.ndarray, np.ndarray, int]:
        """The (tokens, true_len, bucket) triple of ``req``'s padded
        batch-1 prefill (also what the event engine's fused admission
        issues for it)."""
        l = len(req.prompt)
        bucket = min(_bucket(l), self.max_seq_len)
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :l] = req.prompt
        return toks, np.asarray([l], np.int32), bucket

    def prefill_rows(self, toks: np.ndarray, true_len: np.ndarray) -> Tuple[Any, Any]:
        """The bucketed prefill itself, with no accounting: (logits (n, V),
        cache of batch n) of ``n`` padded prompts (``toks`` (n, bucket),
        ``true_len`` (n,)). A request's own prefill is batch 1
        (``prefill_tokens``' triple); the event engine's batched admission
        prefills a group's prompts in one call."""
        cache1 = init_cache(self.cfg, toks.shape[0], self.max_seq_len, device=self.device)
        logits, cache1, _ = prefill(self.params, self.cfg, self._tensor(toks), cache1,
                                    prompt_lengths=self._tensor(true_len))
        return logits, cache1

    @torch.inference_mode()
    def prefill_request(self, req: Request, *,
                        precomputed: Optional[Tuple[Any, Any]] = None,
                        shared: Optional[PrefixHit] = None,
                        donor: Optional["Pool"] = None) -> Tuple[int, Any]:
        """Run the bucketed batch-1 prefill; returns (first_token, cache row).

        The returned cache row is placed with ``place``: on this pool for
        the single-pool engine, on the decode pool for the disaggregated
        cluster.

        ``precomputed`` is the fused-admission handoff: a (logits, cache
        row) pair the event engine already issued. Only the model call is
        skipped — clock advance, gauge bracketing, ledger stamps, sampling
        order and energy accounting run exactly as the serial path.

        ``shared`` (a hit from ``donor.prefix_acquire``, donor defaulting to
        this pool) switches to suffix-only prefill: compute, time, and
        joules scale to the un-shared tokens, and the avoided prefill is
        banked in the donor's ``prefix_stats.saved_*`` side-channel — never
        added to any energy total, so conservation is untouched."""
        tr = self.tracer
        if tr is None:
            return self._prefill_request(req, precomputed, shared, donor, None)
        with tr.span("serve.prefill", req.uid):
            return self._prefill_request(req, precomputed, shared, donor, tr)

    def _prefill_request(self, req: Request, precomputed, shared: Optional[PrefixHit],
                         donor: Optional["Pool"], tr: Optional[Tracer]) -> Tuple[int, Any]:
        l = len(req.prompt)
        work = l if shared is None else l - shared.prefix_tokens
        self._in_phase_call = True
        self._refresh_gauge()
        t0 = self.clock()
        req.ledger.mark_admitted(t0)
        try:
            if tr is None:
                logits, cache1, _ = self._prefill_issue(req, precomputed, shared, donor)
                first = self._first_token(req, logits[0])
            else:
                launches = prefill_attention.launches
                with tr.span("serve.prefill.issue", req.uid), tr.region("prefill", req.uid):
                    logits, cache1, bucket = self._prefill_issue(req, precomputed, shared,
                                                                 donor)
                    greedy = None if req.temperature > 0.0 else torch.argmax(logits[0])
                with tr.span("serve.prefill.wait", req.uid):
                    first = (self._first_token(req, logits[0]) if greedy is None
                             else int(greedy))
                if bucket is not None:
                    tr.count(prefill_calls=1, prefill_tokens=work,
                             prefill_bucket_tokens=bucket,
                             prefill_attn_launches=prefill_attention.launches - launches)
            if self.virtual and self.prefill_op is not None:
                # modelled prefill duration: the operating point's profile
                # is per prefill_seq tokens — scale to the tokens actually
                # computed (the suffix only, under a prefix hit)
                prof = self.prefill_op.profile
                self.advance_time(prof.t_total * work / max(prof.tokens, 1))
        finally:
            dt = self.clock() - t0
            self._in_phase_call = False
            self._refresh_gauge()
        mj = self._mj_per_token("prefill")
        joules = mj * work / 1e3
        self.stats.merge_prefill(work, dt, joules)
        req.prefill_s += dt
        req.prefill_j += joules
        if shared is not None:
            dp = donor if donor is not None else self
            saved_j = mj * shared.prefix_tokens / 1e3
            req.prefix_tokens = shared.prefix_tokens
            req.saved_prefill_j += saved_j
            dp.prefix_stats.saved_prefill_tokens += shared.prefix_tokens
            dp.prefix_stats.saved_prefill_j += saved_j
        return first, cache1

    def _prefill_issue(self, req: Request, precomputed, shared: Optional[PrefixHit],
                       donor: Optional["Pool"]) -> Tuple[Any, Any, Optional[int]]:
        """Enqueue ``req``'s prefill (or take the event engine's
        ``precomputed`` pair): (logits, cache row, the positions computed,
        None for a precomputed pair)."""
        if precomputed is not None:
            return (*precomputed, None)
        if shared is not None:
            dp = donor if donor is not None else self
            toks, true_len, bucket = self.suffix_tokens(req, shared.prefix_tokens)
            logits, cache1 = dp.shared_prefill(self.params, toks, true_len, shared)
        else:
            toks, true_len, bucket = self.prefill_tokens(req)
            logits, cache1 = self.prefill_rows(toks, true_len)
        self.jit_dispatches += 1
        return logits, cache1, bucket

    def _first_token(self, req: Request, row: torch.Tensor) -> int:
        """The first token from the prefill's last logits row; waits for
        the device."""
        if req.temperature > 0.0:
            # the reference's host-side draw: numpy over the row
            self._key, sub = prng.split(self._key)
            u = prng.uniform(sub, row.shape, device=row.device).cpu().numpy()
            gumbel = -np.log(-np.log(u + 1e-9) + 1e-9)
            return int(np.argmax(row.cpu().numpy() / req.temperature + gumbel))
        return int(torch.argmax(row))

    def _place_bookkeeping(self, req: Request, first_token: int, length: int,
                           first_token_s: Optional[float]) -> int:
        """Everything ``place`` does EXCEPT the cache copy: slot choice,
        host-mirror writes, stamps, gauge. Shared by ``place`` and the
        multi-row ``place_many``."""
        free = self.free_slots()
        if not free:
            raise RuntimeError("place() on a full pool — check can_admit() first")
        self._ensure_decode_state()
        slot = free[0]
        self._host_lengths[slot] = length
        self._host_cur_token[slot] = first_token
        self._admit_counter += 1
        self._admit_seq[slot] = self._admit_counter
        self._slot_temp[slot] = req.temperature
        req.output.append(first_token)
        req.ledger.mark_first_token(
            self.clock() if first_token_s is None else first_token_s)
        self.slot_req[slot] = req
        self.peak_occupancy = max(self.peak_occupancy, self.occupancy())
        self._refresh_gauge()
        return slot

    @torch.inference_mode()
    def place(self, req: Request, cache1: Any, first_token: int, length: int,
              *, first_token_s: Optional[float] = None,
              shared: Optional[PrefixHit] = None) -> int:
        """Move a filled batch-1 cache row into a free slot (migration).

        Dense: the row is copied into the slot. Paged: the request's block
        table is allocated first and the row's blocks are copied to those
        pages (copy-on-migrate); the reference also writes the unused
        blocks to the null page, which holds nothing anyone reads, so they
        are skipped here. Every copy writes into the cache's own storage,
        on the current stream: a captured decode graph reads these very
        tensors. A ``BankRow`` cache is a tree of views of the bank, so the
        copy writes through to the bank, as the reference's bank scatter
        does. ``first_token_s`` overrides the first-token stamp: with
        per-pool clocks the prefill timeline produced the token at its own
        time.

        With ``shared`` (the hit ``prefix_acquire`` pinned for this
        request; re-found from the pool's stash when not passed), the
        leading table entries are the hit's pages — already referenced by
        ``req.uid``, so nothing is allocated or copied for them, and the
        bytes the migration avoided are banked in ``prefix_stats``."""
        tr = self.tracer
        if tr is None:
            slot = self._place_bookkeeping(req, first_token, length, first_token_s)
            self._place_row(req, slot, cache1, length, shared)
            return slot
        with tr.span("serve.place", req.uid):
            slot = self._place_bookkeeping(req, first_token, length, first_token_s)
            with tr.region("place", req.uid):
                self._place_row(req, slot, cache1, length, shared)
            return slot

    def _place_row(self, req: Request, slot: int, cache1: Any, length: int,
                   shared: Optional[PrefixHit]) -> None:
        """``place``'s copy of the row into ``slot`` (its pages first, for
        the paged cache)."""
        if self.paged:
            if shared is None and self._prefix is not None:
                shared = self._pending_hits.get(req.uid)
            bs = self.kv_block_size
            nb = self.block_tables.shape[1]
            need = self.allocator.blocks_for_tokens(length + 1)
            se = shared.shared_entries if shared is not None else 0
            blocks = self._alloc_blocks(need - se, owner=req.uid)
            self.block_tables[slot] = NULL_PAGE
            if se:
                self.block_tables[slot, :se] = shared.table_blocks
                self._pending_hits.pop(req.uid, None)
            self.block_tables[slot, se:need] = blocks
            pages = self._tensor(np.asarray(blocks, np.int64))
            for (big_blk, key, is_paged), (small_blk, _, _) in zip(
                    _leaves(self.cache, self._layout), _leaves(cache1, self._layout)):
                small = small_blk[key][:, 0]                   # (n_units, L_max, ...)
                if is_paged:
                    rows = small.reshape(small.shape[0], nb, bs, *small.shape[2:])
                    big_blk[key][:, pages] = rows[:, se:need]  # shared pages: never written
                else:
                    big_blk[key][:, slot] = small
            # copy-on-migrate moves the PRIVATE blocks of KV into the pool;
            # shared entries move nothing (the avoided bytes are metered)
            npriv = need - se
            self.traffic.count_writes(
                npriv, npriv * bs * self._kv_token_bytes + self._state_write_bytes,
            )
            if se:
                self.prefix_stats.saved_migrate_bytes += se * bs * self._kv_token_bytes
        else:
            for (big_blk, key, _), (small_blk, _, _) in zip(
                    _leaves(self.cache, self._layout), _leaves(cache1, self._layout)):
                big_blk[key][:, slot] = small_blk[key][:, 0]
        self.jit_dispatches += 1

    @torch.inference_mode()
    def place_many(self, items: Sequence[Tuple[Request, Any, int, int,
                                               Optional[float]]]) -> List[int]:
        """Place K prefilled rows with ONE scatter per cache leaf (dense
        pools). ``items`` are (req, cache1, first_token, length,
        first_token_s) in placement order; per-request bookkeeping, stamps
        and gauge updates run request by request exactly like K ``place``
        calls — only the K copies fuse (distinct slots, so the final cache
        is the same). Exactly the K rows are scattered: the reference pads
        to a power of two to reuse a jitted program, which eager PyTorch
        has none of. A ``BankRow`` cache takes the rows through its views,
        into the bank. Paged pools fall back to sequential ``place`` (block
        allocation is request-granular)."""
        if self.paged or len(items) == 1:
            return [self.place(req, cache1, first, length, first_token_s=ts)
                    for req, cache1, first, length, ts in items]
        slots = [self._place_bookkeeping(req, first, length, ts)
                 for req, cache1, first, length, ts in items]
        rows = [cache1 for _, cache1, _, _, _ in items]
        index = self._tensor(np.asarray(slots, np.int64))
        for (big_blk, key, _), *smalls in zip(
                _leaves(self.cache, self._layout),
                *(_leaves(c1, self._layout) for c1 in rows)):
            big_blk[key][:, index] = torch.cat([blk[key] for blk, _, _ in smalls], dim=1)
        self.jit_dispatches += 1
        return slots

    def _req_eos(self, req: Request) -> int:
        return self.eos_token_id if req.eos_token_id is None else req.eos_token_id

    def _decode_begin(self, *, keep_view: bool = False, ship: bool = True) -> Optional[dict]:
        """Host-side first half of ``decode_once``: block-table growth,
        copy-on-write splits, active mask, and the host mirrors copied into
        the step's static inputs. ``None`` when no slot is live. The event
        engine composes this with ``_run_decode_fn`` and ``_decode_finish``
        to step many pools in one fused dispatch.

        A cache held as a ``BankRow`` view is materialised here by default,
        so that the pool's own step reads its own cache; the batched engine
        path passes ``keep_view=True``, steps the bank itself and reads the
        host mirrors, so nothing is shipped to the pool's inputs. With
        ``ship=False`` the caller ships them (``_ship_step_inputs``)."""
        if self.paged and any(r is not None for r in self.slot_req):
            self._grow_tables()
            if self._prefix is not None:
                self._cow_guard()
        active = self.active_mask()
        if not active.any():
            return None
        if not keep_view:
            self.materialize_cache()
        self._ensure_decode_state()
        self._key, sub = prng.split(self._key)
        t0 = self.clock()
        pre = {"active": active, "t0": t0, "temps": self._slot_temp.copy(), "key": sub}
        if ship and not keep_view:
            self._ship_step_inputs(active)
        return pre

    def _ship_step_inputs(self, active: np.ndarray) -> None:
        """Copy the host mirrors into the step's static inputs."""
        # ship the host mirrors once per step (placements only wrote numpy).
        # The staging buffers are written again only after the step's
        # result was read back (``_decode_finish`` waits for the device),
        # so the asynchronous copies out of them have finished by then.
        host = self._step_host
        host["tokens"].numpy()[:] = self._host_cur_token
        host["lengths"].numpy()[:] = self._host_lengths
        if self.paged:
            host["active"].numpy()[:] = active
            host["tables"].numpy()[:] = self.block_tables
        if self._step_in is not host:
            for key, dst in self._step_in.items():
                dst.copy_(host[key], non_blocking=True)

    def _decode_fn(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The decode step over the static inputs and the pool's cache
        (updated in place): (logits (B, V) fp32, greedy (B,) int32). This
        is the function a CUDA graph captures."""
        s = self._step_in
        if self.paged:
            logits, _, _ = decode_step_paged(self.params, self.cfg, s["tokens"], self.cache,
                                             s["lengths"], s["active"], s["tables"])
        else:
            logits, _, _ = decode_step(self.params, self.cfg, s["tokens"], self.cache,
                                       s["lengths"])
        return logits, torch.argmax(logits, dim=-1).to(torch.int32)

    @torch.inference_mode()
    def decode_once(self) -> List[Request]:
        """One decode step over all slots; returns finished requests.

        Paged pools grow/evict block tables first, then account the step's
        traffic block-accurately and derive decode joules from it."""
        if self.tracer is not None:
            return self._decode_once_traced(self.tracer)
        pre = self._decode_begin()
        if pre is None:
            return []
        # the host mirror ``_host_lengths`` stays the authority on lengths;
        # the cache is updated in place
        logits, greedy = self._run_decode_fn()
        self.jit_dispatches += 1
        next_tok = self._sample(logits, greedy, pre["temps"], pre["key"])
        return self._decode_finish(pre, next_tok.cpu().numpy())   # waits for the device

    def _decode_once_traced(self, tr: Tracer) -> List[Request]:
        """``decode_once`` in spans, its device work in one region. The
        region opens once the input copies are enqueued: enqueueing them
        one by one is host time the device waits through (about 0.1 ms a
        step on an H100's host), and counts as a gap."""
        with tr.span("serve.decode"):
            with tr.span("serve.decode.begin"):
                pre = self._decode_begin(ship=False)
            if pre is None:
                return []
            with tr.span("serve.decode.replay"):
                graph = self._graph
                self._ship_step_inputs(pre["active"])
                with tr.region("decode"):
                    logits, greedy = self._run_decode_fn()
                    next_tok = self._sample(logits, greedy, pre["temps"], pre["key"])
                self.jit_dispatches += 1
                next_np = next_tok.cpu().numpy()
            tr.count(decode_steps=1, decode_rows=int(pre["active"].sum()),
                     graph_captures=int(self._graph is not graph))
            with tr.span("serve.decode.finish"):
                return self._decode_finish(pre, next_np)

    def _decode_finish(self, pre: dict, next_np: np.ndarray) -> List[Request]:
        """Second half of ``decode_once``: take the step's sampled tokens
        (read back to the host), advance the (virtual) clock by the
        modelled step duration, and do the per-slot token/energy/EOS
        accounting."""
        active = pre["active"]
        t0 = pre["t0"]
        finished: List[Request] = []
        if self.virtual and self.op is not None:
            # the modelled step duration at the live operating point IS the
            # virtual-time cost of this decode step
            self.advance_time(self.op.profile.t_total)
        dt = self.clock() - t0
        n_active = int(active.sum())
        # keep the host mirror in lock-step with the device vector; copy
        # because placements mutate it in place before the next step
        self._host_cur_token = np.array(next_np, dtype=np.int32)

        # ---- energy + traffic attribution for this step ------------------
        mj = self._mj_per_token()
        per_req_j = {}
        read_total = write_total = 0
        if self.paged:
            bs = self.kv_block_size
            block_bytes = bs * self._kv_token_bytes
            blocks_touched = 0
            power = self.op.power_w if self.op is not None else 0.0
            for i, req in enumerate(self.slot_req):
                if req is None:
                    continue
                nb_i = int(self._host_lengths[i]) // bs + 1   # incl. write block
                read_i = nb_i * block_bytes + self._state_read_bytes \
                    + self._weight_bytes // n_active           # amortised weights
                write_i = self._kv_token_bytes + self._state_write_bytes
                blocks_touched += nb_i
                read_total += read_i
                write_total += write_i
                req.decode_read_bytes += read_i
                req.decode_write_bytes += write_i
                if self.hbm_bw_eff > 0 and self.op is not None:
                    per_req_j[i] = joules_from_hbm_traffic(
                        power, read_i + write_i, self.hbm_bw_eff
                    )
            self.traffic.count_reads(blocks_touched, read_total)
            self.traffic.count_writes(n_active, write_total)
            self.traffic.count_step()
        step_j = sum(per_req_j.values()) if per_req_j else mj * n_active / 1e3
        self.stats.merge_decode(n_active, dt, step_j, read_total, write_total)

        now = self.clock()
        for i, req in enumerate(self.slot_req):
            if req is None:
                continue
            self._host_lengths[i] += 1
            req.decode_s += dt / max(n_active, 1)
            req.decode_j += per_req_j.get(i, mj / 1e3)
            tok = int(next_np[i])
            req.output.append(tok)
            req.ledger.mark_token(now)
            if tok == self._req_eos(req) or len(req.output) >= req.max_new_tokens:
                req.done = True
                req.ledger.mark_finish(now)
                finished.append(req)
                self.slot_req[i] = None
                self._slot_temp[i] = 0.0
                if self.paged:
                    if self._prefix is not None:
                        # donate the transcript to the index BEFORE freeing:
                        # newly-retained pages survive the request's free
                        self._register_finished(req, i)
                    self.allocator.free(self._slot_blocks(i), owner=req.uid)
                    self.block_tables[i] = NULL_PAGE
                    self._host_lengths[i] = 0
        if finished:
            self._refresh_gauge()
        return finished

    # --------------------------------------------------------------- defrag
    @torch.inference_mode()
    def defrag(self):
        """Compact live blocks to the lowest page ids: remap every slot's
        table and physically move the pages in one gather per leaf. Decode
        output is invariant (paging is pure layout)."""
        if not self.paged or self.cache is None:
            return
        mapping = self.allocator.defrag()
        if self._prefix is not None:
            # every held page is live, so it appears in the mapping; each
            # trie entry (and stashed hit) is rewritten exactly once
            self._prefix.remap(mapping)
            for hit in self._pending_hits.values():
                hit.full_blocks = [mapping[b] for b in hit.full_blocks]
                if hit.tail_block is not None:
                    hit.tail_block = mapping[hit.tail_block]
        remap = np.arange(self.allocator.num_blocks + 1)
        for old, new in mapping.items():
            remap[old] = new
        self.block_tables = np.where(
            self.block_tables != NULL_PAGE, remap[self.block_tables], NULL_PAGE
        ).astype(np.int32)
        # perm[new_page] = old_page; untouched ids map identity (their
        # contents are dead anyway once the allocator freed them)
        perm = np.arange(self.allocator.num_blocks + 1)
        for old, new in mapping.items():
            perm[new] = old
        perm_t = self._tensor(perm)
        # in place: a captured decode graph reads these very tensors
        for blk, key, is_paged in _leaves(self.cache, self._layout):
            if is_paged:
                blk[key].copy_(blk[key][:, perm_t])
