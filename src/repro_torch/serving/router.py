"""Pluggable request routing over a fleet of serving replicas.

A ``Router`` picks, per arriving request, which replica's waiting queue to
join. Candidates are the *routable* replicas (powered up, not draining) in
fleet order; every policy is a deterministic pure function of the visible
replica state plus the request's (prompt_len, max_new_tokens, bucket), so
seeded trace replays stay byte-identical.

Policies:

* ``jsq`` — join-shortest-queue: the load-balancing baseline. Minimises
  queued + in-flight work; ties break on fleet order.
* ``energy`` — energy-aware placement: route to the replica whose current
  operating point predicts the lowest marginal joules/token for this
  request's length profile (probed through the replica's own
  ``ClockController``, so DVFS mode and live occupancy are priced in).
  Because energy/token *falls* with batch occupancy (weight streaming
  amortises), this policy consolidates load onto few replicas instead of
  spreading it — the opposite instinct to JSQ, and the lever behind the
  "power a replica down vs underclock all of them" question. A headroom
  gate keeps it from queueing unboundedly: replicas already holding a full
  batch worth of work are skipped while any open one remains.
* ``rr`` — round-robin: the O(1) scale baseline. Every other policy
  inspects all N candidates per arrival, which at 10^6 requests over 100+
  replicas is 10^8+ Python comparisons before any model work; round-robin
  cycles fleet order with a single cursor. On aligned waves it lands one
  request per replica exactly like JSQ, without the scan.
* ``affinity`` — arch-affinity: length-bucketed dispatch across
  heterogeneous replicas keyed off the trace's ``bucket`` tag. Long-context
  requests go to the architecture whose energy curve is flattest there
  (GDN/Mamba-class: O(1) state, no KV growth), short-chat to the arch
  cheapest at short context (GQA-class); rankings come from each replica
  controller's policy-table operating points, not hard-coded preferences.

``make_router(name, **kwargs)`` builds from the ``ROUTERS`` registry — the
string a ``FleetSpec.router`` field names.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, List, Protocol, Sequence

if TYPE_CHECKING:                       # only for type hints; no import cycle
    from repro_torch.serving.fleet import Replica


class Router(Protocol):
    """Routing policy: pick the replica an arriving request joins."""

    name: str

    def route(self, candidates: Sequence["Replica"], *, prompt_len: int,
              max_new_tokens: int, bucket: str = "mixed",
              prompt=None) -> "Replica":
        """Return one of ``candidates`` (never empty; fleet order).
        ``prompt`` (token ids, may be None) feeds content-aware policies;
        length/bucket-only policies ignore it."""
        ...


def prefer_warm(candidates: Sequence["Replica"]) -> List["Replica"]:
    """Scale-awareness shared by every policy: a replica inside its
    autoscaler warm-up window draws power but admits nothing, so route to
    warm replicas while any exists; only when every candidate is warming
    does work queue at one (it admits once the window elapses). Draining
    replicas never reach a router — the fleet filters them out of the
    candidate set before routing."""
    warm = [r for r in candidates if not r.warming()]
    return warm if warm else list(candidates)


def _jsq_pick(candidates: Sequence["Replica"]) -> "Replica":
    # min() is stable: the first minimal candidate (fleet order) wins ties
    return min(candidates, key=lambda r: r.queue_depth())


class JoinShortestQueue:
    """Load-balancing baseline: least queued + in-flight work wins."""

    name = "jsq"

    def route(self, candidates, *, prompt_len, max_new_tokens,
              bucket="mixed", prompt=None):
        return _jsq_pick(prefer_warm(candidates))


class RoundRobin:
    """O(1) routing for million-request replays: cycle fleet order.

    The cursor advances over replica NAMES, not candidate indices, so a
    replica joining/leaving the candidate set (autoscaler power events)
    shifts no other replica's turn; a vanished candidate just falls
    through to the next. Deterministic: a pure function of the arrival
    sequence and the candidate sets it saw."""

    name = "rr"

    def __init__(self):
        self._next = 0

    def route(self, candidates, *, prompt_len, max_new_tokens,
              bucket="mixed", prompt=None):
        cands = prefer_warm(candidates)
        pick = cands[self._next % len(cands)]
        self._next += 1
        return pick


class EnergyAware:
    """Lowest predicted marginal joules/token, with a queue-headroom gate.

    ``headroom`` scales the gate: a replica is *open* while its queue depth
    (waiting + in flight) is below ``headroom x decode slots``; once every
    candidate is saturated the policy degrades to JSQ, so overload never
    queues unboundedly behind the energetically-cheapest replica.
    """

    name = "energy"

    def __init__(self, headroom: float = 1.0):
        if headroom <= 0:
            raise ValueError("headroom must be > 0")
        self.headroom = headroom

    def _marginal_mj(self, replica: "Replica", prompt_len: int,
                     max_new_tokens: int) -> float:
        """Joules this replica's controller predicts for the whole request —
        prefill of the prompt plus the decode budget — at the occupancy and
        context it would hold after admitting it. Both phases count: cheap
        flat decode must not win long-prompt traffic past a brutal prefill."""
        ctl = replica.controller
        pool = replica.decode_pool
        occ = min(pool.occupancy() + len(replica.waiting) + 1, pool.max_batch)
        # mean live context over the request's decode: prompt + half budget
        ctx = float(prompt_len + max_new_tokens / 2.0)
        dec = ctl.operating_point("decode", occ, ctx)
        pre = ctl.operating_point("prefill", 1, ctx)
        return (prompt_len * pre.profile.energy_per_token_mj
                + max_new_tokens * dec.profile.energy_per_token_mj)

    def route(self, candidates, *, prompt_len, max_new_tokens,
              bucket="mixed", prompt=None):
        candidates = prefer_warm(candidates)
        if any(r.controller is None for r in candidates):
            return _jsq_pick(candidates)        # nothing to price with
        open_ = [r for r in candidates
                 if r.queue_depth() < self.headroom * r.decode_pool.max_batch]
        if not open_:
            return _jsq_pick(candidates)
        return min(open_, key=lambda r: (
            self._marginal_mj(r, prompt_len, max_new_tokens),
            r.queue_depth(),
        ))


class ArchAffinity:
    """Length-bucketed dispatch across heterogeneous architectures.

    Replicas are ranked by their controller's modelled whole-request joules
    (``ClockController.request_energy_mj``) at the bucket's policy column —
    short-tagged requests priced at the batched short-context regime, long
    ones at the batched long-context regime, prefill included. The trace
    tag picks the column, the energy model picks the arch: long-context
    goes to the flattest energy curve (GDN/Mamba-class O(1) state), not to
    a hard-coded preference. Unlike ``energy`` this ranking ignores live
    occupancy — it is a stable arch-dispatch table, softened only by the
    queue-headroom gate (best-ranked replica with room wins; overflow walks
    down the ranking; saturation degrades to JSQ). Untagged (``mixed``)
    requests or controller-less replicas also fall back to JSQ.
    """

    name = "affinity"

    def __init__(self, headroom: float = 1.0):
        if headroom <= 0:
            raise ValueError("headroom must be > 0")
        self.headroom = headroom

    def ranking(self, candidates: Sequence["Replica"], *, prompt_len: int,
                max_new_tokens: int, bucket: str) -> List["Replica"]:
        """Candidates, cheapest modelled whole-request joules first."""
        return sorted(
            candidates,
            key=lambda r: r.controller.request_energy_mj(
                prompt_len, max_new_tokens, bucket),
        )

    def route(self, candidates, *, prompt_len, max_new_tokens,
              bucket="mixed", prompt=None):
        candidates = prefer_warm(candidates)
        if bucket not in ("short", "long") or \
                any(r.controller is None for r in candidates):
            return _jsq_pick(candidates)
        for r in self.ranking(candidates, prompt_len=prompt_len,
                              max_new_tokens=max_new_tokens, bucket=bucket):
            if r.queue_depth() < self.headroom * r.decode_pool.max_batch:
                return r
        return _jsq_pick(candidates)


class PrefixAffinity:
    """Shared-prefix locality: send a request to the replica already
    holding its longest cached prefix.

    Conversation-tree workloads (multi-turn chat, agentic fan-out) reuse a
    trunk of tokens across requests; a prefix-sharing decode pool
    (``PoolSpec.prefix_sharing``) can serve those positions from cached
    pages — but only on the replica that holds them. Candidates are scored
    by ``Pool._peek_fitted`` (non-mutating: no LRU touch, no stats), and
    the best coverage wins when it spans at least one block; ties break on
    queue depth then fleet order, and no meaningful coverage anywhere —
    including fleets with sharing off, where every peek is 0 — degrades to
    JSQ. Deterministic: a pure function of index contents and queue state.
    """

    name = "prefix"

    def route(self, candidates, *, prompt_len, max_new_tokens,
              bucket="mixed", prompt=None):
        candidates = prefer_warm(candidates)
        if prompt is None:
            return _jsq_pick(candidates)
        scored = [(r.decode_pool._peek_fitted(prompt)[1], r)
                  for r in candidates]
        best = max(t for t, _ in scored)
        if best < max(r.decode_pool.kv_block_size for r in candidates):
            return _jsq_pick(candidates)
        leaders = [r for t, r in scored if t == best]
        return _jsq_pick(leaders)


ROUTERS = {
    JoinShortestQueue.name: JoinShortestQueue,
    RoundRobin.name: RoundRobin,
    EnergyAware.name: EnergyAware,
    ArchAffinity.name: ArchAffinity,
    PrefixAffinity.name: PrefixAffinity,
}


def make_router(name: str, **kwargs) -> Router:
    try:
        cls = ROUTERS[name]
    except KeyError:
        raise ValueError(f"unknown router {name!r}; have {sorted(ROUTERS)}") from None
    return cls(**kwargs)
