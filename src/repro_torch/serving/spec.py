"""Declarative serving specs: replicas and fleets as validated data.

The fleet API is spec-first: a ``FleetSpec`` is a plain, JSON-round-trippable
description of N serving replicas — which architecture each runs, its
slot/page budget, its clock mode (``default``/``cap``/``lock``/``slo``) and
controller settings — plus the routing policy in front of them. Builders
(``Fleet.from_spec``, ``Cluster.from_spec``, ``ServingEngine.from_spec``)
turn a spec into live pools; everything runtime-shaped (parameters, the
energy model, the clock) stays out of the spec so one spec can drive a
reduced CPU replay and a full-scale run alike.

Hierarchy::

    FleetSpec
      ├── router: "jsq" | "energy" | "affinity"  (+ router_args)
      ├── autoscaler: AutoscalerSpec | None      (queue- or forecast-driven
      │                                           drain/power-up policy)
      └── replicas: (ReplicaSpec, ...)
            ├── arch, name, max_seq_len, prefill_chunk_tokens, rng_seed
            ├── clock:   ClockSpec  (mode + ClockController settings)
            ├── prefill: PoolSpec   (batch / page budget)
            └── decode:  PoolSpec

Every level validates on construction and fails loudly; ``to_json`` /
``from_json`` round-trip exactly (``FleetSpec.from_json(s.to_json()) == s``).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Tuple

CLOCK_MODES = ("default", "cap", "lock", "slo")


def _require(cond: bool, msg: str):
    if not cond:
        raise ValueError(msg)


@dataclasses.dataclass(frozen=True)
class PoolSpec:
    """Slot/page budget for one phase pool."""

    batch: int = 8
    paged: bool = False
    kv_block_size: int = 16
    kv_blocks: Optional[int] = None     # None -> dense-equivalent budget
    # copy-on-write prefix sharing (repro.serving.prefix): decode pools
    # only, requires paged — default off so existing specs replay
    # byte-identically
    prefix_sharing: bool = False

    def __post_init__(self):
        _require(self.batch >= 1, f"PoolSpec.batch must be >= 1, got {self.batch}")
        _require(self.kv_block_size >= 1,
                 f"PoolSpec.kv_block_size must be >= 1, got {self.kv_block_size}")
        _require(self.kv_blocks is None or self.kv_blocks >= 1,
                 f"PoolSpec.kv_blocks must be >= 1 or None, got {self.kv_blocks}")
        _require(not self.prefix_sharing or self.paged,
                 "PoolSpec.prefix_sharing requires paged=True")

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PoolSpec":
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class ClockSpec:
    """Clock mode + ``ClockController`` settings, as data.

    Field names mirror the controller's keyword arguments one-to-one, so
    ``ClockController(emodel, arch_cfg, **spec.controller_kwargs())`` is the
    whole build step.
    """

    mode: str = "lock"
    budget: float = 0.01
    context: int = 1024
    long_context: int = 16384
    batch_hi_threshold: int = 8
    prefill_seq: int = 4096
    cap_w: Optional[float] = None
    fused: bool = False
    context_scale: float = 1.0
    slo_ttft_s: float = 2.0
    slo_tbt_s: float = 0.25
    slo_slack: float = 0.9
    slo_percentile: float = 99.0
    slo_window: int = 512
    slo_min_obs: int = 48
    slo_step_mhz: float = 60.0

    def __post_init__(self):
        _require(self.mode in CLOCK_MODES,
                 f"ClockSpec.mode {self.mode!r} not in {CLOCK_MODES}")
        _require(self.context >= 1 and self.long_context >= self.context,
                 "ClockSpec needs 1 <= context <= long_context")
        _require(self.context_scale > 0, "ClockSpec.context_scale must be > 0")
        _require(self.slo_ttft_s > 0 and self.slo_tbt_s > 0,
                 "ClockSpec SLO targets must be > 0")

    def controller_kwargs(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ClockSpec":
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class AutoscalerSpec:
    """Queue-aware / forecast-driven drain & power-up policy, as data.

    ``policy`` names an entry in ``repro.serving.autoscaler.AUTOSCALERS``:

    * ``queue``    — reactive: power a replica up when the rolling
      queue-delay p95 breaches ``queue_p95_target_s``; drain one after the
      signal has held ``slack`` headroom for a full ``hold_s`` window.
    * ``schedule`` — anticipatory: a Holt (EWMA level + trend) arrival-rate
      forecast at horizon ``warmup_s + lead_s`` powers replicas up *ahead*
      of diurnal peaks so they are warm when the ramp lands.

    ``warmup_s`` is the modelled warm-up cost both policies amortise: a
    powering-up replica draws idle-floor watts for that long while
    admitting nothing (the joules land in the fleet ledger, attributed via
    a ``power_up`` Transition — warm-up is never free).
    """

    policy: str = "queue"
    min_replicas: int = 1
    max_replicas: int = 0               # 0 -> the whole fleet
    warmup_s: float = 0.0
    tick_interval_s: float = 0.0        # min seconds between evaluations
    hold_s: float = 1.0                 # sustained-slack window before any
                                        # scale-down (the anti-flap gate)
    # ---- queue policy ----------------------------------------------------
    queue_p95_target_s: float = 1.0
    slack: float = 0.5                  # scale down only below slack*target
    window_s: float = 30.0              # rolling queue-delay window
    # ---- schedule policy -------------------------------------------------
    sample_interval_s: float = 1.0      # arrival-rate sampling cadence
    ewma_alpha: float = 0.3             # Holt level smoothing
    trend_beta: float = 0.2             # Holt trend smoothing
    replica_rps: float = 1.0            # modelled per-replica capacity
    target_utilisation: float = 0.75    # fill replicas to this fraction
    lead_s: float = 0.0                 # anticipation beyond the warm-up

    def __post_init__(self):
        from repro_torch.serving.autoscaler import AUTOSCALERS
        _require(self.policy in AUTOSCALERS,
                 f"unknown autoscaler policy {self.policy!r}; "
                 f"have {sorted(AUTOSCALERS)}")
        _require(self.min_replicas >= 1,
                 f"AutoscalerSpec.min_replicas must be >= 1, got {self.min_replicas}")
        _require(self.max_replicas == 0 or self.max_replicas >= self.min_replicas,
                 "AutoscalerSpec.max_replicas must be 0 (whole fleet) or >= min_replicas")
        _require(self.warmup_s >= 0 and self.tick_interval_s >= 0
                 and self.hold_s >= 0 and self.lead_s >= 0,
                 "AutoscalerSpec durations must be >= 0")
        _require(self.queue_p95_target_s > 0 and self.window_s > 0
                 and self.sample_interval_s > 0,
                 "AutoscalerSpec signal windows/targets must be > 0")
        _require(0.0 < self.slack < 1.0, "AutoscalerSpec.slack must be in (0, 1)")
        _require(0.0 < self.ewma_alpha <= 1.0 and 0.0 <= self.trend_beta <= 1.0,
                 "AutoscalerSpec needs 0 < ewma_alpha <= 1 and 0 <= trend_beta <= 1")
        _require(self.replica_rps > 0, "AutoscalerSpec.replica_rps must be > 0")
        _require(0.0 < self.target_utilisation <= 1.0,
                 "AutoscalerSpec.target_utilisation must be in (0, 1]")

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "AutoscalerSpec":
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class ReplicaSpec:
    """One prefill/decode replica pair: arch + budgets + clock policy."""

    name: str
    arch: str
    clock: ClockSpec = ClockSpec()
    prefill: PoolSpec = PoolSpec(batch=1)
    decode: PoolSpec = PoolSpec()
    max_seq_len: int = 4096
    prefill_chunk_tokens: int = 256
    rng_seed: int = 0
    # serve the tiny same-family config (CPU replays); the controller's
    # policy table always resolves against the FULL config either way
    reduced: bool = True

    def __post_init__(self):
        _require(bool(self.name), "ReplicaSpec.name must be non-empty")
        _require(self.max_seq_len >= 1, "ReplicaSpec.max_seq_len must be >= 1")
        _require(self.prefill_chunk_tokens >= 1,
                 "ReplicaSpec.prefill_chunk_tokens must be >= 1")
        if self.decode.paged:
            _require(self.max_seq_len % self.decode.kv_block_size == 0,
                     f"max_seq_len {self.max_seq_len} not a multiple of the "
                     f"decode pool's kv_block_size {self.decode.kv_block_size}")
        # fail at spec time, not build time, on an unknown architecture
        from repro_torch.configs import get_config
        get_config(self.arch)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ReplicaSpec":
        d = dict(d)
        d["clock"] = ClockSpec.from_dict(d.get("clock", {}))
        d["prefill"] = PoolSpec.from_dict(d.get("prefill", {"batch": 1}))
        d["decode"] = PoolSpec.from_dict(d.get("decode", {}))
        return cls(**d)


# EventDrivenFleet constructor options a FleetSpec may pin (runtime-only
# options like on_finish stay out: a spec must stay JSON-round-trippable)
ENGINE_OPT_KEYS = (
    "fast_path_min", "fusion_quantum_s", "fuse_prefill", "max_fused_group",
    "fused_cache_cap", "batch_replicas", "batch_layout", "time_dispatch",
)


@dataclasses.dataclass(frozen=True)
class FleetSpec:
    """N replicas + the routing policy in front of them.

    ``engine_opts`` pins default ``EventDrivenFleet`` options for
    ``run_trace(engine="events")`` replays of this spec (e.g.
    ``{"batch_replicas": False}`` to opt a fleet out of the batched replica
    axis, or a ``fusion_quantum_s`` tuned to its drift); per-call
    ``engine_opts`` still override key-by-key."""

    replicas: Tuple[ReplicaSpec, ...]
    router: str = "jsq"
    router_args: Dict[str, Any] = dataclasses.field(default_factory=dict)
    autoscaler: Optional[AutoscalerSpec] = None
    engine_opts: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        object.__setattr__(self, "replicas", tuple(self.replicas))
        _require(len(self.replicas) >= 1, "FleetSpec needs at least one replica")
        names = [r.name for r in self.replicas]
        _require(len(set(names)) == len(names),
                 f"FleetSpec replica names must be unique, got {names}")
        bad = sorted(set(self.engine_opts) - set(ENGINE_OPT_KEYS))
        _require(not bad,
                 f"unknown FleetSpec.engine_opts keys {bad}; "
                 f"have {sorted(ENGINE_OPT_KEYS)}")
        try:
            json.dumps(self.engine_opts)
        except (TypeError, ValueError):
            _require(False, "FleetSpec.engine_opts values must be "
                            "JSON-serializable")
        from repro_torch.serving.router import ROUTERS
        _require(self.router in ROUTERS,
                 f"unknown router {self.router!r}; have {sorted(ROUTERS)}")
        if self.autoscaler is not None:
            _require(self.autoscaler.min_replicas <= len(self.replicas),
                     f"autoscaler min_replicas {self.autoscaler.min_replicas} "
                     f"exceeds the fleet size {len(self.replicas)}")
            _require(self.autoscaler.max_replicas <= len(self.replicas),
                     f"autoscaler max_replicas {self.autoscaler.max_replicas} "
                     f"exceeds the fleet size {len(self.replicas)}")

    # ------------------------------------------------------------- json i/o
    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self, **kw) -> str:
        kw.setdefault("sort_keys", True)
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FleetSpec":
        d = dict(d)
        d["replicas"] = tuple(
            ReplicaSpec.from_dict(r) for r in d.get("replicas", ()))
        if d.get("autoscaler") is not None:
            d["autoscaler"] = AutoscalerSpec.from_dict(d["autoscaler"])
        return cls(**d)

    @classmethod
    def from_json(cls, blob: str) -> "FleetSpec":
        return cls.from_dict(json.loads(blob))

    def replica(self, name: str) -> ReplicaSpec:
        for r in self.replicas:
            if r.name == name:
                return r
        raise KeyError(f"no replica named {name!r}; have "
                       f"{[r.name for r in self.replicas]}")
