"""Serving stack of the port: phase pools (dense or paged continuous
batching), the single-pool engine, the phase-disaggregated cluster and —
spec-first — fleets of N heterogeneous replicas behind pluggable routers,
each replica holding its own energy-aware clock controller on one shared
wall or virtual timeline (trace replay on the discrete-event engine, with
an SLO-regulated DVFS loop). Exports the reference's names
(``repro.serving``)."""
from repro_torch.core.clock import VirtualClock
from repro_torch.core.latency import LatencyLedger, LatencySummary, summarize_latency
from repro_torch.core.traces import (
    BUCKETS,
    TracedRequest,
    generate_conversation_trace,
    generate_fanout_trace,
    generate_trace,
)
from repro_torch.serving.autoscaler import (
    AUTOSCALERS,
    Autoscaler,
    QueueAutoscaler,
    ScaleEvent,
    ScheduleAutoscaler,
    make_autoscaler,
)
from repro_torch.serving.cluster import Cluster
from repro_torch.serving.controller import ClockController, Transition
from repro_torch.serving.engine import EOS, PhaseStats, Request, ServingEngine
from repro_torch.serving.events import EngineStats, EventDrivenFleet
from repro_torch.serving.fleet import Fleet, Replica, Scheduler
from repro_torch.serving.paged_cache import NULL_PAGE, BlockAllocator, TrafficCounter
from repro_torch.serving.pool import (
    BankRow,
    CacheBank,
    Pool,
    clear_program_caches,
    params_token_for,
)
from repro_torch.serving.prefix import PrefixHit, PrefixIndex, PrefixStats
from repro_torch.serving.router import (
    ROUTERS,
    ArchAffinity,
    EnergyAware,
    JoinShortestQueue,
    PrefixAffinity,
    RoundRobin,
    Router,
    make_router,
)
from repro_torch.serving.spec import (
    CLOCK_MODES,
    ENGINE_OPT_KEYS,
    AutoscalerSpec,
    ClockSpec,
    FleetSpec,
    PoolSpec,
    ReplicaSpec,
)

__all__ = [
    "EOS",
    "PhaseStats",
    "Request",
    "ServingEngine",
    "Pool",
    "CacheBank",
    "BankRow",
    "clear_program_caches",
    "params_token_for",
    "Cluster",
    "Scheduler",
    "Replica",
    "Fleet",
    "EventDrivenFleet",
    "EngineStats",
    "ClockController",
    "Transition",
    "BlockAllocator",
    "TrafficCounter",
    "NULL_PAGE",
    "VirtualClock",
    "LatencyLedger",
    "LatencySummary",
    "summarize_latency",
    "BUCKETS",
    "TracedRequest",
    "generate_trace",
    "generate_conversation_trace",
    "generate_fanout_trace",
    # prefix sharing
    "PrefixIndex",
    "PrefixHit",
    "PrefixStats",
    # spec layer
    "CLOCK_MODES",
    "ENGINE_OPT_KEYS",
    "PoolSpec",
    "ClockSpec",
    "ReplicaSpec",
    "FleetSpec",
    "AutoscalerSpec",
    # routing
    "Router",
    "ROUTERS",
    "JoinShortestQueue",
    "RoundRobin",
    "EnergyAware",
    "ArchAffinity",
    "PrefixAffinity",
    "make_router",
    # autoscaling
    "Autoscaler",
    "AUTOSCALERS",
    "QueueAutoscaler",
    "ScheduleAutoscaler",
    "ScaleEvent",
    "make_autoscaler",
]
