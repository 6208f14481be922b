"""Serving stack of the port: phase pool, colocated engine, paged-cache
allocator and the DVFS clock controller."""
from repro_torch.serving.controller import ClockController, Transition
from repro_torch.serving.engine import EOS, PhaseStats, Request, ServingEngine
from repro_torch.serving.paged_cache import NULL_PAGE, BlockAllocator, TrafficCounter
from repro_torch.serving.pool import Pool

__all__ = [
    "ClockController", "Transition",
    "EOS", "PhaseStats", "Request", "ServingEngine",
    "NULL_PAGE", "BlockAllocator", "TrafficCounter",
    "Pool",
]
