"""The port's one device "mesh": a single H100.

Counterpart of ``repro.launch.mesh`` for one card: the dry run records its
cells under ``H100X1`` (``h100x1``, one device), and ``roofline_report``
prices that mesh's cells with ``H100_SXM``. The reference's production
meshes (16x16 and 2x16x16 TPU pods, ``make_production_mesh``), its
sharding rules (``launch/sharding.py``) and its collective schedule
(``launch/hlo_stats.py``) have no counterpart here: on one card nothing is
sharded, there are no collectives, and every batch axis is trivial. They
wait for a multi-card round.
"""
from __future__ import annotations

from typing import NamedTuple


class Mesh(NamedTuple):
    name: str
    n_devices: int


H100X1 = Mesh("h100x1", 1)
