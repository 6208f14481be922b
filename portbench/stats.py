"""Order statistics and step sums the metric readers share."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def percentile(values: Sequence[Optional[float]], q: float) -> Optional[float]:
    """The ``q``-th percentile (linear interpolation) of the values that
    are there, or None when there are none."""
    xs = [v for v in values if v is not None]
    return float(np.percentile(xs, q)) if xs else None


def delta(rec: dict, key: str) -> float:
    """How far a ``PhaseStats`` field moved over the window."""
    return rec["phase_close"][key] - rec["phase_open"][key]


def window_ops(rec: dict) -> Optional[float]:
    """Model operations done in the window: every decode step replayed in
    it at its rows' live lengths, and every prefill admitted in it at its
    true prompt length (not its bucket)."""
    from portbench.counts import step_counts

    if "replays" not in rec:
        return None
    sc = step_counts(rec["arch"])
    ops = sum(sc.decode_step(rec["cfg"], ln).ops for _, ln in rec["replays"] if len(ln))
    ops += sum(sc.prefill(rec["cfg"], n).ops for n in rec["prefill_lens"])
    return float(ops)
