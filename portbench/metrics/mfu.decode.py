"""Whole step: model operations done in the window (decode steps and
admission prefills at their true lengths) over the window's seconds, as a
share of the card's dense bf16 peak (989e12), in %."""
from portbench.counts import PEAK_OPS
from portbench.stats import window_ops


def read(rec):
    ops = window_ops(rec)
    return ops / rec["window_s"] / PEAK_OPS["bfloat16"] * 100.0 if ops else None
