"""Pool prefill layer: the share of the window spent in admission
prefills (``PhaseStats.prefill_s``), during which every live decode
waits (%)."""
from portbench.stats import delta


def read(rec):
    return delta(rec, "prefill_s") / rec["window_s"] * 100.0
