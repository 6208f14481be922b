"""95th percentile of every gap between consecutive output tokens of every
request, the later token stamped in the window (ms)."""
from portbench.stats import percentile


def read(rec):
    return percentile(rec["gaps_ms"], 95)
