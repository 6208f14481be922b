"""95th percentile over the requests due in the window of the time from
each one's scheduled arrival to its first token (ms); a request with no
first token after the drain is counted as failed, not here."""
from portbench.stats import percentile


def read(rec):
    return percentile(rec["ttft_ms"], 95)
