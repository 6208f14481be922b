"""Pool step-graph layer (``Pool.decode_once``): the mean decode step's
host-clock ms (``PhaseStats.decode_s / decode_steps``) less its replay's
device ms: what the host adds to a step."""
from portbench.stats import delta


def read(rec):
    ms = [m for m, _ in rec.get("replays", [])]
    steps = delta(rec, "decode_steps")
    if not ms or not steps:
        return None
    return delta(rec, "decode_s") / steps * 1e3 - sum(ms) / len(ms)
