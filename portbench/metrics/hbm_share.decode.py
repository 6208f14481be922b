"""Model layer: the bytes the window's decode steps had to move (weights
once a step, each live row's cached K/V read once and its new row written
once, from the live lengths) over 3.35e12 B/s, as a share of the steps'
device time (CUDA events), in %."""
from portbench.counts import HBM_BYTES_PER_S, step_counts


def read(rec):
    reps = [(ms, ln) for ms, ln in rec.get("replays", []) if len(ln)]
    if not reps:
        return None
    step = step_counts(rec["arch"]).decode_step
    need_s = sum(step(rec["cfg"], ln).bytes for _, ln in reps) / HBM_BYTES_PER_S
    return need_s / (sum(ms for ms, _ in reps) / 1e3) * 100.0
