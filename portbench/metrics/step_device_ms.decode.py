"""Model layer (``decode_step_paged`` replayed from the pool's CUDA graph):
mean device ms of the window's graph replays, CUDA events around each."""


def read(rec):
    ms = [m for m, _ in rec.get("replays", [])]
    return sum(ms) / len(ms) if ms else None
