"""Pool prefill layer (``Pool.prefill_request``, eager bucketed batch 1):
mean host-clock ms of the prefills run in the window (``PhaseStats``;
each ends on the first token's argmax, which waits for the card)."""
from portbench.stats import delta


def read(rec):
    calls = delta(rec, "prefill_calls")
    return delta(rec, "prefill_s") / calls * 1e3 if calls else None
