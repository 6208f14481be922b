"""Engine layer (``ServingEngine.step`` / ``_admit``): median over the
requests due in the window of scheduled arrival to admission (the ledger's
``mark_admitted`` stamp, taken as the request's prefill starts), in ms."""
from portbench.stats import percentile


def read(rec):
    return percentile(rec["queue_ms"], 50)
