"""Device layer: 1 - the union of the device's operation intervals over
the profiled stretch's wall time, in %."""


def read(rec):
    prof = rec.get("profile")
    return (1.0 - prof["busy_s"] / prof["window_s"]) * 100.0 if prof else None
