"""Process start to the window's opening: imports, weights drawn on the
device, the engine built, every prefill bucket and the graph warmed up, a
closed loop's first wave admitted."""


def read(rec):
    return rec["setup_s"]
