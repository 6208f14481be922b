"""The card's energy over the window (nvidia-smi power.draw every 100 ms,
mean watts times the window's seconds) over the output tokens of the
window. No power sample: no reading."""


def read(rec):
    power = rec.get("power") or {}
    if not power.get("samples") or not rec["tokens"]:
        return None
    return power["power_w"] * rec["window_s"] / rec["tokens"]
