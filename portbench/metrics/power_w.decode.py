"""Device layer: mean nvidia-smi power.draw over the window (W)."""


def read(rec):
    power = rec.get("power") or {}
    return power["power_w"] if power.get("samples") else None
