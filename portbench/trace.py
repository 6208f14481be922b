"""The traced stretch of a ``--trace 1`` run: ``torch.profiler`` around a
few seconds of serving, read into the device's busy time, its operations
by name, and its idle gaps labelled by the harness span the host was in.

The harness names the host's activity with ``record_function`` spans
(``pb.*``) around its calls into each layer of the port; a device gap is
labelled by the innermost span that covers its middle.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

GAP_MIN_US = 5.0        # shorter device gaps are a launch's own latency


def _events(prof) -> Tuple[list, list]:
    """(device ops, harness spans) as (name, start µs, end µs) triples."""
    dev, spans = [], []
    for e in prof.profiler.kineto_results.events():
        name, t0 = e.name(), e.start_ns() / 1e3
        t1 = t0 + e.duration_ns() / 1e3
        on_device = "CUDA" in str(e.device_type())
        if name.startswith("pb."):
            if not on_device:
                spans.append((name, t0, t1))
        elif on_device and not e.is_user_annotation():
            dev.append((name, t0, t1))
    return dev, spans


def _label(spans: list, starts: list, t: float) -> str:
    """The innermost span (the latest started) covering time ``t``; spans
    sorted by start."""
    for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
        name, a, b = spans[i]
        if t <= b:
            return name
    return "host outside any harness span"


def read_profile(prof, wall_s: float) -> Optional[dict]:
    """Busy seconds (the union of the device intervals), the traced
    window's seconds, device seconds by operation name (all, and the ten
    largest), and idle seconds by host span (the ten largest). None when
    the profile holds no device operation."""
    dev, spans = _events(prof)
    if not dev:
        return None
    dev.sort(key=lambda r: r[1])
    by_name: Dict[str, float] = {}
    busy, gaps, end = 0.0, [], dev[0][1]
    for name, a, b in dev:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
        if a > end and a - end > GAP_MIN_US:
            gaps.append((end, a))
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    idle: Dict[str, float] = {}
    spans.sort(key=lambda r: r[1])
    starts = [a for _, a, _ in spans]
    for a, b in gaps:
        lab = _label(spans, starts, (a + b) / 2)
        idle[lab] = idle.get(lab, 0.0) + (b - a) / 1e6
    top: List = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy / 1e6, "window_s": wall_s, "by_name": by_name,
            "device_ops": [[n[:120], s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in sorted(idle.items(), key=lambda kv: -kv[1])[:10]],
            "device_events": len(dev)}
