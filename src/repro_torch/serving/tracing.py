"""Tracing of the serving path: host spans, device regions and counters on
one clock.

A ``ServingEngine`` built with ``trace=True`` holds a ``Tracer`` as
``tracer`` and hands it to its ``Pool``; otherwise both hold None and every
instrumented call pays one ``is not None`` test. The spans are taken where
``PhaseStats`` and the latency ledger already stamp, on the pool's own
clock:

* ``serve.step`` (``ServingEngine.step``) and ``serve.admit`` (``_admit``,
  when requests wait);
* ``serve.prefill`` (``Pool.prefill_request``), with ``serve.prefill.issue``
  (until the model call and the greedy argmax are enqueued) and
  ``serve.prefill.wait`` (the first token's read-back);
* ``serve.place`` (``Pool.place``);
* ``serve.decode`` (``Pool.decode_once``), with ``serve.decode.begin``
  (table growth, copy-on-write, the PRNG split: the host before the step),
  ``serve.decode.replay`` (input copies, the launch or graph replay, up to
  the read-back) and ``serve.decode.finish`` (the slot loops' accounting
  and the ledger's stamps).

A span records its name, start, end, parent span and, for one request's
work, its ``uid``. While ``torch.profiler`` runs, each span is also a
``record_function`` range of the same name, so that the profiler's trace
puts it on the device operations' clock; outside a profiler nothing would
see the range, and the span enters none.

On a card (and a wall clock) the tracer also times device regions with
CUDA events recorded on the current stream: a decode step (its launch or
graph replay to the sampled tokens, its inputs already enqueued), an
admission prefill (the cache row's allocation to the argmax) and a
placement (the row's copy or page scatter). Events come
from a free list: regions whose events have completed are timed without
waiting (``query``) whenever the list runs dry, each event against the one
recorded before it, so that every device time is a sum of short exact
differences. ``resolve`` synchronises once and records an anchor event at a
stamped host time; anchors map device time onto the host clock piecewise
linearly. Device idle inside a region counts as busy, so launch gaps inside
an eager prefill are the profiler's to see. Device work outside every
region (the step's input copies, the read-backs, copy-on-write copies)
counts as idle.

Counters, at the same boundaries: prefills this pool issued with their
true and bucketed positions and the prefill-attention kernel's launches
inside them (``prefill_attn_launches``: one a self-attention layer where
the kernel takes the call, 0 where the plain code does), decode steps with
their live rows, and graph captures. Everything stays in memory until the
tracer is dropped, in flat lists of numbers and strings (one list a
field): a record of its own for each span would be a container the garbage
collector walks at every full collection, which more than doubled a span's
cost. ``summary`` reads a window of it into a plain dict.
"""
from __future__ import annotations

import bisect
import contextlib
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.clock import VirtualClock

OUTSIDE = "outside any span"


class Tracer:
    """Spans, device regions and counters of one engine and its pool."""

    def __init__(self, clock: Callable[[], float], device):
        self.clock = clock
        # spans, in the order they start: name, start, end (None while
        # open), the parent's index (None at the top), the request's uid
        self.names: List[str] = []
        self.starts: List[float] = []
        self.ends: List[Optional[float]] = []
        self.parents: List[Optional[int]] = []
        self.uids: List[Optional[int]] = []
        self._open: List[int] = []         # indices of the open spans, innermost last
        self._counted: Tuple[List[float], List[str], List[int]] = ([], [], [])
        # device regions: kind, uid, the innermost span open as it closed,
        # device start and end ms (None until timed)
        self.kinds: List[str] = []
        self.region_uids: List[Optional[int]] = []
        self.region_spans: List[Optional[int]] = []
        self.dev_starts: List[Optional[float]] = []
        self.dev_ends: List[Optional[float]] = []
        self.device = torch.device(device)
        self.timed = self.device.type == "cuda" and not isinstance(clock, VirtualClock)
        self._free: List = []              # events ready for reuse
        self._pending: deque = deque()     # (region index, start event, end event)
        self._head = None                  # (last timed event, its device ms)
        self._anchors: List[Tuple[float, float]] = []   # (device ms, host s)
        if self.timed:
            torch.cuda.synchronize(self.device)
            self._anchor()

    # ------------------------------------------------------------ recording
    def span(self, name: str, uid: Optional[int] = None) -> "_Span":
        return _Span(self, name, uid)

    def region(self, kind: str, uid: Optional[int] = None):
        """A device region around the block's device work (no-op without
        events)."""
        return _Region(self, kind, uid) if self.timed else _NO_REGION

    def count(self, **values: int) -> None:
        t, names, counts = self._counted
        now = self.clock()
        for name, value in values.items():
            t.append(now)
            names.append(name)
            counts.append(value)

    def _event(self):
        if not self._free:
            self._harvest()
        if not self._free:
            self._free = [torch.cuda.Event(enable_timing=True) for _ in range(64)]
        return self._free.pop()

    def _harvest(self) -> None:
        """Time the regions whose events have completed, oldest first, and
        put their events back on the free list. Waits for nothing."""
        while self._pending:
            i, ev0, ev1 = self._pending[0]
            if not (ev1.query() and ev0.query()):
                return
            head, head_ms = self._head
            start = head_ms + head.elapsed_time(ev0)
            self.dev_starts[i], self.dev_ends[i] = start, start + ev0.elapsed_time(ev1)
            self._free += [head, ev0]
            self._head = (ev1, self.dev_ends[i])
            self._pending.popleft()

    def _anchor(self) -> None:
        """Record an event at a stamped host time on the idle device (the
        caller has synchronised): the event's device time and that host
        time are one point of the map between the clocks."""
        ev = self._event()
        host = self.clock()
        ev.record()
        ev.synchronize()
        if self._head is None:
            dev = 0.0
        else:
            head, head_ms = self._head
            dev = head_ms + head.elapsed_time(ev)
            self._free.append(head)
        self._head = (ev, dev)
        self._anchors.append((dev, host))

    def resolve(self) -> None:
        """Time every region recorded so far (one synchronize) and take a
        new anchor."""
        if not self.timed:
            return
        torch.cuda.synchronize(self.device)
        self._harvest()
        self._anchor()

    def host_times(self) -> np.ndarray:
        """Each timed region's (start, end) on the host clock, (n, 2)."""
        ms = np.array([[a, b] for a, b in zip(self.dev_starts, self.dev_ends)
                       if a is not None]).reshape(-1, 2)
        dev = np.array([a for a, _ in self._anchors])
        host = np.array([h for _, h in self._anchors])
        return np.interp(ms.ravel(), dev, host).reshape(-1, 2) if len(ms) else ms

    # ------------------------------------------------------------- reading
    def label(self, t: float) -> str:
        """The innermost span (the latest started) open at time ``t``."""
        # spans nest: those open at ``t`` are the latest started and its ancestors
        i = bisect.bisect_right(self.starts, t) - 1
        while i is not None and i >= 0:
            end = self.ends[i]
            if end is None or t <= end:
                return self.names[i]
            i = self.parents[i]
        return OUTSIDE

    def summary(self, t0: float, t1: float) -> dict:
        """The window [t0, t1] of the pool's clock: counters, spans by name
        and each prefill's host and device ms; with device regions also the
        device's busy seconds by region kind, its idle seconds, and the
        gaps between regions (all gaps by the innermost span covering each
        one's middle and by the kinds of the regions beside it; the gaps
        between consecutive decode steps with no other region between)."""
        self.resolve()
        inside = lambda t: t0 <= t <= t1
        counters: Dict[str, int] = {}
        for t, name, value in zip(*self._counted):
            if inside(t):
                counters[name] = counters.get(name, 0) + value
        spans: Dict[str, dict] = {}
        for name, a, b in zip(self.names, self.starts, self.ends):
            b = t1 if b is None else b
            if a <= t1 and b >= t0:
                s = spans.setdefault(name, {"count": 0, "s": 0.0})
                s["count"] += inside(a)
                s["s"] += min(b, t1) - max(a, t0)
        out = {"window_s": t1 - t0, "counters": counters, "spans": spans,
               "prefills": self._prefills(inside), "device": None}
        if self.timed:
            out["device"] = self._device_summary(t0, t1)
        return out

    def _prefills(self, inside) -> List[dict]:
        device_ms = {}
        for kind, span, a, b in zip(self.kinds, self.region_spans, self.dev_starts,
                                    self.dev_ends):
            if kind == "prefill" and span is not None and a is not None:
                device_ms[self.parents[span]] = b - a
        ms = lambda a, b: None if b is None else (b - a) * 1e3
        rows: Dict[int, dict] = {}
        for i, (name, a, b, parent, uid) in enumerate(zip(
                self.names, self.starts, self.ends, self.parents, self.uids)):
            if name == "serve.prefill" and inside(a):
                rows[i] = {"uid": uid, "ms": ms(a, b), "issue_ms": None, "wait_ms": None,
                           "device_ms": device_ms.get(i)}
            elif name in ("serve.prefill.issue", "serve.prefill.wait") and parent in rows:
                rows[parent][name[len("serve.prefill."):] + "_ms"] = ms(a, b)
        return list(rows.values())

    def _device_summary(self, t0: float, t1: float) -> dict:
        kinds = [k for k, a in zip(self.kinds, self.dev_starts) if a is not None]
        busy: Dict[str, float] = {}
        kept = []                        # (start, end, kind) clipped to the window
        for kind, (a, b) in zip(kinds, self.host_times()):
            a, b = max(a, t0), min(b, t1)
            if b >= a:
                busy[kind] = busy.get(kind, 0.0) + (b - a)
                kept.append((a, b, kind))
        by_label: Dict[str, float] = {}
        by_pair: Dict[str, float] = {}
        step_gaps: List[float] = []
        union, cursor, prev = 0.0, t0, "edge"
        for a, b, kind in kept + [(t1, t1, "edge")]:
            if a > cursor:
                gap = a - cursor
                lab = self.label((a + cursor) / 2)
                by_label[lab] = by_label.get(lab, 0.0) + gap
                pair = f"{prev}>{kind}"
                by_pair[pair] = by_pair.get(pair, 0.0) + gap
            if prev == kind == "decode":
                step_gaps.append(max(a - cursor, 0.0))
            union += max(0.0, b - max(a, cursor))
            cursor, prev = max(cursor, b), kind
        window = t1 - t0
        return {"busy_s": busy, "union_s": union, "idle_s": window - union,
                "gaps_by_label": by_label, "gaps_by_neighbours": by_pair,
                "step_gaps": len(step_gaps), "step_gap_s": float(sum(step_gaps)),
                "regions": len(kept), "untimed_regions": len(self.kinds) - len(kinds),
                "host_s_per_device_s": self._scale()}

    def _scale(self) -> Optional[float]:
        (d0, h0), (d1, h1) = self._anchors[0], self._anchors[-1]
        return (h1 - h0) / ((d1 - d0) / 1e3) if d1 > d0 else None


class _Span:
    __slots__ = ("tracer", "name", "uid", "index", "range")

    def __init__(self, tracer: Tracer, name: str, uid: Optional[int]):
        self.tracer, self.name, self.uid = tracer, name, uid

    def __enter__(self) -> "_Span":
        self.range = None
        if torch._C._autograd._profiler_enabled():
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        tr = self.tracer
        self.index = len(tr.names)
        tr.names.append(self.name)
        tr.starts.append(tr.clock())
        tr.ends.append(None)
        tr.parents.append(tr._open[-1] if tr._open else None)
        tr.uids.append(self.uid)
        tr._open.append(self.index)
        return self

    def __exit__(self, *exc) -> None:
        tr = self.tracer
        tr.ends[self.index] = tr.clock()
        tr._open.pop()
        if self.range is not None:
            self.range.__exit__(*exc)


class _Region:
    __slots__ = ("tracer", "kind", "uid", "start", "stream")

    def __init__(self, tracer: Tracer, kind: str, uid: Optional[int]):
        self.tracer, self.kind, self.uid = tracer, kind, uid

    def __enter__(self) -> "_Region":
        self.stream = torch.cuda.current_stream(self.tracer.device)
        self.start = self.tracer._event()
        self.start.record(self.stream)
        return self

    def __exit__(self, *exc) -> None:
        tr = self.tracer
        end = tr._event()
        end.record(self.stream)
        tr._pending.append((len(tr.kinds), self.start, end))
        tr.kinds.append(self.kind)
        tr.region_uids.append(self.uid)
        tr.region_spans.append(tr._open[-1] if tr._open else None)
        tr.dev_starts.append(None)
        tr.dev_ends.append(None)


_NO_REGION = contextlib.nullcontext()
