"""A cell served with the program's own tracer on (``ServingEngine``'s
``Tracer``, ``repro_torch/serving/tracing.py``), for readings that the
benchmark's listed metrics do not take yet:

    python3 portbench/programtrace.py --workload <cell> --seed <n> --seconds <s> \\
        [--harness-trace 0|1] [--turns on off ...]

Each turn is one ``harness.run_cell`` of the cell on the seed, its tracer
attached after set-up (``on``) or not (``off``), with the harness's own
``--trace`` path on or off (``--harness-trace``). One JSON line a turn: the card, the
window's tokens a second and step ms, and for an ``on`` turn the readings
below and the summary (device busy by region kind, gaps by span and by
neighbouring regions, counters, span ms, prefill ms); with the harness's
trace too, the harness's profiled idle and its replays' device ms beside
the program's decode regions.

The readers take a run's record with the program's ``summary`` of the
window under ``program_trace``, and return None without one.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Optional  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
KEY = "program_trace"


def _device(rec: dict) -> Optional[dict]:
    return (rec.get(KEY) or {}).get("device")


def idle_events(rec: dict) -> Optional[float]:
    """Device layer: 1 - the union of the program's device regions (CUDA
    events around each decode step, admission prefill and placement) over
    the window, in %. Device idle inside a region counts as busy there, so
    launch gaps inside an eager prefill stay the profiler's to see."""
    dev = _device(rec)
    return dev["idle_s"] / rec[KEY]["window_s"] * 100.0 if dev else None


def step_gap_ms(rec: dict) -> Optional[float]:
    """Pool step-graph layer: the mean device gap between consecutive
    decode-step regions with no other region between them: all the host
    work of a step, as the device sees it (ms)."""
    dev = _device(rec)
    return dev["step_gap_s"] / dev["step_gaps"] * 1e3 if dev and dev["step_gaps"] else None


def prefill_pad_share(rec: dict) -> Optional[float]:
    """Pool prefill layer: the window's padded prefill positions (bucket -
    true length) over all positions the prefills computed, from the
    program's counters, in %."""
    c = (rec.get(KEY) or {}).get("counters", {})
    bucket = c.get("prefill_bucket_tokens")
    return (bucket - c["prefill_tokens"]) / bucket * 100.0 if bucket else None


READERS = {"idle_events.decode": idle_events, "step_gap_ms.decode": step_gap_ms,
           "prefill_pad_share.prefill": prefill_pad_share}


def card() -> dict:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return {"nvidia_smi": out.stdout.strip()}


def turn(cell, seed: int, seconds: float, traced: bool, harness_trace: bool,
         device="cuda") -> dict:
    """One run of ``cell``; its record, the program's summary of the
    window under ``program_trace`` when ``traced``."""
    from portbench import harness
    from repro_torch.serving.tracing import Tracer

    held = {}

    def attach(sess) -> None:
        if traced:
            tr = Tracer(sess.pool.clock, sess.pool.device)
            sess.engine.tracer = sess.pool.tracer = tr
            held["tracer"] = tr
        sess.sync()
        held["t_open"] = time.perf_counter()     # the harness opens the window next

    res = harness.run_cell(cell, seed, seconds, harness_trace, T_START, device=device,
                           before_window=attach)
    rec = res["record"]
    if traced:
        t0 = held["t_open"]
        rec[KEY] = held["tracer"].summary(t0, t0 + rec["window_s"])
    return res


def line(res: dict, traced: bool) -> dict:
    """What a turn prints."""
    from portbench.stats import delta

    rec = res["record"]
    steps = delta(rec, "decode_steps")
    out = {"traced": traced, "correct": res["correct"], "logit_gap": res["check"]["logit_gap"],
           "window_s": rec["window_s"], "tokens_per_s": rec["tokens"] / rec["window_s"],
           "decode_steps": steps,
           "step_wall_ms": rec["window_s"] / steps * 1e3 if steps else None,
           "step_phase_ms": delta(rec, "decode_s") / steps * 1e3 if steps else None,
           "prefills": delta(rec, "prefill_calls"),
           "prefill_share": delta(rec, "prefill_s") / rec["window_s"] * 100.0}
    if traced:
        summ = rec[KEY]
        out["readings"] = {name: fn(rec) for name, fn in READERS.items()}
        out["summary"] = {k: summ[k] for k in ("counters", "device")}
        out["span_ms"] = {n: s["s"] / s["count"] * 1e3 for n, s in summ["spans"].items()
                          if s["count"]}
        pre = [p for p in summ["prefills"] if p["device_ms"] is not None]
        if pre:
            mean = lambda k: sum(p[k] for p in pre) / len(pre)
            out["prefill_ms"] = {k: mean(k) for k in ("ms", "issue_ms", "wait_ms",
                                                      "device_ms")}
    prof = rec.get("profile")
    if prof:
        out["harness_idle"] = (1.0 - prof["busy_s"] / prof["window_s"]) * 100.0
        out["harness_idle_gaps"] = prof["idle_gaps"]
    if rec.get("replays"):
        out["replays_ms"] = sum(ms for ms, _ in rec["replays"])
        out["replays"] = len(rec["replays"])
        dev = _device(rec)
        if dev:
            out["decode_regions_ms"] = dev["busy_s"].get("decode", 0.0) * 1e3
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--harness-trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--turns", nargs="+", choices=("on", "off"), default=["on"])
    args = ap.parse_args()

    from portbench import harness

    cell = harness.Cell(ROOT, args.workload)
    print(json.dumps(card()), flush=True)
    for i, which in enumerate(args.turns):
        res = turn(cell, args.seed, args.seconds, which == "on", bool(args.harness_trace))
        print(json.dumps(dict(line(res, which == "on"), turn=i, seed=args.seed)), flush=True)
    return 0


if __name__ == "__main__":
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton_cache")
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    sys.exit(main())
