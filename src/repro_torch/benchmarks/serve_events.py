"""Event-engine fleet replay at scale: 10^5 requests over 16 replicas.

The port's counterpart of the reference's ``benchmarks/serve_events.py``:
the same recipe, constants, traces and assertions. The discrete-event
serving core (``repro_torch.serving.events``) replaces the round barrier
with a per-fleet event heap: replica prefill/decode pools run independent
virtual timelines that meet only at handoff and routing, and homogeneous
decode events at the same instant share ONE fused dispatch. This benchmark
is its scale + determinism gate:

    replay        16-replica fleet on one weight set, 10^5 aligned requests
                  (waves of 16 identical prompts at one-step cadence, so
                  every replica's decode event lands on the same instant
                  and the fused fast path carries the whole run)
    determinism   the replay runs twice; a sha256 over every request's
                  outputs + ledger stamps must match byte-for-byte
    fused         the fused dispatch cache must be exercised, and fused
                  calls must cover the large majority of decode steps
    overlap       on a prefill-burst trace (long prompts landing mid-
                  decode) the event engine's p99 TTFT must be strictly
                  better than the barrier engine's on the SAME trace

Asserted:

    all requests complete, both replays byte-identical
    fused calls > 0 and >= 80% of decode steps ran fused
    event p99 TTFT < barrier p99 TTFT on the burst trace
    slowest single replay fits the wall budget
        (REPRO_EVENTS_TIME_BUDGET_S, default 1800 s; 0 waives)

By default the pools run ``reduced_config`` widths; ``--full-config`` runs
``get_config`` widths (random bf16 weights from a seeded
``torch.Generator``, for the card). ``--requests N`` cuts the wave trace
(whole waves only; the smoke size is 2000, the full one 100 000).

Run:  python -m repro_torch.benchmarks.serve_events --smoke --full-config   # on a card
  or: python -m repro_torch.benchmarks.serve_events --smoke --device cpu
  add --json to write BENCH_torch_serve_events.json
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time
from typing import Any, Callable, Mapping, Optional

import numpy as np

from repro_torch.benchmarks.common import (
    h200_model,
    random_params,
    write_bench_json,
    write_csv,
)
from repro_torch.core.latency import summarize_latency
from repro_torch.core.traces import TracedRequest
from repro_torch.device import resolve_device
from repro_torch.serving import (
    ClockSpec,
    EventDrivenFleet,
    Fleet,
    FleetSpec,
    PoolSpec,
    ReplicaSpec,
)

ARCH = "gemma-2b"
N_REPLICAS = 16
BATCH = 8
MAX_SEQ_LEN = 64
CHUNK_TOKENS = 64
PROMPT_LEN = 16
MAX_NEW = 4
WAVE_DT_S = 0.0021                  # ~ one locked-clock decode step
TRACE_SEED = 17
JSON_PATH = "BENCH_torch_serve_events.json"
# wall-clock budget for ONE replay (the acceptance bar); 0 waives
TIME_BUDGET_S = float(os.environ.get("REPRO_EVENTS_TIME_BUDGET_S", "1800"))


def make_fleet(params_for: Mapping[str, Any], n=N_REPLICAS, *, batch=BATCH,
               max_seq_len=MAX_SEQ_LEN, chunk=CHUNK_TOKENS, full_config: bool = False,
               device="cuda") -> Fleet:
    spec = FleetSpec(
        replicas=tuple(
            ReplicaSpec(name=f"r{i:02d}", arch=ARCH,
                        clock=ClockSpec(mode="lock"),
                        decode=PoolSpec(batch=batch),
                        max_seq_len=max_seq_len,
                        prefill_chunk_tokens=chunk, reduced=not full_config)
            for i in range(n)),
        router="jsq",
    )
    return Fleet.from_spec(spec, emodel=h200_model(), params_for=params_for,
                           device=device)


def wave_trace(n_requests: int):
    """Waves of ``N_REPLICAS`` identical prompts at one-step cadence: JSQ
    spreads one per replica, the replicas stay in lockstep, and every
    decode instant is shared fleet-wide — the fused fast path's shape.

    Returns ``(trace, dropped)``: requests that don't fill a whole wave
    are dropped (a partial wave would break the alignment the benchmark
    is asserting) — callers must surface ``dropped`` instead of silently
    reporting the requested count."""
    rng = np.random.default_rng(TRACE_SEED)
    prompt = rng.integers(1, 100, PROMPT_LEN).astype(np.int32)
    n_waves = n_requests // N_REPLICAS
    trace = [
        TracedRequest(arrival_s=w * WAVE_DT_S, prompt=prompt,
                      max_new_tokens=MAX_NEW, bucket="mixed")
        for w in range(n_waves) for _ in range(N_REPLICAS)
    ]
    return trace, n_requests - len(trace)


def burst_trace():
    """One long-decode request, then long prompts landing mid-decode —
    the shape where the barrier's admission-serialises-decode timing
    costs TTFT."""
    def req(plen, arr, max_new, seed):
        rng = np.random.default_rng(seed + plen)
        return TracedRequest(
            arrival_s=arr,
            prompt=rng.integers(1, 100, plen).astype(np.int32),
            max_new_tokens=max_new, bucket="mixed")

    return [req(8, 0.0, 24, seed=1)] + [
        req(480, 1e-4 * (i + 1), 4, seed=2 + i) for i in range(4)]


def replay(trace, params_for: Mapping[str, Any], *, full_config: bool = False,
           device="cuda"):
    """One event-engine replay; returns (metrics, replay sha256, wall s,
    the fleet)."""
    fleet = make_fleet(params_for, full_config=full_config, device=device)
    eng = EventDrivenFleet(fleet)
    t0 = time.perf_counter()
    done = eng.run(trace, max_steps=10_000_000)
    wall_s = time.perf_counter() - t0
    done = sorted(done, key=lambda r: (r.ledger.arrival_s, r.replica, r.uid))
    lat = summarize_latency(done)
    blob = json.dumps({
        "outputs": [r.output for r in done],
        "stamps": [[r.ledger.arrival_s, r.ledger.admitted_s,
                    r.ledger.first_token_s, r.ledger.finish_s]
                   for r in done],
        "measured_j": fleet.measured_energy_j(),
    }, sort_keys=True)
    st = eng.stats
    metrics = {
        "completed": len(done),
        "requests": len(trace),
        "replicas": len(fleet.replicas),
        "decode_steps": eng._steps,
        "fused_calls": eng.fused_calls,
        "fused_step_pct": 100.0 * st.fused_decode_coverage,
        "decode_tokens": fleet.stats.decode_tokens,
        "total_j": fleet.total_energy_j(),
        "p50_ttft_s": lat.p50_ttft_s,
        "p99_ttft_s": lat.p99_ttft_s,
        "p99_tbt_s": lat.p99_tbt_s,
        "engine_stats": st.as_dict(),
    }
    return metrics, hashlib.sha256(blob.encode()).hexdigest(), wall_s, fleet


def run(smoke: bool = False, write_json: bool = False, *, full_config: bool = False,
        device="cuda", params_for: Optional[Mapping[str, Any]] = None,
        n_requests: Optional[int] = None,
        on_run: Optional[Callable[..., None]] = None):
    """Harness contract: yields (name, us_per_call, derived) rows; raises
    on any violated completion/determinism/fusion/overlap assertion.
    ``params_for`` maps the arch to weights of the config the pools run
    (made from seed 0 when missing); ``n_requests`` overrides the wave
    trace's size. ``on_run(tag, metrics, wall_s, fleet)`` is called after
    each replay, before any of its checks: ``tag`` is ``"replay 1"``,
    ``"replay 2"`` or ``"burst events"`` / ``"burst barrier"``, whose
    metrics are ``{"completed", "p99_ttft_s"}``."""
    n_requested = n_requests or (2_000 if smoke else 100_000)
    trace, dropped = wave_trace(n_requested)
    n_requests = len(trace)             # whole waves only
    if dropped:
        print(f"serve_events: dropped {dropped} of {n_requested} requests "
              f"(whole {N_REPLICAS}-request waves only)", file=sys.stderr)
    params_for = dict(params_for or {})
    if ARCH not in params_for:
        params_for[ARCH] = random_params(ARCH, full_config=full_config, device=device)
    kw = dict(full_config=full_config, device=device)

    out_rows = []
    violations = []

    runs = []
    for turn in (1, 2):
        metrics, sha, wall, fleet = replay(trace, params_for, **kw)
        if on_run is not None:
            on_run(f"replay {turn}", metrics, wall, fleet)
        runs.append((metrics, sha, wall))
        del fleet
    (first, sha_a, wall_a), (again, sha_b, wall_b) = runs
    out_rows.append((
        "serve_events/replay",
        1e6 * wall_a / n_requests,
        f"requests={n_requests};dropped={dropped};"
        f"replicas={first['replicas']};"
        f"steps={first['decode_steps']};total_j={first['total_j']:.3f};"
        f"p99_ttft_ms={1e3 * first['p99_ttft_s']:.3f};"
        f"wall_s={wall_a:.1f}",
    ))
    if first["completed"] != n_requests:
        violations.append(
            f"replay: {first['completed']}/{n_requests} completed")

    # ---- byte-identical across replays -----------------------------------
    identical = sha_a == sha_b and first == again
    if not identical:
        violations.append("replay NOT byte-identical across runs")
    out_rows.append((
        "serve_events/determinism", 0.0,
        f"byte_identical={identical};sha={sha_a[:16]}",
    ))

    # ---- prefix sharing defaults off: this fleet must be untouched by it --
    es = first["engine_stats"]
    if (es["prefix_hits"], es["prefix_cow_splits"],
            es["saved_prefill_j"]) != (0, 0, 0.0):
        violations.append(
            f"prefix sharing leaked into a sharing-off fleet: "
            f"hits={es['prefix_hits']} cow={es['prefix_cow_splits']} "
            f"saved_j={es['saved_prefill_j']}")

    # ---- the fused fast path carried the run -----------------------------
    if first["fused_calls"] == 0:
        violations.append("fused fast path never fired")
    if first["fused_step_pct"] < 80.0:
        violations.append(
            f"only {first['fused_step_pct']:.1f}% of decode steps ran "
            f"fused (want >= 80%)")
    out_rows.append((
        "serve_events/fused", 0.0,
        f"fused_calls={first['fused_calls']};"
        f"fused_step_pct={first['fused_step_pct']:.1f}",
    ))

    # ---- overlap: event p99 TTFT strictly beats the barrier --------------
    burst = burst_trace()
    p99 = {}
    for engine in ("events", "barrier"):
        fleet = make_fleet(params_for, 1, batch=4, max_seq_len=512, chunk=512, **kw)
        t0 = time.perf_counter()
        done = fleet.run_trace(burst, engine=engine)
        wall = time.perf_counter() - t0
        p99[engine] = summarize_latency(done).p99_ttft_s
        if on_run is not None:
            on_run(f"burst {engine}", {"completed": len(done), "p99_ttft_s": p99[engine]},
                   wall, fleet)
        if len(done) != len(burst):
            violations.append(
                f"overlap/{engine}: {len(done)}/{len(burst)} completed")
    if not p99["events"] < p99["barrier"]:
        violations.append(
            f"overlap: event p99 TTFT {p99['events']:.6f}s not strictly "
            f"better than barrier's {p99['barrier']:.6f}s")
    out_rows.append((
        "serve_events/overlap_vs_barrier", 0.0,
        f"events_p99_ttft_ms={1e3 * p99['events']:.3f};"
        f"barrier_p99_ttft_ms={1e3 * p99['barrier']:.3f};"
        f"saved_pct={100 * (1 - p99['events'] / p99['barrier']):.1f}",
    ))

    # ---- wall budget ------------------------------------------------------
    slowest = max(wall_a, wall_b)
    if TIME_BUDGET_S > 0:
        if slowest > TIME_BUDGET_S:
            violations.append(
                f"a replay took {slowest:.1f}s (> {TIME_BUDGET_S:.0f}s budget)")
        out_rows.append((
            "serve_events/wall_time", 0.0,
            f"slowest_replay_s={slowest:.1f};budget_s={TIME_BUDGET_S:.0f}",
        ))

    results = {"replay": first, "replay_sha": sha_a,
               "overlap_p99_ttft_s": p99, "wall_s": [wall_a, wall_b]}
    write_csv("serve_events", ["metric", "value"],
              [[k, v] for k, v in first.items()]
              + [["events_p99_ttft_s", p99["events"]],
                 ["barrier_p99_ttft_s", p99["barrier"]]])
    if write_json:
        write_bench_json(
            "serve_events", results, smoke=smoke, path=JSON_PATH,
            trace={"n": n_requests, "n_requested": n_requested,
                   "dropped": dropped, "shape": "aligned-waves",
                   "wave_dt_s": WAVE_DT_S, "prompt_len": PROMPT_LEN,
                   "max_new": MAX_NEW, "seed": TRACE_SEED},
        )
        out_rows.append(("serve_events/json", 0.0, f"wrote={JSON_PATH}"))
    if violations:
        raise RuntimeError("; ".join(violations))
    return out_rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true", help="2000 requests (100 000 without)")
    ap.add_argument("--requests", type=int, default=None,
                    help="wave trace size (whole waves of 16)")
    ap.add_argument("--json", action="store_true", help=f"write {JSON_PATH}")
    ap.add_argument("--full-config", action="store_true",
                    help="serve get_config widths (for the card) instead of reduced_config")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)      # no card: fail here, not as a violated check
    ok = True
    try:
        for name, us, derived in run(smoke=args.smoke, write_json=args.json,
                                     full_config=args.full_config, device=args.device,
                                     n_requests=args.requests):
            print(f"{name},{us:.1f},{derived}")
    except RuntimeError as e:
        print(f"serve_events checks VIOLATED: {e}")
        ok = False
    print("serve_events checks:", "OK" if ok else "VIOLATED")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
