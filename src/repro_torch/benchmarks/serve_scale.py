"""Event-engine scale gate: 10^6 requests over a 100-replica mixed fleet.

The port's counterpart of the reference's ``benchmarks/serve_scale.py``:
the same fleet, traces, seeds, gates, rows, CSV and JSON. Its levers
(``repro_torch.serving.events`` + ``repro_torch.serving.pool``):

    fused admission prefill   same-instant admission ticks defer their
                              prefills; the engine runs one grouped
                              dispatch per (config, params, bucket) and
                              replays per-request accounting in the serial
                              order
    fusion quantum            decode events inside ``[t, t+q)`` share one
                              dispatch even when replica clocks have
                              drifted off exact ties
    pow2 group bucketing      the fused program cache stays O(log fleet) on
                              a drifting fleet
    batched replica axis      a fused group of K pools runs as ONE decode
                              step over a replica bank (the members' caches
                              stacked along the batch) instead of the K
                              members' own steps (``batch_replicas``;
                              ``--batched=off`` replays the tuple baseline)
    allocation-free loops     request/ledger freelists + ``on_finish``
                              streaming keep the replay memory-flat;
                              round-robin routing is O(1) per arrival

Fleet: 88 gemma-2b + 12 minicpm-2b replicas (each arch fuses within
itself), lock, batch 8, ``max_seq_len`` 64, in the recipe's dtype, fp32.
Trace: an aligned phase (waves of one request per replica at one-step
cadence) followed by a drifted phase (mixed prompt lengths, jittered
arrivals).

Asserted:

    scale       all requests complete; double replay streams to the SAME
                sha256 (outputs + ledger stamps + measured joules)
    aligned     >= 80% of decode pool-steps ran through fused dispatches
                on the aligned phase
    dispatch    dispatches/request with full fusion strictly below the
                serial-admission, exact-tie pattern on the same trace, and
                under an absolute ceiling
    quantum     ``fusion_quantum_s=0`` replays byte-identical to the
                exact-tie engine; a positive quantum changes no token
    batched     the batched fused dispatch streams to the SAME sha256 as
                the tuple dispatch, and its measured wall per fused call
                beats the tuple's at group sizes >= 8
    wall        slowest full replay fits the budget
                (REPRO_SCALE_TIME_BUDGET_S, default 3600 s; 0 waives)

By default the pools run ``reduced_config`` widths; ``--full-config`` runs
``get_config`` widths in fp32 (random weights from a seeded
``torch.Generator``, for the card). ``--requests N`` / ``--aligned N`` /
``--compare N`` / ``--curve N`` cut the traces (whole waves of 100 in the
aligned phases; what is dropped is printed).

Run:  python -m repro_torch.benchmarks.serve_scale --smoke --full-config   # on a card
  or: python -m repro_torch.benchmarks.serve_scale --smoke --device cpu
  add --json to write BENCH_torch_serve_scale.json (the tuple baseline's,
  with --batched=off, BENCH_torch_serve_scale_unbatched.json)
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import sys
import time
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.benchmarks.common import (
    RecipeViolation,
    h200_model,
    write_bench_json,
    write_csv,
)
from repro_torch.configs import get_config, reduced_config
from repro_torch.core.traces import TracedRequest
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.serving import (
    ClockSpec,
    Fleet,
    FleetSpec,
    PoolSpec,
    ReplicaSpec,
    clear_program_caches,
)
from repro_torch.serving.pool import release_request

ARCH_MAIN = "gemma-2b"
ARCH_ALT = "minicpm-2b"
N_MAIN = 88
N_ALT = 12
N_REPLICAS = N_MAIN + N_ALT
BATCH = 8
MAX_SEQ_LEN = 64
CHUNK_TOKENS = 64
PROMPT_LEN = 16
MAX_NEW = 4
WAVE_DT_S = 0.0021                  # ~ one locked-clock decode step
QUANTUM_S = 0.0005                  # ~ a quarter step: re-fuses drift
TRACE_SEED = 23
DISPATCH_CEILING = 1.5              # dispatches per request, full run
DTYPE = "float32"                   # reduced_config's dtype: the recipe's own
JSON_PATH = "BENCH_torch_serve_scale.json"
UNBATCHED_JSON_PATH = "BENCH_torch_serve_scale_unbatched.json"
# wall-clock budget for ONE full replay; 0 waives
TIME_BUDGET_S = float(os.environ.get("REPRO_SCALE_TIME_BUDGET_S", "3600"))


def config_for(arch: str, *, full_config: bool = False, dtype: str = DTYPE):
    """The config an ``arch`` replica's pools run: ``get_config`` with
    ``full_config``, else ``reduced_config``, in ``dtype``."""
    cfg = get_config(arch) if full_config else reduced_config(arch)
    return dataclasses.replace(cfg, param_dtype=dtype, compute_dtype=dtype)


def params_for_fleet(*, full_config: bool = False, device="cuda", dtype: str = DTYPE):
    """Both archs' weights in ``config_for``'s config, from a
    ``torch.Generator`` seeded with 0 on ``device`` (other values than the
    reference's ``jax.random.PRNGKey(0)`` init)."""
    dev = resolve_device(device)
    return {arch: init_params(config_for(arch, full_config=full_config, dtype=dtype),
                              torch.Generator(dev).manual_seed(0), device=dev)
            for arch in (ARCH_MAIN, ARCH_ALT)}


def make_fleet(params_for: Mapping[str, Any], *, full_config: bool = False,
               device="cuda", dtype: str = DTYPE) -> Fleet:
    archs = [ARCH_MAIN] * N_MAIN + [ARCH_ALT] * N_ALT
    spec = FleetSpec(
        replicas=tuple(
            ReplicaSpec(name=f"r{i:03d}", arch=arch,
                        clock=ClockSpec(mode="lock"),
                        decode=PoolSpec(batch=BATCH),
                        max_seq_len=MAX_SEQ_LEN,
                        prefill_chunk_tokens=CHUNK_TOKENS,
                        reduced=not full_config)
            for i, arch in enumerate(archs)),
        router="rr",                # O(1) per arrival; JSQ would be O(N)
    )
    configs = {a: config_for(a, full_config=full_config, dtype=dtype)
               for a in (ARCH_MAIN, ARCH_ALT)}
    return Fleet.from_spec(spec, emodel=h200_model(), params_for=params_for,
                           device=device, configs=configs)


def aligned_trace(n_requests: int, *, t0: float = 0.0):
    """Waves of one identical prompt per replica at one-step cadence —
    every fused path (admission + decode) at full coverage. The prompt
    array is SHARED across requests. Partial waves are dropped; returns
    ``(trace, dropped)``."""
    rng = np.random.default_rng(TRACE_SEED)
    prompt = rng.integers(1, 100, PROMPT_LEN).astype(np.int32)
    n_waves = n_requests // N_REPLICAS
    trace = [
        TracedRequest(arrival_s=t0 + w * WAVE_DT_S, prompt=prompt,
                      max_new_tokens=MAX_NEW, bucket="mixed")
        for w in range(n_waves) for _ in range(N_REPLICAS)
    ]
    return trace, n_requests - len(trace)


def drifted_trace(n_requests: int, *, t0: float = 0.0):
    """Mixed prompt lengths + jittered arrivals: replica clocks drift off
    exact ties, so only the fusion quantum and pow2 group bucketing keep
    dispatches shared. Prompts come from a small shared pool of arrays."""
    rng = np.random.default_rng(TRACE_SEED + 1)
    pool = [rng.integers(1, 100, int(n)).astype(np.int32)
            for n in rng.integers(8, 25, 32)]
    trace = []
    for i in range(n_requests):
        jitter = float(rng.uniform(0.0, 0.3 * WAVE_DT_S))
        trace.append(TracedRequest(
            arrival_s=t0 + (i // N_REPLICAS) * WAVE_DT_S + jitter,
            prompt=pool[int(rng.integers(0, len(pool)))],
            max_new_tokens=MAX_NEW, bucket="mixed"))
    return trace


def scale_trace(n_requests: int):
    """Aligned phase then drifted phase, half each."""
    n_aligned = n_requests // 2
    a, dropped = aligned_trace(n_aligned)
    t0 = (len(a) // N_REPLICAS + 2) * WAVE_DT_S if a else 0.0
    d = drifted_trace(n_requests - len(a), t0=t0)
    return a + d, dropped


class StreamHash:
    """Streaming replay fingerprint + latency accumulator: hashes every
    finished request in completion order and releases it back to the
    request freelist, so the replay holds O(in-flight) requests."""

    def __init__(self):
        self._h = hashlib.sha256()
        self.completed = 0
        self.ttft = []
        self.e2e = []

    def __call__(self, req):
        led = req.ledger
        self._h.update(json.dumps(
            [req.replica, req.uid, req.output, led.arrival_s,
             led.admitted_s, led.first_token_s, led.finish_s]).encode())
        self.completed += 1
        self.ttft.append(led.first_token_s - led.arrival_s)
        self.e2e.append(led.finish_s - led.arrival_s)
        release_request(req)

    def digest(self, fleet) -> str:
        self._h.update(json.dumps(fleet.measured_energy_j(),
                                  sort_keys=True).encode())
        return self._h.hexdigest()


def replay(trace, params_for: Mapping[str, Any], *, full_config: bool = False,
           device="cuda", dtype: str = DTYPE, **engine_opts):
    """One streamed replay; returns (metrics, sha256, wall_s, the fleet)."""
    fleet = make_fleet(params_for, full_config=full_config, device=device, dtype=dtype)
    stream = StreamHash()
    opts = {"on_finish": stream, **engine_opts}
    t0 = time.perf_counter()
    fleet.run_trace(trace, max_steps=1_000_000_000, engine_opts=opts)
    wall_s = time.perf_counter() - t0
    st = fleet.last_engine_stats
    ttft = np.asarray(stream.ttft)
    metrics = {
        "completed": stream.completed,
        "requests": len(trace),
        "replicas": N_REPLICAS,
        "decode_steps": st.decode_steps,
        "jit_dispatches": st.jit_dispatches,
        "dispatches_per_request": st.jit_dispatches / max(len(trace), 1),
        "fused_decode_coverage": st.fused_decode_coverage,
        "fused_prefill_coverage": st.fused_prefill_coverage,
        "batched_decode_calls": st.batched_decode_calls,
        "bank_rebuilds": st.bank_rebuilds,
        "peak_heap": st.peak_heap,
        "events": st.events,
        "total_j": fleet.total_energy_j(),
        "p50_ttft_s": float(np.percentile(ttft, 50)) if len(ttft) else None,
        "p99_ttft_s": float(np.percentile(ttft, 99)) if len(ttft) else None,
        "engine_stats": st.as_dict(),
    }
    return metrics, stream.digest(fleet), wall_s, fleet


def dispatch_curve(smoke: bool, params_for: Mapping[str, Any], *, n_requests=None,
                   on_run=None, **kw):
    """Measured wall seconds inside fused decode dispatches vs group size,
    batched vs tuple, on the aligned trace (full fused coverage).
    ``clear_program_caches()`` between points so every point pays its own
    captures — the curve is (capture + dispatch) per fused call, the cost
    a replay actually sees the first time it meets a group size."""
    sweep = (4, 8, 32) if smoke else (4, 8, 16, 32, 64)
    n = n_requests or (1_500 if smoke else 20_000)
    trace, dropped = aligned_trace(n)
    if n_requests and dropped:
        print(f"serve_scale: curve trace dropped {dropped} of {n} requests "
              f"(whole {N_REPLICAS}-request waves only)", file=sys.stderr)
    curve: dict = {}
    for g in sweep:
        for mode, flag in (("batched", True), ("tuple", False)):
            clear_program_caches()
            fleet = make_fleet(params_for, **kw)
            t0 = time.perf_counter()
            fleet.run_trace(trace, max_steps=1_000_000_000, engine_opts={
                "fusion_quantum_s": QUANTUM_S, "max_fused_group": g,
                "batch_replicas": flag, "time_dispatch": True})
            wall_s = time.perf_counter() - t0
            st = fleet.last_engine_stats
            calls = sum(int(v[0]) for v in st.fused_decode_wall.values())
            secs = sum(v[1] for v in st.fused_decode_wall.values())
            curve.setdefault(str(g), {})[mode] = {
                "fused_calls": calls,
                "dispatch_wall_s": secs,
                "us_per_fused_call": 1e6 * secs / max(calls, 1),
                "by_size": st.fused_decode_wall,
            }
            if on_run is not None:
                on_run(f"curve g{g} {mode}", {"requests": len(trace), **curve[str(g)][mode]},
                       wall_s, fleet)
            del fleet
    clear_program_caches()
    return curve


def run(smoke: bool = False, write_json: bool = False, batched: bool = True, *,
        full_config: bool = False, device="cuda",
        params_for: Optional[Mapping[str, Any]] = None,
        n_scale: Optional[int] = None, n_aligned: Optional[int] = None,
        n_compare: Optional[int] = None, n_curve: Optional[int] = None,
        on_run: Optional[Callable[..., None]] = None):
    """Harness contract: yields (name, us_per_call, derived) rows; raises
    ``RecipeViolation`` on any violated completion / determinism / coverage
    / dispatch / identity assertion. ``params_for`` maps each arch to
    weights of ``config_for``'s config (made from seed 0 when missing);
    ``n_scale`` / ``n_aligned`` / ``n_compare`` / ``n_curve`` override the
    tier's request counts (4000 / 2000 / 1000 / 1500 smoke). ``on_run(tag,
    metrics, wall_s, fleet)`` is called after each replay, before its
    checks."""
    if smoke:
        scale_n, aligned_n, compare_n = 4_000, 2_000, 1_000
    else:
        scale_n, aligned_n, compare_n = 1_000_000, 50_000, 10_000
    n_scale, n_aligned, n_compare = (n_scale or scale_n, n_aligned or aligned_n,
                                     n_compare or compare_n)
    kw = dict(full_config=full_config, device=device)
    params_for = dict(params_for or {})
    if any(a not in params_for for a in (ARCH_MAIN, ARCH_ALT)):
        params_for = {**params_for_fleet(**kw), **params_for}
    # every replay below runs in the requested engine mode; the batched
    # identity section crosses over to the OTHER mode to pin the sha
    base = {"batch_replicas": batched}

    def replay_run(tag, trace, **opts):
        metrics, sha, wall, fleet = replay(trace, params_for, **kw, **opts)
        if on_run is not None:
            on_run(tag, metrics, wall, fleet)
        return metrics, sha, wall

    out_rows = []
    violations = []

    # ---- the scale run: mixed trace, streamed, double replay -------------
    trace, dropped = scale_trace(n_scale)
    if dropped:
        print(f"serve_scale: dropped {dropped} requests to whole waves",
              file=sys.stderr)
    first, sha_a, wall_a = replay_run("scale 1", trace, fusion_quantum_s=QUANTUM_S, **base)
    again, sha_b, wall_b = replay_run("scale 2", trace, fusion_quantum_s=QUANTUM_S, **base)
    out_rows.append((
        "serve_scale/replay",
        1e6 * wall_a / max(len(trace), 1),
        f"requests={len(trace)};dropped={dropped};replicas={N_REPLICAS};"
        f"dispatches_per_request={first['dispatches_per_request']:.3f};"
        f"peak_heap={first['peak_heap']};total_j={first['total_j']:.1f};"
        f"wall_s={wall_a:.1f}",
    ))
    if first["completed"] != len(trace):
        violations.append(
            f"scale: {first['completed']}/{len(trace)} completed")
    identical = sha_a == sha_b and first == again
    if not identical:
        violations.append("scale replay NOT byte-identical across runs")
    out_rows.append((
        "serve_scale/determinism", 0.0,
        f"byte_identical={identical};sha={sha_a[:16]}",
    ))
    # prefix sharing defaults off: this fleet must be untouched by it
    es = first["engine_stats"]
    if (es["prefix_hits"], es["prefix_cow_splits"],
            es["saved_prefill_j"]) != (0, 0, 0.0):
        violations.append(
            f"prefix sharing leaked into a sharing-off fleet: "
            f"hits={es['prefix_hits']} cow={es['prefix_cow_splits']} "
            f"saved_j={es['saved_prefill_j']}")
    if first["dispatches_per_request"] >= DISPATCH_CEILING:
        violations.append(
            f"{first['dispatches_per_request']:.3f} dispatches/request "
            f"(ceiling {DISPATCH_CEILING})")

    # ---- aligned phase: fused coverage ------------------------------------
    atrace, adropped = aligned_trace(n_aligned)
    if adropped and n_aligned != aligned_n:
        print(f"serve_scale: aligned trace dropped {adropped} of {n_aligned} "
              f"requests (whole {N_REPLICAS}-request waves only)", file=sys.stderr)
    amet, _, _ = replay_run("aligned", atrace, **base)
    if amet["fused_decode_coverage"] < 0.80:
        violations.append(
            f"aligned fused decode coverage "
            f"{100 * amet['fused_decode_coverage']:.1f}% < 80%")
    out_rows.append((
        "serve_scale/aligned_coverage", 0.0,
        f"fused_decode_pct={100 * amet['fused_decode_coverage']:.1f};"
        f"fused_prefill_pct={100 * amet['fused_prefill_coverage']:.1f}",
    ))

    # ---- dispatch count: full fusion vs serial admission, exact ties ------
    ctrace, cdropped = scale_trace(n_compare)
    if cdropped and n_compare != compare_n:
        print(f"serve_scale: compare trace dropped {cdropped} of {n_compare} "
              f"requests to whole waves", file=sys.stderr)
    fused_m, fused_sha, _ = replay_run("compare fused", ctrace,
                                       fusion_quantum_s=QUANTUM_S, **base)
    serial_m, _, _ = replay_run("compare serial", ctrace, fuse_prefill=False, **base)
    if not fused_m["jit_dispatches"] < serial_m["jit_dispatches"]:
        violations.append(
            f"fusion did not reduce dispatches: "
            f"{fused_m['jit_dispatches']} vs {serial_m['jit_dispatches']}")
    out_rows.append((
        "serve_scale/dispatches_vs_serial", 0.0,
        f"fused={fused_m['jit_dispatches']};"
        f"serial={serial_m['jit_dispatches']};"
        f"saved_pct={100 * (1 - fused_m['jit_dispatches'] / max(serial_m['jit_dispatches'], 1)):.1f}",
    ))

    # ---- batched replica axis: cross-mode identity ------------------------
    # ONE step over a replica bank per fused group streams to the SAME
    # sha256 as the members' own steps on the same trace
    cross_m, cross_sha, _ = replay_run("compare cross", ctrace, fusion_quantum_s=QUANTUM_S,
                                       batch_replicas=not batched)
    if cross_sha != fused_sha:
        violations.append(
            "batched fused dispatch NOT byte-identical to the tuple dispatch")
    bat_m = fused_m if batched else cross_m
    if bat_m["batched_decode_calls"] == 0:
        violations.append("batched replica axis was never exercised")
    out_rows.append((
        "serve_scale/batched_identity", 0.0,
        f"byte_identical={cross_sha == fused_sha};"
        f"batched_decode_calls={bat_m['batched_decode_calls']};"
        f"bank_rebuilds={bat_m['bank_rebuilds']}",
    ))

    # ---- quantum semantics ------------------------------------------------
    q0_m, q0_sha, _ = replay_run("quantum 0", ctrace, fusion_quantum_s=0.0, **base)
    exact_m, exact_sha, _ = replay_run("exact", ctrace, **base)
    if q0_sha != exact_sha:
        violations.append("quantum=0 NOT byte-identical to exact-tie engine")
    if fused_sha != q0_sha:
        # the quantum only regroups dispatches: outputs/stamps/joules are
        # invariant, so even the positive-quantum replay matches
        violations.append("positive quantum changed the replay fingerprint")
    out_rows.append((
        "serve_scale/quantum", 0.0,
        f"q0_identical={q0_sha == exact_sha};"
        f"q_invariant={fused_sha == q0_sha};quantum_s={QUANTUM_S}",
    ))

    # ---- dispatch wall vs group size: batched must win at >= 8 ------------
    # only in the primary (batched) invocation: the curve already measures
    # BOTH modes per point
    curve = {}
    if batched:
        curve = dispatch_curve(smoke, params_for, n_requests=n_curve, on_run=on_run, **kw)
        for g, point in sorted(curve.items(), key=lambda kv: int(kv[0])):
            b = point["batched"]["us_per_fused_call"]
            t = point["tuple"]["us_per_fused_call"]
            if int(g) >= 8 and not b < t:
                violations.append(
                    f"batched dispatch slower at group size {g}: "
                    f"{b:.0f}us vs tuple {t:.0f}us per fused call")
            out_rows.append((
                f"serve_scale/dispatch_curve/g{g}", b,
                f"batched_us_per_call={b:.0f};tuple_us_per_call={t:.0f};"
                f"speedup={t / max(b, 1e-9):.2f}x;"
                f"calls={point['batched']['fused_calls']}",
            ))

    # ---- wall budget ------------------------------------------------------
    slowest = max(wall_a, wall_b)
    if TIME_BUDGET_S > 0:
        if slowest > TIME_BUDGET_S:
            violations.append(
                f"a replay took {slowest:.1f}s "
                f"(> {TIME_BUDGET_S:.0f}s budget)")
        out_rows.append((
            "serve_scale/wall_time", 0.0,
            f"slowest_replay_s={slowest:.1f};budget_s={TIME_BUDGET_S:.0f}",
        ))

    results: Dict[str, Any] = {
        "scale": first, "scale_sha": sha_a, "aligned": amet,
        "dispatch": {"fused": fused_m["jit_dispatches"],
                     "serial": serial_m["jit_dispatches"]},
        "batched": {"mode": "batched" if batched else "tuple",
                    "cross_mode_identical": cross_sha == fused_sha,
                    "batched_decode_calls": bat_m["batched_decode_calls"],
                    "bank_rebuilds": bat_m["bank_rebuilds"]},
        "dispatch_curve": curve,
        "wall_s": [wall_a, wall_b]}
    write_csv("serve_scale", ["metric", "value"],
              [[k, v] for k, v in first.items() if k != "engine_stats"]
              + [["aligned_fused_decode_coverage",
                  amet["fused_decode_coverage"]],
                 ["dispatch_fused", fused_m["jit_dispatches"]],
                 ["dispatch_serial", serial_m["jit_dispatches"]]])
    if write_json:
        json_path = JSON_PATH if batched else UNBATCHED_JSON_PATH
        write_bench_json(
            "serve_scale", results, smoke=smoke, path=json_path,
            trace={"n": len(trace), "n_requested": n_scale,
                   "dropped": dropped, "shape": "aligned+drifted",
                   "wave_dt_s": WAVE_DT_S, "quantum_s": QUANTUM_S,
                   "prompt_len": PROMPT_LEN, "max_new": MAX_NEW,
                   "seed": TRACE_SEED, "batched": batched},
        )
        out_rows.append(("serve_scale/json", 0.0, f"wrote={json_path}"))
    if violations:
        raise RecipeViolation(violations)
    return out_rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="4000 / 2000 / 1000 requests, curve 1500 at g 4, 8, 32")
    ap.add_argument("--json", action="store_true", help=f"write {JSON_PATH}")
    ap.add_argument("--batched", default="on", choices=("on", "off"),
                    help="off: replay the tuple baseline")
    ap.add_argument("--requests", type=int, default=None, help="scale trace size")
    ap.add_argument("--aligned", type=int, default=None, help="aligned trace size")
    ap.add_argument("--compare", type=int, default=None, help="compare trace size")
    ap.add_argument("--curve", type=int, default=None, help="curve trace size")
    ap.add_argument("--full-config", action="store_true",
                    help="serve get_config widths (for the card) instead of reduced_config")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)      # no card: fail here, not as a violated check
    ok = True
    try:
        for name, us, derived in run(smoke=args.smoke, write_json=args.json,
                                     batched=args.batched == "on",
                                     full_config=args.full_config, device=args.device,
                                     n_scale=args.requests, n_aligned=args.aligned,
                                     n_compare=args.compare, n_curve=args.curve):
            print(f"{name},{us:.1f},{derived}")
    except RecipeViolation as e:
        print(f"serve_scale checks VIOLATED: {e}")
        ok = False
    print("serve_scale checks:", "OK" if ok else "VIOLATED")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
