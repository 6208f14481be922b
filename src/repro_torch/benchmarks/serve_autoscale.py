"""Fleet autoscaling replay: queue-reactive vs forecast-led drain/power-up
against a statically-provisioned fleet, on one diurnal trace.

The port's counterpart of the reference's ``benchmarks/serve_autoscale.py``:
the same recipe, constants, traces and assertions. Decode parks a 700 W
GPU at 137-300 W, so the joules a fleet sheds live in WHICH replicas are
powered. A seeded diurnal trace (two day-periods compressed to virtual
seconds) is replayed over a 4-replica qwen3-4b fleet on one weight set,
behind ``jsq``, under three provisioning modes:

    static4    all four replicas powered for the whole trace (idle floors
               burn through every valley)
    queue      reactive autoscaler: power up on a rolling queue-delay p95
               breach, drain after a sustained-slack hysteresis window
    schedule   anticipatory autoscaler: Holt (EWMA level+trend) arrival
               forecast powers replicas up AHEAD of the diurnal ramp, so
               the modelled warm-up (idle watts, no admission) is paid
               before the peak lands instead of during it

Replays run on the discrete-event engine, the default of ``run_trace``;
the four dense decode pools share one weight set, so same-instant decode
steps of four live replicas go out as one fused dispatch. A powered-down
replica keeps its caches and its captured decode graph: power is modelled,
not released.

Asserted:

    each autoscaled replay spends < static4 total joules while holding
        equal-or-better p99 TBT (within one-round jitter, or inside the
        SLO target)                                (powering down > capping)
    schedule beats queue on mean TTFT over the diurnal ramp windows
    a replica the autoscaler never powers up accrues EXACTLY zero joules
        (valley-rate replay: the fleet stays at min_replicas)
    the autoscaled replay is byte-identical across runs and < 60 s each

By default the pools run ``reduced_config`` widths and the traces are made
against that config; ``--full-config`` runs ``get_config`` widths (random
bf16 weights from a seeded ``torch.Generator``, for the card) and makes the
traces against the full config. Modelled joules are priced on the full
config either way.

Run:  python -m repro_torch.benchmarks.serve_autoscale --smoke --full-config   # on a card
  or: python -m repro_torch.benchmarks.serve_autoscale --smoke --device cpu
  add --json to write BENCH_torch_serve_autoscale.json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Any, Callable, Mapping, Optional

import numpy as np

from repro_torch.benchmarks.common import (
    RecipeViolation,
    check_vocab,
    deterministic_fields,
    h200_model,
    random_params,
    write_bench_json,
    write_csv,
)
from repro_torch.configs import get_config, reduced_config
from repro_torch.core.latency import summarize_latency
from repro_torch.core.traces import generate_trace
from repro_torch.core.workload import decode_workload, prefill_workload
from repro_torch.device import resolve_device
from repro_torch.serving import (
    AutoscalerSpec,
    ClockSpec,
    Fleet,
    FleetSpec,
    PoolSpec,
    ReplicaSpec,
)

ARCH = "qwen3-4b"
N_REPLICAS = 4
BATCH = 8
MAX_SEQ_LEN = 128
CHUNK_TOKENS = 64
CONTEXT_SCALE = 256.0               # 1 trace token ~ 256 production tokens
MIX_LONG = 0.5
MEAN_NEW = 12.5                     # mixed-profile mean decode budget
TRACE_SEED = 31
DIURNAL_DEPTH = 0.8                 # valley = 0.2x mean, peak = 1.8x mean
RATE_X = 1.4                        # mean arrival rate vs ONE replica's capacity
VALLEY_RATE_X = 0.35                # the valley-only replay: one replica's worth
JSON_PATH = "BENCH_torch_serve_autoscale.json"
# wall-clock budget for one replay (the acceptance bar); 0 waives
TIME_BUDGET_S = float(os.environ.get("REPRO_AUTOSCALE_TIME_BUDGET_S", "60"))


def autoscale_targets(emodel):
    """Model-derived capacity + SLO targets for the homogeneous fleet.
    One replica's serviceable rate is its floor-clock full-batch decode
    throughput over the mean decode budget; the TBT target leaves the
    same 3x chunked-admission headroom serve_fleet uses."""
    full = get_config(ARCH)
    f_floor = min(emodel.clock_grid())
    ctx_rep = int(60 * CONTEXT_SCALE)
    t_dec = emodel.profile(
        decode_workload(full, BATCH, ctx_rep, fused=True), f_floor).t_total
    wp = prefill_workload(full, 1, 4096, fused=True)
    prof_p = emodel.profile(wp, emodel.spec.f_max)
    t_chunk = prof_p.t_total / prof_p.tokens * CHUNK_TOKENS
    replica_rps = BATCH / t_dec / MEAN_NEW
    tbt_s = 3.0 * (t_dec + t_chunk)
    ttft_s = 100.0 * tbt_s
    return tbt_s, ttft_s, replica_rps, t_dec


def autoscaler_spec(policy: str, *, t_dec: float, replica_rps: float,
                    period_s: float, tbt_s: float) -> AutoscalerSpec:
    """Both policies share bounds, warm-up cost and hysteresis; signal
    constants derive from the modelled step time and the diurnal period so
    the miniature replay and a production trace get the same *shape*."""
    return AutoscalerSpec(
        policy=policy,
        min_replicas=1,
        max_replicas=N_REPLICAS,
        # warm-up ~ an eighth of the ramp: long enough that paying it
        # inside the ramp (the reactive policy) visibly costs TTFT
        warmup_s=8.0 * t_dec,
        tick_interval_s=t_dec,
        hold_s=period_s / 6.0,
        # queue policy: breach when p95 queue delay exceeds the TBT target
        queue_p95_target_s=tbt_s,
        slack=0.5,
        window_s=12.0 * t_dec,
        # schedule policy: sample the arrival rate every other step and
        # look one warm-up ahead of the warm-up itself
        sample_interval_s=2.0 * t_dec,
        ewma_alpha=0.4,
        trend_beta=0.3,
        replica_rps=replica_rps,
        target_utilisation=0.7,
        lead_s=8.0 * t_dec,
    )


def fleet_spec(mode: str, tbt_s: float, ttft_s: float, scaler: AutoscalerSpec, *,
               full_config: bool = False) -> FleetSpec:
    replicas = tuple(
        ReplicaSpec(
            name=f"r{i}",
            arch=ARCH,
            clock=ClockSpec(mode="lock", context_scale=CONTEXT_SCALE,
                            fused=True, slo_tbt_s=tbt_s, slo_ttft_s=ttft_s),
            decode=PoolSpec(batch=BATCH),
            max_seq_len=MAX_SEQ_LEN,
            prefill_chunk_tokens=CHUNK_TOKENS,
            reduced=not full_config,
        )
        for i in range(N_REPLICAS)
    )
    return FleetSpec(replicas=replicas, router="jsq",
                     autoscaler=None if mode == "static" else scaler)


def make_trace(n_requests: int, rate_rps: float, period_s: float, *,
               full_config: bool = False):
    cfg = get_config(ARCH) if full_config else reduced_config(ARCH)
    return generate_trace(
        cfg, n_requests, arrival="diurnal",
        lengths="mixed", mix_long=MIX_LONG, seed=TRACE_SEED,
        max_total_len=MAX_SEQ_LEN, rate_rps=rate_rps,
        arrival_kwargs={"period_s": period_s, "depth": DIURNAL_DEPTH},
    )


def ramp_ttft_s(done, period_s: float) -> float:
    """Mean TTFT of requests arriving on the diurnal up-ramp (the rate
    climbs from the mean toward the peak over the first quarter-period) —
    the window where anticipatory power-up either landed warm capacity or
    didn't. Folded across both trace periods. 0.0 if nothing completed or
    the window is empty (the completion-count violation reports the why)."""
    if not done:
        return 0.0
    t0 = min(r.ledger.arrival_s for r in done)
    xs = [r.ledger.ttft_s for r in done
          if r.ledger.ttft_s is not None
          and 0.02 * period_s <= ((r.ledger.arrival_s - t0) % period_s)
          <= 0.30 * period_s]
    return float(np.mean(xs)) if xs else 0.0


def replay(mode: str, trace, tbt_s, ttft_s, scaler: AutoscalerSpec, period_s: float, *,
           params: Any, full_config: bool = False, device="cuda"):
    """One virtual-time replay; returns (metrics, wall secs, the fleet).
    The metrics hold no wall-clock field. Every replica serves ``params``."""
    check_vocab(trace, (ARCH,), full_config=full_config)
    spec = fleet_spec(mode, tbt_s, ttft_s, scaler, full_config=full_config)
    fleet = Fleet.from_spec(spec, emodel=h200_model(), params_for={ARCH: params},
                            device=device)
    t0 = time.perf_counter()
    done = fleet.run_trace(trace)
    wall_s = time.perf_counter() - t0
    lat = summarize_latency(done)
    stats = fleet.stats
    measured = fleet.measured_energy_j()
    by_replica = {
        r.name: {
            "completed": sum(q.replica == r.name for q in done),
            "decode_tokens": r.decode_stats.decode_tokens,
            "measured_j": sum(measured[r.name].values()),
            "powered": r.powered,
            "power_ups": sum(e.replica == r.name and e.action == "power_up"
                             for e in fleet.scale_events),
        }
        for r in fleet.replicas
    }
    events = [dataclasses.asdict(e) for e in fleet.scale_events]
    return {
        "mode": mode,
        "completed": len(done),
        "requests": len(trace),
        "decode_tokens": stats.decode_tokens,
        "total_j": fleet.total_energy_j(),
        "j_per_decode_token": stats.decode_j / max(stats.decode_tokens, 1),
        "p50_ttft_s": lat.p50_ttft_s,
        "p99_ttft_s": lat.p99_ttft_s,
        "ramp_ttft_s": ramp_ttft_s(done, period_s),
        "p99_tbt_s": lat.p99_tbt_s,
        "p99_queue_s": lat.p99_queue_s,
        "slo_met": lat.n_requests > 0 and lat.meets(ttft_s=ttft_s, tbt_s=tbt_s),
        "scale_events": events,
        "n_power_ups": sum(e["action"] == "power_up" for e in events),
        "n_reclaims": sum(e["action"] == "reclaim" for e in events),
        "n_power_downs": sum(e["action"] == "power_down" for e in events),
        "replicas": by_replica,
        "tbt_target_s": tbt_s,
        "ttft_target_s": ttft_s,
    }, wall_s, fleet


def claim_violations(results, tbt_s: float) -> list:
    """The recipe's scaling claims on its replays (keyed as in ``run``):
    each autoscaled replay below static4's joules at an equal-or-better
    p99 TBT, having cycled a replica; schedule's ramp TTFT no worse than
    queue's; three replicas parked through the valley replay."""
    static, queue, sched = results["static4"], results["queue"], results["schedule"]
    out = []
    for key, r in (("queue", queue), ("schedule", sched)):
        if r["total_j"] >= static["total_j"]:
            out.append(
                f"{key}: autoscaled fleet spent {r['total_j']:.3f}J, not "
                f"below static4's {static['total_j']:.3f}J")
        # "equal-or-better": within a tenth of a fleet round of static4's
        # p99, or inside the SLO target outright — consolidation onto fewer
        # replicas may not beat four idle-warm ones on raw latency, but it
        # must not cost SLO attainment
        if r["p99_tbt_s"] > max(static["p99_tbt_s"] * 1.10, tbt_s):
            out.append(
                f"{key}: p99 TBT {r['p99_tbt_s']:.4f}s worse than static4's "
                f"{static['p99_tbt_s']:.4f}s beyond round jitter AND outside "
                f"the {tbt_s:.4f}s target")
        if r["n_power_ups"] < 1 or r["n_power_downs"] < 1:
            out.append(f"{key}: autoscaler never cycled a replica "
                       f"(ups={r['n_power_ups']}, downs={r['n_power_downs']})")
    if sched["ramp_ttft_s"] > queue["ramp_ttft_s"]:
        out.append(
            f"schedule ramp TTFT {sched['ramp_ttft_s']:.4f}s did not beat "
            f"queue's {queue['ramp_ttft_s']:.4f}s — forecast power-up "
            f"landed no warm capacity ahead of the peak")
    parked = parked_replicas(results["valley"])
    if len(parked) != N_REPLICAS - 1:
        out.append(
            f"valley: expected {N_REPLICAS - 1} replicas to stay parked at "
            f"one-replica load, got {sorted(parked)}")
    return out


def parked_replicas(valley) -> dict:
    """The valley replay's replicas, other than r0, never powered up."""
    return {n: d for n, d in valley["replicas"].items()
            if d["power_ups"] == 0 and n != "r0"}


def run(smoke: bool = False, write_json: bool = False, *, full_config: bool = False,
        device="cuda", params_for: Optional[Mapping[str, Any]] = None,
        on_run: Optional[Callable[[dict, float, Fleet], None]] = None):
    """Harness contract: yields (name, us_per_call, derived) rows; raises
    ``RecipeViolation`` on any violated scaling/energy/determinism
    assertion (any other error propagates as it is). ``params_for`` maps
    the arch to the one weight set of the config the pools run, shared by
    the four replicas (made from seed 0 when missing); the caller holds
    them, this module keeps none. ``on_run(metrics, wall_s, fleet)`` is called after
    each replay, the determinism replay included, before any of its
    checks."""
    n_requests = 120 if smoke else 240
    params = (params_for or {}).get(ARCH)
    if params is None:
        params = random_params(ARCH, full_config=full_config, device=device)
    emodel = h200_model()
    tbt_s, ttft_s, replica_rps, t_dec = autoscale_targets(emodel)
    rate_rps = RATE_X * replica_rps
    period_s = n_requests / rate_rps / 2.0      # two diurnal periods
    scaler_q = autoscaler_spec("queue", t_dec=t_dec, replica_rps=replica_rps,
                               period_s=period_s, tbt_s=tbt_s)
    scaler_s = dataclasses.replace(scaler_q, policy="schedule")
    trace = make_trace(n_requests, rate_rps, period_s, full_config=full_config)

    results = {}
    out_rows = []
    violations = []
    wall_by_run = {}

    def replay_hooked(mode, tr, scaler):
        r, wall_s, fleet = replay(mode, tr, tbt_s, ttft_s, scaler, period_s, params=params,
                                  full_config=full_config, device=device)
        if on_run is not None:
            on_run(r, wall_s, fleet)
        return r, wall_s

    def one(key, mode, tr, scaler, n_expect):
        r, wall_s = replay_hooked(mode, tr, scaler)
        results[key] = r
        wall_by_run[key] = wall_s
        out_rows.append((
            f"serve_autoscale/{key}",
            1e6 * r["j_per_decode_token"],
            f"total_j={r['total_j']:.3f};"
            f"p99_tbt_ms={1e3 * r['p99_tbt_s']:.2f};"
            f"ramp_ttft_ms={1e3 * r['ramp_ttft_s']:.2f};"
            f"ups={r['n_power_ups']};downs={r['n_power_downs']};"
            f"slo_met={r['slo_met']}",
        ))
        if r["completed"] != n_expect:
            violations.append(f"{key}: {r['completed']}/{n_expect} completed")
        return r

    static = one("static4", "static", trace, scaler_q, n_requests)
    queue = one("queue", "queue", trace, scaler_q, n_requests)
    sched = one("schedule", "schedule", trace, scaler_s, n_requests)
    for key, r in (("queue", queue), ("schedule", sched)):
        out_rows.append((
            f"serve_autoscale/{key}_vs_static", 0.0,
            f"saved_pct={100 * (1 - r['total_j'] / static['total_j']):.2f};"
            f"static_p99_tbt_ms={1e3 * static['p99_tbt_s']:.2f};"
            f"{key}_p99_tbt_ms={1e3 * r['p99_tbt_s']:.2f}",
        ))
    out_rows.append((
        "serve_autoscale/schedule_vs_queue_ramp", 0.0,
        f"queue_ramp_ttft_ms={1e3 * queue['ramp_ttft_s']:.2f};"
        f"schedule_ramp_ttft_ms={1e3 * sched['ramp_ttft_s']:.2f};"
        f"saved_pct={100 * (1 - sched['ramp_ttft_s'] / max(queue['ramp_ttft_s'], 1e-12)):.2f}",
    ))

    # ---- a never-powered replica accrues EXACTLY zero joules -------------
    n_valley = max(20, n_requests // 4)
    valley_trace = make_trace(n_valley, VALLEY_RATE_X * replica_rps, period_s,
                              full_config=full_config)
    valley = one("valley", "queue", valley_trace, scaler_q, n_valley)
    for name, d in parked_replicas(valley).items():
        if d["measured_j"] != 0.0:
            violations.append(
                f"valley: parked replica {name} accrued {d['measured_j']}J")
    violations += claim_violations(results, tbt_s)

    # ---- determinism: a second replay must be byte-identical -------------
    again, _ = replay_hooked("schedule", trace, scaler_s)
    blob_a = json.dumps(deterministic_fields(sched), sort_keys=True)
    blob_b = json.dumps(deterministic_fields(again), sort_keys=True)
    if blob_a != blob_b:
        violations.append("schedule: replay NOT deterministic")
    out_rows.append((
        "serve_autoscale/determinism", 0.0,
        f"byte_identical={blob_a == blob_b};requests={n_requests}",
    ))
    if TIME_BUDGET_S > 0:
        slowest = max(wall_by_run.values())
        if slowest > TIME_BUDGET_S:
            violations.append(
                f"a replay took {slowest:.1f}s (> {TIME_BUDGET_S:.0f}s budget)")
        out_rows.append((
            "serve_autoscale/wall_time", 0.0,
            f"slowest_replay_s={slowest:.1f};budget_s={TIME_BUDGET_S:.0f}",
        ))

    flat_keys = [k for k in static if k not in ("replicas", "scale_events")]
    write_csv("serve_autoscale", ["run"] + flat_keys,
              [[k] + [r[f] for f in flat_keys] for k, r in results.items()])
    if write_json:
        write_bench_json(
            "serve_autoscale", results, smoke=smoke, path=JSON_PATH,
            trace={"n": n_requests, "arrival": "diurnal", "lengths": "mixed",
                   "mix_long": MIX_LONG, "seed": TRACE_SEED,
                   "rate_rps": rate_rps, "period_s": period_s,
                   "depth": DIURNAL_DEPTH},
        )
        out_rows.append(("serve_autoscale/json", 0.0, f"wrote={JSON_PATH}"))
    if violations:
        raise RecipeViolation(violations)
    return out_rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true", help="120-request trace (240 without)")
    ap.add_argument("--json", action="store_true", help=f"write {JSON_PATH}")
    ap.add_argument("--full-config", action="store_true",
                    help="serve get_config widths (for the card) instead of reduced_config")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)      # no card: fail here, not as a violated check
    ok = True
    try:
        for name, us, derived in run(smoke=args.smoke, write_json=args.json,
                                     full_config=args.full_config, device=args.device):
            print(f"{name},{us:.1f},{derived}")
    except RecipeViolation as e:
        print(f"serve_autoscale checks VIOLATED: {e}")
        ok = False
    print("serve_autoscale checks:", "OK" if ok else "VIOLATED")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
