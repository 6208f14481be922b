"""Fleet replay: three routing policies over a heterogeneous 3-replica
fleet, under static-lock and closed-loop SLO clocking.

The port's counterpart of the reference's ``benchmarks/serve_fleet.py``:
the same recipe, constants, trace and assertions. A seeded diurnal arrival
trace (mixed short-chat / long-context lengths, a day compressed to
minutes) is replayed in virtual time over three replicas of DIFFERENT
architectures — GQA (qwen3-4b), MLA (minitron-4b-mla), GDN (gdn-4b) —
behind each of the pluggable routers:

    jsq       join-shortest-queue (the load-balancing baseline)
    energy    marginal-joules/token placement (consolidates load: batching
              amortises weight streaming, idle replicas sit at the floor)
    affinity  length-bucketed arch dispatch (long-context -> the arch with
              the flattest energy curve, i.e. GDN's O(1) state)

Each replica holds its own ClockController (mode lock or slo, walked per
replica); replays run on the discrete-event engine, the default of
``run_trace``. ``context_scale`` prices each live trace token as 256
production tokens, so the miniature replay exercises the full configs'
long-context energy regimes.

Asserted, per clock mode:

    energy-aware routing spends <= the joules of join-shortest-queue at
        equal-or-better p99 TBT                    (placement is an energy lever)
    the heterogeneous fleet under arch-affinity beats a homogeneous
        all-GQA fleet on total joules              (heterogeneity pays)
    the replay is byte-identical across runs and each completes in < 60 s

Also reported (the power-down question): the same trace with one replica
drained+powered-down from the start vs. underclocking all three.

By default the pools run ``reduced_config`` widths and the trace is made
against that config; ``--full-config`` runs ``get_config`` widths (random
bf16 weights from a seeded ``torch.Generator``, for the card) and makes the
trace against the full qwen3-4b config, whose vocabulary is the smallest
of the three (every replay refuses a prompt id past any replica's
vocabulary). Modelled joules are priced on the full configs either way.

Run:  python -m repro_torch.benchmarks.serve_fleet --smoke --full-config   # on a card
  or: python -m repro_torch.benchmarks.serve_fleet --smoke --device cpu
  add --json to write BENCH_torch_serve_fleet.json
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Callable, Mapping, Optional

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
from repro_torch.serving import ClockSpec, Fleet, FleetSpec, PoolSpec, ReplicaSpec

HET_ARCHS = ("qwen3-4b", "minitron-4b-mla", "gdn-4b")     # GQA / MLA / GDN
HOMO_ARCHS = ("qwen3-4b",) * 3                            # the GQA monoculture
ROUTERS = ("jsq", "energy", "affinity")
MODES = ("lock", "slo")

BATCH = 8
MAX_SEQ_LEN = 128
KV_BLOCK_SIZE = 8
KV_BLOCKS = 128                     # dense-equivalent budget: no preemption churn
CHUNK_TOKENS = 64
CONTEXT_SCALE = 256.0               # 1 trace token ~ 256 production tokens
MIX_LONG = 0.5                      # long-context fraction of the mixed profile
MEAN_NEW = 12.5                     # mixed-profile mean decode budget
UTILISATION = 0.75                  # mean arrival rate vs serialised capacity
TRACE_SEED = 23
JSON_PATH = "BENCH_torch_serve_fleet.json"
# wall-clock budget for one full replay (the acceptance bar); 0 waives
TIME_BUDGET_S = float(os.environ.get("REPRO_FLEET_TIME_BUDGET_S", "60"))


def fleet_targets(emodel, archs):
    """Model-derived SLO targets + matching diurnal arrival rate. Replicas
    tick concurrently (one round costs the slowest busy replica), so the
    worst TBT is the slowest arch's decode step plus its chunked-prefill
    interleave — target thrice that. Fleet capacity is the SUM of
    per-replica decode throughputs, and the rate is set well above what one
    replica can hold: routing across replicas is load-bearing, not
    cosmetic."""
    f_floor = min(emodel.clock_grid())
    ctx_rep = int(60 * CONTEXT_SCALE)       # mean live context, scaled
    throughput = 0.0
    t_worst = 0.0
    for arch in archs:
        full = get_config(arch)
        t_dec = emodel.profile(
            decode_workload(full, BATCH, ctx_rep, fused=True), f_floor).t_total
        wp = prefill_workload(full, 1, 4096, fused=True)
        prof_p = emodel.profile(wp, emodel.spec.f_max)
        t_chunk = prof_p.t_total / prof_p.tokens * CHUNK_TOKENS
        throughput += BATCH / t_dec
        t_worst = max(t_worst, t_dec + t_chunk)
    # 3x: a fleet round is the slowest replica's tick, and a tick can carry
    # several chunked admissions at a diurnal peak
    tbt_s = 3.0 * t_worst
    ttft_s = 100.0 * tbt_s
    capacity_rps = throughput / MEAN_NEW
    return tbt_s, ttft_s, UTILISATION * capacity_rps


def fleet_spec(archs, router: str, mode: str, tbt_s: float, ttft_s: float, *,
               full_config: bool = False) -> FleetSpec:
    replicas = tuple(
        ReplicaSpec(
            name=f"r{i}-{arch}",
            arch=arch,
            clock=ClockSpec(mode=mode, context_scale=CONTEXT_SCALE,
                            fused=True,     # the pools run the fused kernels;
                                            # price workloads there
                            slo_tbt_s=tbt_s, slo_ttft_s=ttft_s),
            decode=PoolSpec(batch=BATCH, paged=True,
                            kv_block_size=KV_BLOCK_SIZE, kv_blocks=KV_BLOCKS),
            max_seq_len=MAX_SEQ_LEN,
            prefill_chunk_tokens=CHUNK_TOKENS,
            reduced=not full_config,
        )
        for i, arch in enumerate(archs)
    )
    # energy: spill a little before the batch fills — the last slots of a
    # packed replica buy less amortisation than they cost in queueing
    router_args = {"energy": {"headroom": 0.75}}.get(router, {})
    return FleetSpec(replicas=replicas, router=router, router_args=router_args)


def make_trace(n_requests: int, rate_rps: float, *, full_config: bool = False):
    """Made against the GQA config the pools run (lengths are
    arch-agnostic); two diurnal periods span the trace so the replay sees
    both a peak and a valley."""
    cfg = get_config(HET_ARCHS[0]) if full_config else reduced_config(HET_ARCHS[0])
    period_s = max(1.0, n_requests / rate_rps / 2.0)
    return generate_trace(
        cfg, n_requests, arrival="diurnal",
        lengths="mixed", mix_long=MIX_LONG, seed=TRACE_SEED,
        max_total_len=MAX_SEQ_LEN,
        rate_rps=rate_rps, arrival_kwargs={"period_s": period_s},
    )


def replay(archs, router: str, mode: str, trace, tbt_s, ttft_s, *,
           params_for: Mapping[str, Any], drain: str = "",
           full_config: bool = False, device="cuda"):
    """One virtual-time fleet replay; returns (metrics, wall secs, the
    fleet). The metrics hold no wall-clock field."""
    check_vocab(trace, archs, full_config=full_config)
    spec = fleet_spec(archs, router, mode, tbt_s, ttft_s, full_config=full_config)
    # clock=None: two VirtualClocks per replica (decode and prefill)
    fleet = Fleet.from_spec(spec, emodel=h200_model(), params_for=params_for,
                            device=device)
    if drain:
        fleet.drain(drain)
    t0 = time.perf_counter()
    done = fleet.run_trace(trace)
    wall_s = time.perf_counter() - t0
    lat = summarize_latency(done)
    stats = fleet.stats
    measured = fleet.measured_energy_j()
    by_replica = {}
    for r in fleet.replicas:
        served = [q for q in done if q.replica == r.name]
        by_replica[r.name] = {
            "arch": r.arch,
            "completed": len(served),
            "long_served": sum(q.bucket == "long" for q in served),
            "short_served": sum(q.bucket == "short" for q in served),
            "decode_tokens": r.decode_stats.decode_tokens,
            "decode_j": r.decode_stats.decode_j,
            "measured_j": sum(measured[r.name].values()),
            "decode_clock_mhz": r.decode_stats.actual_clock_mhz,
            "peak_occupancy": r.decode_pool.peak_occupancy,
            "powered": r.powered,
        }
    return {
        "routing": router,
        "mode": mode,
        "archs": list(archs),
        "drained": drain,
        "completed": len(done),
        "requests": len(trace),
        "decode_tokens": stats.decode_tokens,
        "decode_j": stats.decode_j,
        "total_j": fleet.total_energy_j(),
        "j_per_decode_token": stats.decode_j / max(stats.decode_tokens, 1),
        "p50_ttft_s": lat.p50_ttft_s,
        "p99_ttft_s": lat.p99_ttft_s,
        "p50_tbt_s": lat.p50_tbt_s,
        "p99_tbt_s": lat.p99_tbt_s,
        "p99_queue_s": lat.p99_queue_s,
        "p99_e2e_s": lat.p99_e2e_s,
        "slo_met": lat.meets(ttft_s=ttft_s, tbt_s=tbt_s),
        "preemptions": sum(r.preemptions for r in done),
        "replicas": by_replica,
        "tbt_target_s": tbt_s,
        "ttft_target_s": ttft_s,
    }, wall_s, fleet


def claim_violations(results) -> list:
    """The recipe's routing claims on its replays (keyed as in ``run``):
    per clock mode, energy-aware placement spends no more than jsq at an
    equal-or-better p99 TBT; the affinity fleet beats the GQA monoculture."""
    out = []
    for mode in MODES:
        jsq, ea = results[f"het/jsq/{mode}"], results[f"het/energy/{mode}"]
        if ea["total_j"] > jsq["total_j"] * (1 + 1e-9):
            out.append(
                f"{mode}: energy-aware routing spent {ea['total_j']:.3f}J "
                f"> jsq's {jsq['total_j']:.3f}J")
        # "equal-or-better": a fleet round is ~one decode step (>= 10 ms
        # here), so differences under a tenth of a round are below the
        # timeline's resolution — treat them as equal
        if ea["p99_tbt_s"] > jsq["p99_tbt_s"] * 1.10:
            out.append(
                f"{mode}: energy-aware p99 TBT {ea['p99_tbt_s']:.4f}s worse "
                f"than jsq's {jsq['p99_tbt_s']:.4f}s beyond round jitter")
    het, homo = results["het/affinity/lock"], results["homo-gqa/affinity/lock"]
    if het["total_j"] >= homo["total_j"]:
        out.append(
            f"heterogeneous affinity fleet spent {het['total_j']:.3f}J, not "
            f"below the homogeneous-GQA fleet's {homo['total_j']:.3f}J")
    return out


def run(smoke: bool = False, write_json: bool = False, *, full_config: bool = False,
        device="cuda", params_for: Optional[Mapping[str, Any]] = None,
        on_run: Optional[Callable[[dict, float, Fleet], None]] = None):
    """Harness contract: yields (name, us_per_call, derived) rows; raises
    ``RecipeViolation`` on any violated routing/energy/determinism
    assertion (any other error propagates as it is). ``params_for`` maps
    arch -> weights of the config the pools run (made once per arch from
    seed 0 when missing); the caller holds them, this module keeps none.
    ``on_run(metrics, wall_s, fleet)`` is called after each replay, the
    determinism replay included, before any of its checks."""
    n_requests = 120 if smoke else 240
    params_for = dict(params_for or {})
    for arch in HET_ARCHS:
        if arch not in params_for:
            params_for[arch] = random_params(arch, full_config=full_config, device=device)
    emodel = h200_model()
    tbt_s, ttft_s, rate_rps = fleet_targets(emodel, HET_ARCHS)
    trace = make_trace(n_requests, rate_rps, full_config=full_config)
    results = {}
    out_rows = []
    violations = []
    wall_by_run = {}

    def replay_hooked(archs, router, mode, **kw):
        r, wall_s, fleet = replay(archs, router, mode, trace, tbt_s, ttft_s,
                                  params_for=params_for, full_config=full_config,
                                  device=device, **kw)
        if on_run is not None:
            on_run(r, wall_s, fleet)
        return r, wall_s

    def one(key, archs, router, mode, **kw):
        r, wall_s = replay_hooked(archs, router, mode, **kw)
        results[key] = r
        wall_by_run[key] = wall_s
        out_rows.append((
            f"serve_fleet/{key}",
            1e6 * r["j_per_decode_token"],        # uJ per decode token
            f"total_j={r['total_j']:.3f};"
            f"p99_tbt_ms={1e3 * r['p99_tbt_s']:.2f};"
            f"p99_queue_ms={1e3 * r['p99_queue_s']:.2f};"
            f"slo_met={r['slo_met']};"
            f"long_to={max(r['replicas'], key=lambda n: r['replicas'][n]['long_served'])}",
        ))
        if r["completed"] != n_requests:
            violations.append(f"{key}: {r['completed']}/{n_requests} completed")
        return r

    for mode in MODES:
        for router in ROUTERS:
            one(f"het/{router}/{mode}", HET_ARCHS, router, mode)
        jsq, ea = results[f"het/jsq/{mode}"], results[f"het/energy/{mode}"]
        out_rows.append((
            f"serve_fleet/energy_vs_jsq/{mode}", 0.0,
            f"saved_pct={100 * (1 - ea['total_j'] / jsq['total_j']):.2f};"
            f"jsq_p99_tbt_ms={1e3 * jsq['p99_tbt_s']:.2f};"
            f"ea_p99_tbt_ms={1e3 * ea['p99_tbt_s']:.2f}",
        ))

    # ---- heterogeneity pays: affinity fleet vs the GQA monoculture -------
    homo = one("homo-gqa/affinity/lock", HOMO_ARCHS, "affinity", "lock")
    het = results["het/affinity/lock"]
    out_rows.append((
        "serve_fleet/het_vs_homo", 0.0,
        f"het_j={het['total_j']:.3f};homo_j={homo['total_j']:.3f};"
        f"saved_pct={100 * (1 - het['total_j'] / homo['total_j']):.2f}",
    ))
    violations += claim_violations(results)

    # ---- the power-down question, reported: power down vs underclock all -
    parked = f"r1-{HET_ARCHS[1]}"
    drained = one("het/jsq/lock/drain1", HET_ARCHS, "jsq", "lock", drain=parked)
    all3 = results["het/jsq/lock"]
    out_rows.append((
        "serve_fleet/power_down_vs_underclock", 0.0,
        f"all3_j={all3['total_j']:.3f};drain1_j={drained['total_j']:.3f};"
        f"drain_saves_pct={100 * (1 - drained['total_j'] / all3['total_j']):.2f};"
        f"drain_p99_tbt_ms={1e3 * drained['p99_tbt_s']:.2f};"
        f"all3_p99_tbt_ms={1e3 * all3['p99_tbt_s']:.2f}",
    ))
    if drained["replicas"][parked]["powered"]:
        violations.append("drained replica never powered down")
    if drained["replicas"][parked]["measured_j"] > 0.0:
        violations.append("drained replica accrued joules while parked")

    # ---- determinism: a second replay must be byte-identical -------------
    again, _ = replay_hooked(HET_ARCHS, "energy", "slo")
    blob_a = json.dumps(deterministic_fields(results["het/energy/slo"]), sort_keys=True)
    blob_b = json.dumps(deterministic_fields(again), sort_keys=True)
    if blob_a != blob_b:
        violations.append("het/energy/slo: replay NOT deterministic")
    out_rows.append((
        "serve_fleet/determinism", 0.0,
        f"byte_identical={blob_a == blob_b};requests={n_requests}",
    ))
    if not smoke and TIME_BUDGET_S > 0:
        slowest = max(wall_by_run.values())
        if slowest > TIME_BUDGET_S:
            violations.append(
                f"a {n_requests}-request fleet replay took {slowest:.1f}s "
                f"(> {TIME_BUDGET_S:.0f}s budget)")
        out_rows.append((
            "serve_fleet/wall_time", 0.0,
            f"slowest_replay_s={slowest:.1f};budget_s={TIME_BUDGET_S:.0f}",
        ))

    flat_keys = [k for k in next(iter(results.values())) if k != "replicas"]
    write_csv("serve_fleet", ["run"] + flat_keys,
              [[k] + [r[f] for f in flat_keys] for k, r in results.items()])
    if write_json:
        write_bench_json(
            "serve_fleet", results, smoke=smoke, path=JSON_PATH,
            trace={"n": n_requests, "arrival": "diurnal", "lengths": "mixed",
                   "mix_long": MIX_LONG, "seed": TRACE_SEED,
                   "rate_rps": rate_rps},
        )
        out_rows.append(("serve_fleet/json", 0.0, f"wrote={JSON_PATH}"))
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
        print(f"serve_fleet checks VIOLATED: {e}")
        ok = False
    print("serve_fleet checks:", "OK" if ok else "VIOLATED")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
