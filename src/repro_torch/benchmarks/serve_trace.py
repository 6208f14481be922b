"""Virtual-time trace replay: default / cap / lock / slo across two archs.

The port's counterpart of the reference's ``benchmarks/serve_trace.py``:
the same recipe and the same assertions. A seeded Poisson arrival trace is
replayed through the paged prefill/decode ``Cluster`` in VIRTUAL time —
step durations come from the energy model at each pool's live operating
point, idle joules accrue between bursts, and every request's ledger
yields TTFT/TBT percentiles — under four controller modes:

    default  governor clock (baseline)
    cap      the industry reflex (must stay INERT on decode)
    lock     the paper's static policy-table fix
    slo      the closed loop: policy prior + measured-p99 grid walk

Asserted, per architecture:

    cap never engages on decode and its clock == default's  (the illusion)
    slo meets its p99 TBT target
    slo decode joules <= lock decode joules whenever lock ALSO meets the
        target  (the loop only ever refines the table downward in energy)
    the replay is deterministic: two runs -> byte-identical JSON

Replays run on the discrete-event engine, the default of ``run_trace``, as
the reference's do.

By default the pools run ``reduced_config`` widths and the trace is made
against that config; ``--full-config`` runs ``get_config`` widths (random
bf16 weights from a seeded ``torch.Generator``, for the card) and makes the
trace against the full config. Each row's ``wall_s`` (left out of the JSON
record) is the host-clock seconds of its replay.

Run:  python -m repro_torch.benchmarks.serve_trace --smoke --full-config   # on a card
  or: python -m repro_torch.benchmarks.serve_trace --smoke --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Callable, Mapping, Optional

from repro_torch.benchmarks.common import (
    deterministic_fields,
    h200_model,
    random_params,
    write_bench_json,
    write_csv,
)
from repro_torch.configs import get_config, reduced_config
from repro_torch.core.clock import VirtualClock
from repro_torch.core.latency import summarize_latency
from repro_torch.core.traces import generate_trace
from repro_torch.core.workload import decode_workload, prefill_workload
from repro_torch.device import resolve_device
from repro_torch.serving import ClockSpec, Cluster, PoolSpec, ReplicaSpec

ARCHS = ("minicpm-2b", "mamba2-780m")
MODES = ("default", "cap", "lock", "slo")

BATCH = 12
MAX_SEQ_LEN = 128
KV_BLOCK_SIZE = 8
KV_BLOCKS = 96                      # 768 cache tokens of HBM budget
CHUNK_TOKENS = 64
CTX_EST = 48                        # mean live context for capacity estimates
MEAN_NEW = 16                       # short_chat mean decode budget
UTILISATION = 0.35                  # arrival rate as a fraction of capacity
TRACE_SEED = 17
JSON_PATH = "BENCH_torch_serve_trace.json"
# wall-clock budget for one 500-request replay (the acceptance bar); 0 waives
TIME_BUDGET_S = float(os.environ.get("REPRO_TRACE_TIME_BUDGET_S", "60"))


def slo_targets(emodel, full_cfg):
    """Model-derived SLO targets + the matching Poisson arrival rate."""
    f_floor = min(emodel.clock_grid())
    t_dec = emodel.profile(decode_workload(full_cfg, BATCH, CTX_EST), f_floor).t_total
    # worst chunked-prefill interleave per tick: ~CHUNK_TOKENS of prompt at
    # the prefill pool's (high) clock
    wp = prefill_workload(full_cfg, 1, 4096)
    prof_p = emodel.profile(wp, emodel.spec.f_max)
    t_chunk = prof_p.t_total / prof_p.tokens * CHUNK_TOKENS
    tbt_s = 2.0 * (t_dec + t_chunk)
    ttft_s = 100.0 * tbt_s
    capacity_rps = BATCH / t_dec / MEAN_NEW
    return tbt_s, ttft_s, UTILISATION * capacity_rps


def replica_spec(arch: str, mode: str, tbt_s: float, ttft_s: float, *,
                 full_config: bool = False) -> ReplicaSpec:
    """The declarative build: one spec describes the whole replica."""
    return ReplicaSpec(
        name=f"{arch}-{mode}",
        arch=arch,
        clock=ClockSpec(mode=mode, context=CTX_EST,
                        slo_tbt_s=tbt_s, slo_ttft_s=ttft_s),
        decode=PoolSpec(batch=BATCH, paged=True,
                        kv_block_size=KV_BLOCK_SIZE, kv_blocks=KV_BLOCKS),
        max_seq_len=MAX_SEQ_LEN,
        prefill_chunk_tokens=CHUNK_TOKENS,
        reduced=not full_config,
    )


def make_trace(arch: str, n_requests: int, rate_rps: float, *, full_config: bool = False):
    """The seeded Poisson trace, made against the config the pools run."""
    cfg = get_config(arch) if full_config else reduced_config(arch)
    return generate_trace(
        cfg, n_requests, arrival="poisson", lengths="short_chat",
        rate_rps=rate_rps, seed=TRACE_SEED, max_total_len=MAX_SEQ_LEN,
    )


def replay(arch: str, mode: str, trace, tbt_s: float, ttft_s: float, *,
           params: Any = None, full_config: bool = False, device="cuda"):
    """One virtual-time replay; returns (metrics, wall secs, the cluster).
    The metrics hold no wall-clock field."""
    if params is None:
        params = random_params(arch, full_config=full_config, device=device)
    cluster = Cluster.from_spec(
        replica_spec(arch, mode, tbt_s, ttft_s, full_config=full_config),
        emodel=h200_model(), params=params, clock=VirtualClock(),
        device=device,
    )
    ctl = cluster.controller
    t0 = time.perf_counter()
    done = cluster.run_trace(trace)
    wall_s = time.perf_counter() - t0
    lat = summarize_latency(done)
    dec = cluster.decode_stats
    measured = cluster.measured_energy_j()
    return {
        "arch": arch,
        "mode": mode,
        "completed": len(done),
        "requests": len(trace),
        "decode_tokens": dec.decode_tokens,
        "decode_j": dec.decode_j,
        "j_per_decode_token": dec.decode_j / max(dec.decode_tokens, 1),
        "decode_tokens_per_vs": dec.decode_tokens / max(dec.decode_s, 1e-12),
        "virtual_makespan_s": dec.decode_s + cluster.prefill_stats.prefill_s,
        "p50_ttft_s": lat.p50_ttft_s,
        "p99_ttft_s": lat.p99_ttft_s,
        "p50_tbt_s": lat.p50_tbt_s,
        "p99_tbt_s": lat.p99_tbt_s,
        "p99_e2e_s": lat.p99_e2e_s,
        "slo_met": lat.meets(ttft_s=ttft_s, tbt_s=tbt_s),
        "decode_clock_mhz": dec.actual_clock_mhz,
        "decode_engaged": dec.lever_engaged,
        "prefill_clock_mhz": cluster.prefill_stats.actual_clock_mhz,
        "measured_decode_j": measured["decode"],
        "measured_prefill_j": measured["prefill"],
        "transitions": len(ctl.transitions),
        "preemptions": sum(r.preemptions for r in done),
        "tbt_target_s": tbt_s,
        "ttft_target_s": ttft_s,
    }, wall_s, cluster


def run(smoke: bool = False, write_json: bool = False, *, full_config: bool = False,
        device="cuda", params_for: Optional[Mapping[str, Any]] = None,
        on_run: Optional[Callable[[dict, float, Cluster], None]] = None):
    """Harness contract: yields (name, us_per_call, derived) rows; raises on
    any violated ordering/SLO/determinism assertion. ``params_for`` maps
    arch -> weights of the config the pools run (made once per arch from
    seed 0 when missing). Each replay's wall seconds are in the rows.
    ``on_run(metrics, wall_s, cluster)`` is called after each replay, the
    determinism replay included, before any of its checks."""
    n_requests = 60 if smoke else 500
    params_for = dict(params_for or {})
    results = {}
    out_rows = []
    violations = []
    wall_by_run = {}
    for arch in ARCHS:
        if arch not in params_for:
            params_for[arch] = random_params(arch, full_config=full_config, device=device)
        emodel = h200_model()
        tbt_s, ttft_s, rate_rps = slo_targets(emodel, get_config(arch))
        trace = make_trace(arch, n_requests, rate_rps, full_config=full_config)
        by_mode = {}
        for mode in MODES:
            r, wall_s, cluster = replay(arch, mode, trace, tbt_s, ttft_s,
                                        params=params_for[arch], full_config=full_config,
                                        device=device)
            if on_run is not None:
                on_run(r, wall_s, cluster)
            by_mode[mode] = r
            results[f"{arch}/{mode}"] = r
            wall_by_run[f"{arch}/{mode}"] = wall_s
            out_rows.append((
                f"serve_trace/{arch}/{mode}",
                1e6 * r["j_per_decode_token"],       # uJ per decode token
                f"tok_per_vs={r['decode_tokens_per_vs']:.1f};"
                f"p99_tbt_ms={1e3 * r['p99_tbt_s']:.3f};"
                f"p99_ttft_ms={1e3 * r['p99_ttft_s']:.2f};"
                f"clock={r['decode_clock_mhz']:.0f};"
                f"slo_met={r['slo_met']};transitions={r['transitions']};"
                f"wall_s={wall_s:.3f}",
            ))
            if r["completed"] != n_requests:
                violations.append(
                    f"{arch}/{mode}: {r['completed']}/{n_requests} completed")
        violations += claim_violations(arch, by_mode, tbt_s)
        slo, lock = by_mode["slo"], by_mode["lock"]
        out_rows.append((
            f"serve_trace/{arch}/slo_vs_lock",
            0.0,
            f"slo_j={slo['decode_j']:.3f};lock_j={lock['decode_j']:.3f};"
            f"saved_pct={100 * (1 - slo['decode_j'] / lock['decode_j']):.2f};"
            f"slo_clock={slo['decode_clock_mhz']:.0f};"
            f"lock_clock={lock['decode_clock_mhz']:.0f}",
        ))
    # ---- determinism: a second replay must be byte-identical -------------
    arch = ARCHS[0]
    emodel = h200_model()
    tbt_s, ttft_s, rate_rps = slo_targets(emodel, get_config(arch))
    trace = make_trace(arch, n_requests, rate_rps, full_config=full_config)
    again, wall_again, cluster = replay(arch, "slo", trace, tbt_s, ttft_s,
                                        params=params_for[arch], full_config=full_config,
                                        device=device)
    if on_run is not None:
        on_run(again, wall_again, cluster)
    blob_a = json.dumps(deterministic_fields(results[f"{arch}/slo"]), sort_keys=True)
    blob_b = json.dumps(deterministic_fields(again), sort_keys=True)
    if blob_a != blob_b:
        violations.append(f"{arch}/slo: replay NOT deterministic")
    out_rows.append((
        "serve_trace/determinism", 0.0,
        f"byte_identical={blob_a == blob_b};requests={n_requests};wall_s={wall_again:.3f}",
    ))
    if not smoke and TIME_BUDGET_S > 0:
        slowest = max(wall_by_run.values())
        if slowest > TIME_BUDGET_S:
            violations.append(
                f"a {n_requests}-request replay took {slowest:.1f}s "
                f"(> {TIME_BUDGET_S:.0f}s budget)")
        out_rows.append((
            "serve_trace/wall_time", 0.0,
            f"slowest_replay_s={slowest:.1f};budget_s={TIME_BUDGET_S:.0f}",
        ))
    keys = list(next(iter(results.values())).keys())
    write_csv("serve_trace", keys, [[r[k] for k in keys] for r in results.values()])
    if write_json:
        write_bench_json(
            "serve_trace", results, smoke=smoke, path=JSON_PATH,
            trace={"n": n_requests, "arrival": "poisson",
                   "lengths": "short_chat", "seed": TRACE_SEED},
        )
        out_rows.append(("serve_trace/json", 0.0, f"wrote={JSON_PATH}"))
    if violations:
        raise RuntimeError("; ".join(violations))
    return out_rows


def claim_violations(arch: str, by_mode, tbt_s: float) -> list:
    """The recipe's claims on one arch's default / cap / lock / slo rows."""
    cap, default = by_mode["cap"], by_mode["default"]
    lock, slo = by_mode["lock"], by_mode["slo"]
    out = []
    if cap["decode_engaged"]:
        out.append(f"{arch}: power cap ENGAGED on decode")
    if cap["decode_clock_mhz"] != default["decode_clock_mhz"]:
        out.append(f"{arch}: inert cap drifted from default clock")
    if not slo["slo_met"]:
        out.append(
            f"{arch}: slo mode missed its target "
            f"(p99 TBT {slo['p99_tbt_s']:.4f}s vs {tbt_s:.4f}s)")
    if lock["slo_met"] and slo["decode_j"] > lock["decode_j"] * (1 + 1e-9):
        out.append(
            f"{arch}: slo decode energy {slo['decode_j']:.3f}J exceeds "
            f"lock's {lock['decode_j']:.3f}J though both meet the SLO")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true", help="60-request traces")
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
    except RuntimeError as e:
        print(f"serve_trace checks VIOLATED: {e}")
        ok = False
    print("serve_trace checks:", "OK" if ok else "VIOLATED")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
