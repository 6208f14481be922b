"""Copy-on-write prefix sharing: what trunk reuse does to the phase split.

The port's counterpart of the reference's ``benchmarks/serve_prefix.py``:
the same recipe, constants, traces and assertions. Conversation-tree
workloads (multi-turn chat, agentic fan-out) re-send a shared trunk of
tokens with every child request. A prefix-sharing decode pool serves those
positions from refcounted cached pages and prefills only the un-shared
suffix; the avoided prefill is banked as a *side-channel*
(``saved_prefill_j``), never added to any energy total. The benchmark
meters that trade on one trace family across three cache configurations,
sweeping the share of tree-shaped traffic, each replayed on the event
engine:

    dense       dense KV cache, no paging, no sharing (JSQ routing)
    paged       paged KV cache, sharing off (JSQ routing) — the baseline
                the sharing claim is priced against
    cow         paged + copy-on-write prefix sharing, trunk-affinity
                routing (``router="prefix"``)

Asserted (the acceptance gate):

    token streams byte-identical across ALL THREE configs at every share
        level (sharing may move joules and time, never tokens)
    cow replay byte-identical when run twice (sha256 over outputs +
        ledger stamps + measured joules)
    at the full-tree share level: achieved prefix-hit rate >= 0.5, and
        cow total joules AND p99 TTFT strictly below paged's
    saved-prefill joules > 0 and attributed conservatively: per-request
        energies sum to the pool phase totals exactly (the saved joules
        live outside both), and the energy split shifts toward decode
    with no tree traffic (share 0.0) sharing changes nothing: zero hits,
        zero saved joules

By default the pools run ``reduced_config`` widths; ``--full-config`` runs
``get_config`` widths (random bf16 weights from a seeded
``torch.Generator``, for the card), with the traces made against that
config.

Run:  python -m repro_torch.benchmarks.serve_prefix --smoke --full-config   # on a card
  or: python -m repro_torch.benchmarks.serve_prefix --smoke --device cpu
  add --json to write BENCH_torch_serve_prefix.json
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from typing import Any, Callable, Mapping, Optional

from repro_torch.benchmarks.common import (
    RecipeViolation,
    h200_model,
    random_params,
    write_bench_json,
    write_csv,
)
from repro_torch.configs import get_config, reduced_config
from repro_torch.core.latency import summarize_latency
from repro_torch.core.traces import (
    generate_conversation_trace,
    generate_fanout_trace,
    generate_trace,
)
from repro_torch.device import resolve_device
from repro_torch.serving import ClockSpec, Fleet, FleetSpec, PoolSpec, ReplicaSpec

ARCH = "gemma-2b"
# the sweep runs single-replica so dense/paged/cow differ ONLY in cache
# organisation (with 2+ replicas, trunk-affinity routing consolidates load
# differently than JSQ and the latency comparison stops isolating sharing);
# the router is demonstrated separately on a ROUTING_REPLICAS fleet
N_REPLICAS = 1
ROUTING_REPLICAS = 2
BATCH = 8
MAX_SEQ_LEN = 128
BLOCK = 16
KV_BLOCKS = 192
SEED = 11
SHARE_LEVELS = (0.0, 0.5, 1.0)      # fraction of tree-shaped traffic
JSON_PATH = "BENCH_torch_serve_prefix.json"

CONFIGS = ("dense", "paged", "cow")


def make_fleet(config: str, params_for: Mapping[str, Any], *, n: int = N_REPLICAS,
               router: str = "", full_config: bool = False, device="cuda") -> Fleet:
    paged = config != "dense"
    sharing = config == "cow"
    spec = FleetSpec(
        replicas=tuple(
            ReplicaSpec(name=f"r{i}", arch=ARCH,
                        clock=ClockSpec(mode="lock"),
                        decode=PoolSpec(batch=BATCH, paged=paged,
                                        kv_block_size=BLOCK,
                                        kv_blocks=KV_BLOCKS if paged else None,
                                        prefix_sharing=sharing),
                        max_seq_len=MAX_SEQ_LEN, reduced=not full_config)
            for i in range(n)),
        router=router or ("prefix" if sharing else "jsq"),
    )
    return Fleet.from_spec(spec, emodel=h200_model(), params_for=params_for,
                           device=device)


def share_trace(share: float, scale: int, *, full_config: bool = False):
    """One seeded trace with ``share`` of its requests tree-shaped:
    conversation chains + agentic fan-outs (the prefix-hit traffic),
    padded with flat short-chat arrivals to the same total. ``scale``
    multiplies the tree counts; everything interleaves on one timeline."""
    cfg = get_config(ARCH) if full_config else reduced_config(ARCH)
    # dense enough that requests genuinely overlap (queue delay reflects
    # service time, which sharing shortens) while still leaving parents
    # time to finish (ms service) before their children land (100s of ms)
    tree = []
    if share > 0:
        tree += generate_conversation_trace(
            cfg, max(1, round(2 * scale * share)), turns=4,
            system_len=48, think_s=(0.25, 0.5), start_gap_s=0.15,
            seed=SEED, max_total_len=MAX_SEQ_LEN)
        tree += generate_fanout_trace(
            cfg, max(1, round(scale * share)), fanout=4, trunk_len=56,
            gap_s=(0.25, 0.4), start_gap_s=0.2,
            seed=SEED + 1, max_total_len=MAX_SEQ_LEN)
    n_flat = round(len(share_trace(1.0, scale, full_config=full_config)[0]) * (1.0 - share)) \
        if 0.0 < share < 1.0 else (0 if share >= 1.0 else 10 * scale)
    flat = generate_trace(cfg, n_flat, arrival="poisson", lengths="short_chat",
                          rate_rps=8.0, seed=SEED + 2,
                          max_total_len=MAX_SEQ_LEN) if n_flat else []
    trace = sorted(tree + flat, key=lambda r: (r.arrival_s, r.prompt_len))
    return trace, len(tree)


def replay(config: str, trace, params_for: Mapping[str, Any], *, n: int = N_REPLICAS,
           router: str = "", full_config: bool = False, device="cuda"):
    """One event-engine replay; returns (metrics, (stream sha256, replay
    sha256), wall seconds, the fleet, the finished requests sorted by
    arrival)."""
    fleet = make_fleet(config, params_for, n=n, router=router, full_config=full_config,
                       device=device)
    t0 = time.perf_counter()
    done = fleet.run_trace(trace, engine="events")
    wall_s = time.perf_counter() - t0
    done = sorted(done, key=lambda r: (r.ledger.arrival_s, r.uid))
    lat = summarize_latency(done)
    stream = hashlib.sha256(json.dumps(
        sorted([r.prompt.tolist(), r.output] for r in done),
        sort_keys=True).encode()).hexdigest()
    blob = json.dumps({
        "outputs": [r.output for r in done],
        "stamps": [[r.ledger.arrival_s, r.ledger.admitted_s,
                    r.ledger.first_token_s, r.ledger.finish_s]
                   for r in done],
        "measured_j": fleet.measured_energy_j(),
    }, sort_keys=True)
    st = fleet.stats
    ps = fleet.prefix_stats_total()
    req_prefill_j = sum(r.prefill_j for r in done)
    req_decode_j = sum(r.decode_j for r in done)
    metrics = {
        "completed": len(done),
        "requests": len(trace),
        "total_j": fleet.total_energy_j(),
        "prefill_j": st.prefill_j,
        "decode_j": st.decode_j,
        "req_prefill_j": req_prefill_j,
        "req_decode_j": req_decode_j,
        "decode_fraction": st.decode_j / max(st.prefill_j + st.decode_j, 1e-12),
        "p50_ttft_s": lat.p50_ttft_s,
        "p99_ttft_s": lat.p99_ttft_s,
        "p99_tbt_s": lat.p99_tbt_s,
        "hit_rate": ps.hit_rate,
        "cow_splits": ps.cow_splits,
        "saved_prefill_j": ps.saved_prefill_j,
        "prefix_stats": ps.as_dict(),
        "engine_stats": fleet.last_engine_stats.as_dict(),
    }
    return metrics, (stream, hashlib.sha256(blob.encode()).hexdigest()), wall_s, fleet, done


def _check_conservation(m, violations, tag):
    """Per-request energies must sum to the pool phase totals — the saved
    side-channel lives OUTSIDE both, so sharing can never mint joules."""
    for phase in ("prefill", "decode"):
        tot, per = m[f"{phase}_j"], m[f"req_{phase}_j"]
        if abs(tot - per) > 1e-6 * max(tot, 1.0):
            violations.append(
                f"{tag}: {phase} conservation broken — pool {tot:.9f} J "
                f"!= sum-of-requests {per:.9f} J")


def run(smoke: bool = False, write_json: bool = False, *, full_config: bool = False,
        device="cuda", params_for: Optional[Mapping[str, Any]] = None,
        on_run: Optional[Callable[..., None]] = None):
    """Harness contract: yields (name, us_per_call, derived) rows; raises
    ``RecipeViolation`` on any violated identity/energy/latency assertion
    (any other error propagates as it is). ``params_for`` maps
    the arch to weights of the config the pools run (made from seed 0 when
    missing). ``on_run(tag, metrics, wall_s, fleet, done)`` is called after
    each replay, before any of its checks; ``tag`` is ``(share, config)``
    for the sweep, ``("routing", router)`` and ``("determinism", "cow")``."""
    scale = 2 if smoke else 8
    params_for = dict(params_for or {})
    if ARCH not in params_for:
        params_for[ARCH] = random_params(ARCH, full_config=full_config, device=device)
    kw = dict(full_config=full_config, device=device)

    def replay_hooked(tag, config, trace, **extra):
        m, shas, wall, fleet, done = replay(config, trace, params_for, **kw, **extra)
        if on_run is not None:
            on_run(tag, m, wall, fleet, done)
        return m, shas, wall

    out_rows = []
    violations = []
    sweep = {}

    for share in SHARE_LEVELS:
        trace, n_tree = share_trace(share, scale, full_config=full_config)
        level = {}
        for config in CONFIGS:
            m, (stream, sha), wall = replay_hooked((share, config), config, trace)
            level[config] = {"metrics": m, "stream": stream, "sha": sha}
            if m["completed"] != len(trace):
                violations.append(
                    f"share={share}/{config}: {m['completed']}/{len(trace)} "
                    f"completed")
            out_rows.append((
                f"serve_prefix/share{share:g}/{config}",
                1e6 * wall / max(len(trace), 1),
                f"requests={len(trace)};tree={n_tree};"
                f"total_j={m['total_j']:.3f};"
                f"p99_ttft_ms={1e3 * m['p99_ttft_s']:.3f};"
                f"hit_rate={m['hit_rate']:.3f};"
                f"saved_j={m['saved_prefill_j']:.3f};"
                f"cow_splits={m['cow_splits']}",
            ))
        sweep[share] = level

        # tokens are invariant under the cache organisation, always
        streams = {c: level[c]["stream"] for c in CONFIGS}
        if len(set(streams.values())) != 1:
            violations.append(
                f"share={share}: token streams differ across configs "
                f"({ {c: s[:12] for c, s in streams.items()} })")
        _check_conservation(level["cow"]["metrics"], violations,
                            f"share={share}/cow")

    # ---- share 0.0: sharing must be a strict no-op -----------------------
    m0 = sweep[0.0]["cow"]["metrics"]
    if m0["hit_rate"] != 0.0 or m0["saved_prefill_j"] != 0.0:
        violations.append(
            f"share=0.0: sharing not inert (hit_rate={m0['hit_rate']}, "
            f"saved_j={m0['saved_prefill_j']})")

    # ---- full-tree level: the amortisation claim -------------------------
    top = max(SHARE_LEVELS)
    cow = sweep[top]["cow"]["metrics"]
    paged = sweep[top]["paged"]["metrics"]
    if cow["hit_rate"] < 0.5:
        violations.append(
            f"share={top}: achieved hit rate {cow['hit_rate']:.3f} < 0.5")
    if not cow["total_j"] < paged["total_j"]:
        violations.append(
            f"share={top}: cow total {cow['total_j']:.3f} J not strictly "
            f"below paged {paged['total_j']:.3f} J")
    if not cow["p99_ttft_s"] < paged["p99_ttft_s"]:
        violations.append(
            f"share={top}: cow p99 TTFT {cow['p99_ttft_s']:.6f}s not "
            f"strictly below paged {paged['p99_ttft_s']:.6f}s")
    if not cow["saved_prefill_j"] > 0.0:
        violations.append(f"share={top}: no saved prefill joules attributed")
    if not cow["decode_fraction"] > paged["decode_fraction"]:
        violations.append(
            f"share={top}: energy split did not shift toward decode "
            f"(cow {cow['decode_fraction']:.4f} <= "
            f"paged {paged['decode_fraction']:.4f})")
    if cow["cow_splits"] < 1:
        violations.append(
            f"share={top}: no copy-on-write split exercised "
            f"(cow_splits={cow['cow_splits']})")
    out_rows.append((
        "serve_prefix/amortisation", 0.0,
        f"share={top};hit_rate={cow['hit_rate']:.3f};"
        f"total_j_cow={cow['total_j']:.3f};total_j_paged={paged['total_j']:.3f};"
        f"saved_j={cow['saved_prefill_j']:.3f};"
        f"decode_frac_cow={cow['decode_fraction']:.4f};"
        f"decode_frac_paged={paged['decode_fraction']:.4f};"
        f"p99_ttft_saved_pct="
        f"{100 * (1 - cow['p99_ttft_s'] / paged['p99_ttft_s']):.1f}",
    ))

    # ---- trunk-affinity routing: hits survive a multi-replica fleet ------
    # on >1 replicas JSQ scatters a conversation's turns across replicas
    # (each index sees only fragments of the trunk); the prefix router
    # sends children to the replica holding their trunk, so coverage
    # approaches the single-replica hit rate
    trace, _ = share_trace(top, scale, full_config=full_config)
    route_hr = {}
    for router in ("prefix", "jsq"):
        m, _, _ = replay_hooked(("routing", router), "cow", trace,
                                n=ROUTING_REPLICAS, router=router)
        route_hr[router] = m["hit_rate"]
    if not route_hr["prefix"] > route_hr["jsq"]:
        violations.append(
            f"routing: prefix-affinity hit rate {route_hr['prefix']:.3f} not "
            f"above JSQ's {route_hr['jsq']:.3f} on {ROUTING_REPLICAS} replicas")
    out_rows.append((
        "serve_prefix/routing", 0.0,
        f"replicas={ROUTING_REPLICAS};"
        f"hit_rate_prefix={route_hr['prefix']:.3f};"
        f"hit_rate_jsq={route_hr['jsq']:.3f}",
    ))

    # ---- determinism: the cow replay twice, byte-identical ---------------
    trace, _ = share_trace(top, scale, full_config=full_config)
    m2, (_, sha2), _ = replay_hooked(("determinism", "cow"), "cow", trace)
    identical = sha2 == sweep[top]["cow"]["sha"] and m2 == cow
    if not identical:
        violations.append("cow replay NOT byte-identical across runs")
    out_rows.append((
        "serve_prefix/determinism", 0.0,
        f"byte_identical={identical};sha={sha2[:16]}",
    ))

    results = {
        "sweep": {str(share): {c: level[c]["metrics"] for c in CONFIGS}
                  for share, level in sweep.items()},
        "replay_sha": sweep[top]["cow"]["sha"],
        "prefix_stats": cow["prefix_stats"],
        "routing_hit_rate": route_hr,
    }
    write_csv("serve_prefix", ["share", "config", "metric", "value"],
              [[share, c, k, v]
               for share, level in sweep.items() for c in CONFIGS
               for k, v in level[c]["metrics"].items()
               if not isinstance(v, dict)])
    if write_json:
        write_bench_json(
            "serve_prefix", results, smoke=smoke, path=JSON_PATH,
            trace={"share_levels": list(SHARE_LEVELS), "scale": scale,
                   "seed": SEED, "arch": ARCH, "replicas": N_REPLICAS,
                   "block": BLOCK, "kv_blocks": KV_BLOCKS},
        )
        out_rows.append(("serve_prefix/json", 0.0, f"wrote={JSON_PATH}"))
    if violations:
        raise RecipeViolation(violations)
    return out_rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true", help="scale 2 (scale 8 without)")
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
        print(f"serve_prefix checks VIOLATED: {e}")
        ok = False
    print("serve_prefix checks:", "OK" if ok else "VIOLATED")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
