"""Cluster-level lever comparison: default vs power-cap vs per-pool lock,
served over the PAGED decode pool at production-style batch sizes.

The port's counterpart of the reference's ``benchmarks/serve_cluster.py``:
the same recipe and the same assertions. Two architectures from different
DVFS classes are served through the prefill/decode ``Cluster`` under three
controller modes, and the decode-side efficiency ordering must come out as
the paper measures it on hardware —

    tokens/joule(per-pool lock) >= tokens/joule(power cap)      (both archs)
    cap engaged on decode == False                              (the illusion)
    cap operating point == default operating point              (byte-identical)

Decode energy is derived from the paged pool's measured cache traffic
(``TrafficCounter``), and the observed peak decode occupancy must exceed
the DENSE_SLOTS_AFFORDABLE dense rows the same block budget would hold.

By default the pools run ``reduced_config`` widths; ``--full-config`` runs
``get_config`` widths (bf16, random weights from a seeded
``torch.Generator``), which is for the card. Each row also carries, apart
from the compared fields (``VOLATILE``), the host-clock cost of a
``Replica.step`` split into the decode step, the admissions (prefill and
placement) and the controller's ticks, the decode step's graph replays,
and the decode tokens per host second of the steps after the first
``WARM_STEPS`` (those after the graph's capture: warm-up left out).

Run:  python -m repro_torch.benchmarks.serve_cluster --full-config       # on a card
  or: python -m repro_torch.benchmarks.serve_cluster --device cpu --smoke
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Any, Callable, Dict, Mapping, Optional

from repro_torch.benchmarks.common import (
    VOLATILE_FIELDS,
    h200_model,
    random_params,
    write_bench_json,
    write_csv,
)
from repro_torch.configs import get_config, reduced_config
from repro_torch.device import resolve_device
from repro_torch.serving import ClockController, Cluster
from repro_torch.training import make_prompts

# two DVFS classes: minicpm-2b is attention/full-MHA (batch-invariant-like),
# mamba2-780m is a recurrent SSM stack (compute-light/batch-sensitive side)
ARCHS = ("minicpm-2b", "mamba2-780m")
MODES = ("default", "cap", "lock")

MAX_SEQ_LEN = 128
KV_BLOCK_SIZE = 8
KV_BLOCKS = 80                  # 640 cache tokens of HBM budget
# the same budget as dense (max_seq_len-row) slots: the batch the old pool
# could reach before paging
DENSE_SLOTS_AFFORDABLE = KV_BLOCKS * KV_BLOCK_SIZE // MAX_SEQ_LEN
# fields of a row that vary run to run: left out of the JSON record and of
# any comparison (measured joules integrate a threaded wall-clock sampler)
VOLATILE = VOLATILE_FIELDS | {"measured_prefill_j", "measured_decode_j", "run"}
# decode steps left out of the steady decode rate: the eager first step and
# the second, which captures the pool's CUDA graph
WARM_STEPS = 2


class StepTimer:
    """Host-clock seconds a ``Cluster`` spends in each part of
    ``Replica.step`` while active: the whole step, the decode step
    (``decode_once``, which waits for the device), the admissions
    (``prefill_request`` and ``place``) and the controller's ticks. What a
    step spends outside the decode step is the cost of admission, the
    scheduler and the controller. Also keeps each decode step's seconds
    and tokens (``decode_steps``). Wraps the instance methods; ``__exit__``
    puts them back."""

    PARTS = ("step", "decode", "prefill", "place", "controller")

    def __init__(self, cluster: Cluster):
        self.seconds = dict.fromkeys(self.PARTS, 0.0)
        self.steps = 0
        self.decode_steps = []          # (seconds, tokens) of each step that decoded
        self._decode_stats = cluster.decode_pool.stats
        ctl = cluster.controller
        self._targets = [(cluster._replica, "step", "step"),
                         (cluster.decode_pool, "decode_once", "decode"),
                         (cluster.prefill_pool, "prefill_request", "prefill"),
                         (cluster.decode_pool, "place", "place")]
        if ctl is not None:
            self._targets.append((ctl, "tick", "controller"))

    def _wrap(self, fn, part):
        def timed(*args, **kw):
            tokens = self._decode_stats.decode_tokens
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                dt = time.perf_counter() - t0
                self.seconds[part] += dt
                self.steps += part == "step"
                tokens = self._decode_stats.decode_tokens - tokens
                if part == "decode" and tokens:
                    self.decode_steps.append((dt, tokens))
        return timed

    def __enter__(self):
        for obj, attr, part in self._targets:
            setattr(obj, attr, self._wrap(getattr(obj, attr), part))
        return self

    def __exit__(self, *exc):
        for obj, attr, _ in self._targets:
            delattr(obj, attr)
        return False

    def per_step_ms(self) -> Dict[str, float]:
        n = max(self.steps, 1)
        out = {f"{part}_ms": 1e3 * s / n for part, s in self.seconds.items()}
        out["outside_decode_ms"] = out["step_ms"] - out["decode_ms"]
        return out

    def steady_decode_tok_s(self) -> float:
        """Decode tokens over host seconds of the steps after the first
        ``WARM_STEPS`` (0.0 when there are none)."""
        steady = self.decode_steps[WARM_STEPS:]
        secs = sum(dt for dt, _ in steady)
        return sum(n for _, n in steady) / secs if secs else 0.0


def serve(arch: str, mode: str, *, requests=14, batch=12, max_new=8,
          params: Any = None, full_config: bool = False, device="cuda",
          cuda_graphs: bool = True):
    """One cluster run of the recipe: (row, cluster, requests). ``params``
    are the weights of the config the pools run (made from seed 0 when
    omitted)."""
    emodel = h200_model()
    full = get_config(arch)
    cfg = full if full_config else reduced_config(arch)
    if params is None:
        params = random_params(arch, full_config=full_config, device=device)
    prompts = make_prompts(cfg, requests, 8, 24, seed=11)
    ctl = ClockController(emodel, full, mode=mode)
    cluster = Cluster(
        cfg, params, controller=ctl, decode_batch=batch,
        max_seq_len=MAX_SEQ_LEN, prefill_chunk_tokens=128,
        meter_interval_s=0.01,
        paged=True, kv_block_size=KV_BLOCK_SIZE, kv_blocks=KV_BLOCKS,
        device=device, cuda_graphs=cuda_graphs,
    )
    reqs = [cluster.submit(p, max_new_tokens=max_new) for p in prompts]
    t0 = time.perf_counter()
    with StepTimer(cluster) as timer:
        done = cluster.run_to_completion()
    wall_s = time.perf_counter() - t0
    dec = cluster.decode_stats
    pool = cluster.decode_pool
    measured = cluster.measured_energy_j()
    row = {
        "arch": arch,
        "mode": mode,
        "completed": len(done),
        "decode_tokens": dec.decode_tokens,
        "decode_j": dec.decode_j,
        "decode_tokens_per_j": dec.decode_tokens / dec.decode_j,
        "decode_read_bytes": dec.decode_read_bytes,
        "decode_write_bytes": dec.decode_write_bytes,
        "block_reads": pool.traffic.block_reads,
        "peak_occupancy": pool.peak_occupancy,
        "decode_clock_mhz": dec.actual_clock_mhz,
        "decode_engaged": dec.lever_engaged,
        "prefill_clock_mhz": cluster.prefill_stats.actual_clock_mhz,
        "total_j": cluster.stats.energy_j,
        "measured_prefill_j": measured["prefill"],
        "measured_decode_j": measured["decode"],
        "transitions": len(ctl.transitions),
        "run": {
            "wall_s": wall_s,
            "decode_steps": dec.decode_steps,
            "prefill_calls": cluster.prefill_stats.prefill_calls,
            "steady_decode_steps": max(len(timer.decode_steps) - WARM_STEPS, 0),
            "steady_decode_tok_s": timer.steady_decode_tok_s(),
            "graph_replays": pool.graph_replays,
            "host_ms_per_step": timer.per_step_ms(),
        },
    }
    return row, cluster, reqs


def serve_one(arch: str, mode: str, **kw) -> Dict[str, Any]:
    """One row of the recipe (``serve``'s keywords)."""
    return serve(arch, mode, **kw)[0]


def run(smoke: bool = False, write_json: bool = False, *, full_config: bool = False,
        device="cuda", params_for: Optional[Mapping[str, Any]] = None,
        on_run: Optional[Callable[[dict, Cluster, list], None]] = None):
    """Harness contract: yields (name, us_per_call, derived) rows; raises if
    the paper's ordering is violated. ``smoke`` serves one architecture
    with a smaller request count. ``params_for`` maps arch -> weights of the
    config the pools run (made once per arch from seed 0 when missing).
    ``on_run(row, cluster, requests)`` is called after each run, before
    any of its checks."""
    archs = ARCHS[:1] if smoke else ARCHS
    requests = 10 if smoke else 14
    params_for = dict(params_for or {})
    results = []
    out_rows = []
    violations = []
    for arch in archs:
        if arch not in params_for:
            params_for[arch] = random_params(arch, full_config=full_config, device=device)
        by_mode = {}
        for mode in MODES:
            r, cluster, reqs = serve(arch, mode, requests=requests, params=params_for[arch],
                                     full_config=full_config, device=device)
            if on_run is not None:
                on_run(r, cluster, reqs)
            by_mode[mode] = r
            results.append(r)
            us_per_decode_tok = 1e6 * r["decode_j"] / max(r["decode_tokens"], 1)
            out_rows.append((
                f"serve_cluster/{arch}/{mode}",
                us_per_decode_tok,   # stands in for cost: uJ per decode token
                f"tok_per_j={r['decode_tokens_per_j']:.3f};"
                f"decode_clock={r['decode_clock_mhz']:.0f};"
                f"prefill_clock={r['prefill_clock_mhz']:.0f};"
                f"engaged={r['decode_engaged']};"
                f"peak_occ={r['peak_occupancy']};"
                f"MB_moved={(r['decode_read_bytes'] + r['decode_write_bytes']) / 1e6:.2f};"
                f"steady_decode_tok_s={r['run']['steady_decode_tok_s']:.1f};"
                f"host_ms_outside_decode={r['run']['host_ms_per_step']['outside_decode_ms']:.3f}",
            ))
            if r["completed"] != requests:
                violations.append(f"{arch}/{mode}: {r['completed']}/{requests} completed")
            if r["decode_read_bytes"] <= 0:
                violations.append(f"{arch}/{mode}: traffic meter saw no decode reads")
            # continuous batching over blocks must beat the dense slot count
            # the same HBM budget affords
            if r["peak_occupancy"] <= DENSE_SLOTS_AFFORDABLE:
                violations.append(
                    f"{arch}/{mode}: peak occupancy {r['peak_occupancy']} never "
                    f"exceeded the {DENSE_SLOTS_AFFORDABLE} dense slots the same "
                    f"budget affords"
                )
        violations += ordering_violations(arch, by_mode)
        lock, default = by_mode["lock"], by_mode["default"]
        save_total = 100 * (1 - lock["total_j"] / default["total_j"])
        save_decode = 100 * (1 - default["decode_tokens_per_j"] / lock["decode_tokens_per_j"])
        out_rows.append((
            f"serve_cluster/{arch}/lock_savings",
            0.0,
            f"decode_energy_saved_pct={save_decode:.1f};"
            f"total_energy_saved_pct={save_total:.1f}",
        ))
    keys = [k for k in results[0] if k != "run"]
    write_csv("serve_cluster", keys, [[r[k] for k in keys] for r in results])
    if write_json:
        path = write_bench_json(
            "serve_cluster",
            {f"{r['arch']}/{r['mode']}": r for r in results},
            smoke=smoke, path="BENCH_torch_serve_cluster.json", volatile=VOLATILE,
        )
        out_rows.append(("serve_cluster/json", 0.0, f"wrote={path}"))
    if violations:
        raise RuntimeError("; ".join(violations))
    return out_rows


def ordering_violations(arch: str, by_mode: Mapping[str, Dict[str, Any]]) -> list:
    """The paper's ordering on one arch's default / cap / lock rows."""
    lock, cap, default = by_mode["lock"], by_mode["cap"], by_mode["default"]
    out = []
    if lock["decode_tokens_per_j"] < cap["decode_tokens_per_j"]:
        out.append(f"{arch}: lock tok/J < cap tok/J")
    if cap["decode_engaged"]:
        out.append(f"{arch}: power cap ENGAGED on decode (paper says never)")
    if cap["decode_clock_mhz"] != default["decode_clock_mhz"]:
        out.append(f"{arch}: inert cap drifted from the default clock")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true", help="one arch, 10 requests")
    ap.add_argument("--json", action="store_true",
                    help="write BENCH_torch_serve_cluster.json")
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
        print(f"ordering check VIOLATED: {e}")
        ok = False
    print("ordering check:", "OK" if ok else "VIOLATED")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
