"""Benchmark runner of the port — one function per paper table/figure, and
the serving recipes.

Counterpart of the reference's ``benchmarks/run.py``: prints
``name,us_per_call,derived`` CSV rows (the harness contract) and writes
per-table artefacts to ``$REPRO_BENCH_OUT`` (default results/benchmarks).
``--device`` reaches the drivers that run a model or a kernel (the serving
recipes and ``kernels_micro``); ``--smoke`` runs the serving recipes' smoke
tier. ``tpu_native`` runs twice: the v5e table and its H100 counterpart;
``serve_scale`` twice, as in the reference: batched and the tuple baseline.

    python -m repro_torch.benchmarks.run [--device cpu] [--smoke]
"""
from __future__ import annotations

import argparse
import sys
import traceback

from repro_torch.device import resolve_device


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true", help="the serving recipes' smoke tier")
    args = ap.parse_args(argv)
    resolve_device(args.device)      # no card: fail here, not in every driver

    from repro_torch.benchmarks import (
        fig1_roofline,
        fig2_heatmaps,
        fig3_pareto,
        fig4_request_energy,
        hypotheses_bench,
        kernels_micro,
        policy_bench,
        roofline_report,
        serve_autoscale,
        serve_cluster,
        serve_events,
        serve_fleet,
        serve_prefix,
        serve_scale,
        serve_trace,
        table1_power_cap,
        tpu_native,
    )

    serving = {"smoke": args.smoke, "device": args.device}
    # (module, kwargs, tag): kwargs reach mod.run()
    benches = [
        (table1_power_cap, {}, ""),
        (fig1_roofline, {}, ""),
        (fig2_heatmaps, {}, ""),
        (fig3_pareto, {}, ""),
        (fig4_request_energy, {}, ""),
        (hypotheses_bench, {}, ""),
        (policy_bench, {}, ""),
        (serve_cluster, serving, ""),
        (serve_trace, serving, ""),
        (serve_fleet, serving, ""),
        (serve_autoscale, serving, ""),
        (serve_events, serving, ""),
        (serve_prefix, serving, ""),
        (serve_scale, {**serving, "batched": True}, "batched"),
        (serve_scale, {**serving, "batched": False}, "unbatched"),
        (tpu_native, {}, ""),
        (tpu_native, {"chip": "h100-sxm"}, "h100"),
        (kernels_micro, {"device": args.device}, ""),
        (roofline_report, {}, ""),
    ]
    print("name,us_per_call,derived")
    failed = 0
    for mod, kwargs, tag in benches:
        label = f"{mod.__name__}[{tag}]" if tag else mod.__name__
        try:
            for name, us, derived in mod.run(**kwargs):
                print(f"{name},{us:.1f},{derived}")
        except Exception as e:  # noqa: BLE001 — report each driver's failure, run the rest
            failed += 1
            print(f"{label},-1,ERROR:{type(e).__name__}:{e}")
            traceback.print_exc(file=sys.stderr)
    if failed:
        raise SystemExit(f"{failed} benchmarks failed")


if __name__ == "__main__":
    main()
