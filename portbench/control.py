"""Readings that set a cell's limit: the program's widest logit gap on many
seeds, and the fp8 control's, each run as a benchmark run of the cell
(trace off) in one process:

    python3 portbench/control.py --workload <cell> --seconds <s> --seeds <n> ... \
        [--control-seeds <n> ...]

One JSON line a seed. The benchmark's own runs never run the control."""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton_cache")
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import harness  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args()
    import torch

    cell = harness.Cell(ROOT, args.workload)
    # a cell not yet in BENCHMARK.json reads the readers that find something
    specs = cell.end_to_end or [{"name": n, "unit": ""} for n in
                                ("decode_tok_s", "tbt_p95_ms", "ttft_p95_ms", "setup_s")]
    for seed in args.seeds:
        t0 = time.perf_counter()
        res = harness.run_cell(cell, seed, args.seconds, False, t0,
                               control=seed in args.control_seeds)
        metrics = harness.read_metrics(ROOT, specs, res["record"])
        print(json.dumps({"seed": seed, "correct": res["correct"], **res["check"],
                          "attempted": res["attempted"], "failed": res["failed"],
                          "check_s": time.perf_counter() - t0 - res["record"]["setup_s"]
                          - res["record"]["window_s"],
                          "metrics": {k: v["value"] for k, v in metrics.items()}}), flush=True)
        del res
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
