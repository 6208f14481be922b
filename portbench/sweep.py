"""The knee of an open-loop cell: one engine and one set of weights serve
the cell's traffic at each rate in turn for ``--seconds``, then drain:

    python3 portbench/sweep.py --workload <cell> --seed <n> --seconds <s> --rates <r> ...

One JSON line a rate: requests due in the window and completed, the queue's
growth over the window's second half (requests a second), TTFT p50 / p95
from the scheduled arrival."""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton_cache")
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import numpy as np  # noqa: E402

from portbench import harness  # noqa: E402
from portbench.stats import percentile  # noqa: E402
from portbench.traffic import Traffic  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args()
    cell = harness.Cell(ROOT, args.workload)
    sess = harness.Session(cell, args.seed, "cuda", False)
    mix = cell.work["traffic"]
    sess.warm_up(Traffic(mix, args.seed, sess.mc.vocab_size, 1.0).prompt_buckets(
        cell.work["engine"]["max_seq_len"]))
    for rate in args.rates:
        traffic = Traffic(dict(mix, rate=rate), args.seed, sess.mc.vocab_size, args.seconds)
        sess.requests, sess.due, sess.waiting_trace = [], {}, []
        t_open = time.perf_counter()
        sess.serve(traffic, t_open + args.seconds, t_open)
        t_close = time.perf_counter()
        qt = [(t - t_open, q) for t, q in sess.waiting_trace if t - t_open >= args.seconds / 2]
        growth = float(np.polyfit([t for t, _ in qt], [q for _, q in qt], 1)[0]) \
            if len(qt) > 2 else 0.0
        queue_end = len(sess.engine.waiting)
        sess.drain(time.perf_counter() + harness.DRAIN_S)
        rec = harness._window_record(sess, t_open, t_close, args.seconds)
        print(json.dumps({
            "rate": rate, "due": len(rec["ttft_ms"]),
            "completed_in_window": sum(r.done and r.ledger.finish_s <= t_close
                                       for r in sess.requests),
            "first_token_in_window": sum(r.ledger.first_token_s is not None
                                         and r.ledger.first_token_s <= t_close
                                         for r in sess.requests),
            "queue_at_close": queue_end, "queue_growth_per_s": growth,
            "ttft_p50_ms": percentile(rec["ttft_ms"], 50),
            "ttft_p95_ms": percentile(rec["ttft_ms"], 95),
            "failed": sum(t is None for t in rec["ttft_ms"])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
