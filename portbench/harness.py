"""The benchmark of ``repro_torch``: one cell (a model configuration under a
traffic mix) served through ``ServingEngine`` on the card for a fixed
window, its metrics read from the run's record, and its served tokens
judged by the plain reference.

Everything a cell needs is found by name: ``BENCHMARK.json`` lists the
cell's metrics, ``portbench/workloads/<cell>.json`` its engine, traffic,
sample and limit, ``portbench/configs/<config>.json`` its model (the
port's ``ModelConfig`` fields, and the reference module that computes it),
and ``portbench/metrics/<metric>.py`` the reader of each metric.

A run: weights drawn from the seed on the device; the engine built; every
prefill bucket of the mix and the decode step's graph warmed up; a closed
loop's first wave admitted. That is set-up. Then the window, ``--seconds``
long; with ``--trace 1`` a profiled stretch follows it; an open loop then
drains until every request due in the window has finished. Then the peak
memory is read, the engine freed and the reference run over a sample of
the finished requests.
"""
from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
DRAIN_S = 90.0          # an open loop's longest wait for the window's last requests
PROFILE_S = {"closed": 1.5, "open": 3.0}   # the traced stretch after the window


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that no run may hold."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """A cell's files: its workload, its configuration, the reference
    module, and the metrics ``BENCHMARK.json`` lists for it."""

    def __init__(self, root: Path, name: str):
        self.name = name
        self.work = _json(root / "portbench" / "workloads" / f"{name}.json")
        self.cfg_file = _json(root / "portbench" / "configs" / f"{self.work['config']}.json")
        self.cfg = self.cfg_file["port"]
        self.ref = importlib.import_module(f"portbench.reference.{self.cfg_file['reference']}")
        bench_path = root / "BENCHMARK.json"
        bench = _json(bench_path) if bench_path.exists() else {}
        listed = lambda m: name in m.get("workloads", [name])
        self.end_to_end = [m for m in bench.get("end_to_end", []) if listed(m)]
        self.per_layer = [m for m in bench.get("per_layer", []) if listed(m)]

    def model_config(self):
        from repro_torch.models.config import ModelConfig, StageSpec

        fields = dict(self.cfg)
        fields["stages"] = tuple(StageSpec(unit=tuple(s["unit"]), n_units=s["n_units"])
                                 for s in self.cfg["stages"])
        return ModelConfig(**fields)


class Session:
    """The weights and the warmed engine of one seed, serving traffic."""

    def __init__(self, cell: Cell, seed: int, device, trace: bool):
        import torch

        from portbench.weights import make_params
        from repro_torch.serving import ServingEngine

        self.cell = cell
        self.device = torch.device(device)
        self.torch = torch
        self.mc = cell.model_config()
        self.params = make_params(cell.ref.param_spec(cell.cfg), seed, self.device,
                                  getattr(torch, self.mc.param_dtype),
                                  getattr(cell.ref, "OFFSETS", None))
        self.t_weights = time.perf_counter()
        eng = cell.work["engine"]
        self.engine = ServingEngine(
            self.mc, self.params, max_batch=eng["max_batch"], max_seq_len=eng["max_seq_len"],
            paged=eng["paged"], kv_block_size=eng.get("kv_block_size", 16),
            device=self.device)
        self.pool = self.engine.pool
        self.requests: List[Any] = []          # every request submitted
        self.due: Dict[int, float] = {}        # uid -> scheduled arrival (perf_counter)
        self.replays: List[tuple] = []          # (start event, end event, live lengths)
        self.waiting_trace: List[tuple] = []    # (t, queue length) of an open loop
        if trace:
            self._instrument()

    # ------------------------------------------------------------ set-up
    def submit(self, item, due: Optional[float] = None):
        req = self.engine.submit(item.prompt, item.max_new_tokens, eos_token_id=-1)
        self.requests.append(req)
        if due is not None:
            self.due[req.uid] = due
        return req

    def warm_up(self, buckets: List[int]) -> None:
        """One request a prefill bucket, served to its end: every bucket's
        prefill, the placement, the eager first decode step and the graph's
        capture run before the window."""
        rng = np.random.default_rng(0)
        for b in buckets:           # b - 3 tokens pad to b; prompt + 3 fit max_seq_len
            self.engine.submit(rng.integers(1, self.mc.vocab_size, b - 3, dtype=np.int32), 3,
                               eos_token_id=-1)
        self.engine.run_to_completion()
        self.sync()

    def sync(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def _instrument(self) -> None:
        """``record_function`` spans around the harness's calls into each
        layer (the port has none of its own), and CUDA events around each
        graph replay with the rows' live lengths at that step."""
        from torch.profiler import record_function

        def span(name: str, fn: Callable) -> Callable:
            def wrapped(*a, **k):
                with record_function(name):
                    return fn(*a, **k)
            return wrapped

        self.engine.step = span("pb.engine.step", self.engine.step)
        self.engine._admit = span("pb.engine.admit", self.engine._admit)
        self.pool.prefill_request = span("pb.pool.prefill_request", self.pool.prefill_request)
        self.pool.decode_once = span("pb.pool.decode_once", self.pool.decode_once)

    def time_replays(self) -> None:
        """Wrap the pool's captured graph (it exists after ``warm_up``)."""
        torch, pool = self.torch, self.pool
        graph = pool._graph
        if graph is None:
            return
        real = graph.replay
        from torch.profiler import record_function

        def timed():
            lengths = pool._host_lengths[pool.active_mask()].copy()
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            with record_function("pb.graph.replay"):
                ev[0].record()
                real()
                ev[1].record()
            self.replays.append((ev[0], ev[1], lengths))

        graph.replay = timed

    # ------------------------------------------------------------ serving
    def serve(self, traffic, until: float, t_open: float, next_due: int = 0) -> int:
        """Serve ``traffic`` until ``until`` (perf_counter). An open loop
        submits each arrival at its due time (``t_open`` + ``due_s``) and
        returns the index of the next arrival; a closed loop replaces each
        finished request with the client's next one."""
        engine, clock = self.engine, time.perf_counter
        arrivals = getattr(traffic, "arrivals", [])
        while True:
            now = clock()
            if now >= until:
                return next_due
            if traffic.kind == "open":
                while next_due < len(arrivals) and t_open + arrivals[next_due].due_s <= now:
                    self.submit(arrivals[next_due], t_open + arrivals[next_due].due_s)
                    next_due += 1
                self.waiting_trace.append((now, len(engine.waiting)))
                if not engine.waiting and self.pool.occupancy() == 0:
                    nxt = (t_open + arrivals[next_due].due_s if next_due < len(arrivals)
                           else until)
                    time.sleep(max(0.0, min(nxt, until) - clock()))
                    continue
            finished = engine.step()
            if traffic.kind == "closed":
                for _ in finished:
                    item = traffic.next_closed()
                    if item is not None:
                        self.submit(item)

    def drain(self, deadline: float) -> None:
        """Step until every request submitted has finished, or ``deadline``."""
        while (self.engine.waiting or self.pool.occupancy()) and time.perf_counter() < deadline:
            self.engine.step()

    def snapshot(self) -> dict:
        s = self.engine.stats
        return {"prefill_s": s.prefill_s, "prefill_calls": s.prefill_calls,
                "decode_s": s.decode_s, "decode_steps": s.decode_steps}

    def close(self) -> None:
        """Free the engine (its cache and graph); the weights stay."""
        del self.engine, self.pool
        gc.collect()
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()


def _window_record(sess: Session, t_open: float, t_close: float, seconds: float) -> dict:
    """What the readers read of the window [t_open, t_close]."""
    tokens, gaps, ttft, queue, prefills, finished = 0, [], [], [], [], []
    for r in sess.requests:
        led = r.ledger
        stamps = ([led.first_token_s] if led.first_token_s is not None else []) + led.token_s
        tokens += sum(t_open <= t <= t_close for t in stamps)
        gaps += [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:]) if t_open <= b <= t_close]
        if led.admitted_s is not None and t_open <= led.admitted_s <= t_close:
            prefills.append(len(r.prompt))
        due = sess.due.get(r.uid)
        if due is not None and due - t_open < seconds:
            ttft.append(None if led.first_token_s is None else (led.first_token_s - due) * 1e3)
            queue.append(None if led.admitted_s is None else (led.admitted_s - due) * 1e3)
        if r.done and (due is not None and due - t_open < seconds
                       or due is None and t_open <= led.finish_s <= t_close):
            finished.append(r)
    return {"window_s": t_close - t_open, "tokens": tokens, "gaps_ms": gaps,
            "ttft_ms": ttft, "queue_ms": queue, "prefill_lens": prefills,
            "finished": finished}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, t_start: float, *,
             device="cuda", control: bool = False,
             before_window: Optional[Callable] = None) -> dict:
    """One run of ``cell``: the record its readers read (the window's wall
    clock bounds under ``wall_window``, for the power sampler), the device,
    the check. ``control`` also reads the fp8 control's gap;
    ``before_window(sess)`` runs after set-up (a test breaks the timed path
    there)."""
    from portbench import check
    from portbench.traffic import Traffic

    work = cell.work
    t_run = time.perf_counter()
    sess = Session(cell, seed, device, trace)
    t_engine = time.perf_counter()
    torch = sess.torch
    profile_s = PROFILE_S[work["traffic"]["kind"]] if trace else 0.0
    traffic = Traffic(work["traffic"], seed, sess.mc.vocab_size, seconds + profile_s)
    sess.warm_up(traffic.prompt_buckets(work["engine"]["max_seq_len"]))
    t_warm = time.perf_counter()
    for item in traffic.first_wave:
        sess.submit(item)
    if traffic.first_wave:          # admits the whole first wave
        for _ in sess.engine.step():
            item = traffic.next_closed()
            if item is not None:
                sess.submit(item)
    if trace:
        sess.time_replays()
    if before_window is not None:
        before_window(sess)
    sess.sync()

    t_open = time.perf_counter()
    wall_open = time.time()
    phase_open = sess.snapshot()
    nxt = sess.serve(traffic, t_open + seconds, t_open)
    sess.sync()
    t_close = time.perf_counter()
    wall_close = time.time()
    phase_close = sess.snapshot()
    n_replays = len(sess.replays)

    prof_rec = None
    if trace:
        prof_rec, nxt = _profiled(sess, traffic, t_open, nxt, profile_s)
    if traffic.kind == "open":
        # arrivals due in the window that a long step kept the loop from
        # sending: sent now, late, so that their wait counts
        arrivals = traffic.arrivals
        while nxt < len(arrivals) and arrivals[nxt].due_s < seconds:
            sess.submit(arrivals[nxt], t_open + arrivals[nxt].due_s)
            nxt += 1
        sess.drain(time.perf_counter() + DRAIN_S)
    sess.sync()

    rec = _window_record(sess, t_open, t_close, seconds)
    # where set-up went: process start and imports, the weights drawn (with
    # the card's context), the engine built, every bucket and the graph
    # warmed, a closed loop's first wave admitted
    parts = {"start_s": t_run - t_start, "weights_s": sess.t_weights - t_run,
             "engine_s": t_engine - sess.t_weights, "warm_up_s": t_warm - t_engine,
             "first_wave_s": t_open - t_warm}
    rec.update(setup_s=t_open - t_start, setup_parts=parts, phase_open=phase_open,
               phase_close=phase_close,
               cfg=cell.cfg, arch=cell.cfg_file["reference"], profile=prof_rec,
               block_size=work["engine"].get("kv_block_size", 16),
               wall_window=(wall_open, wall_close))
    if trace:
        rec["replays"] = [(a.elapsed_time(b), ln) for a, b, ln in sess.replays[:n_replays]]
    peak = (torch.cuda.max_memory_allocated(sess.device)
            if sess.device.type == "cuda" else 0)
    finished = rec.pop("finished")
    attempted = len(rec["ttft_ms"]) if traffic.kind == "open" else len(finished)
    failed = sum(t is None for t in rec["ttft_ms"]) if traffic.kind == "open" else 0
    picked = check.sample(finished, work["sample"]["requests"], seed)
    sess.close()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gap, compared, gap_c = check.gaps(cell.ref, sess.params, cell.cfg, picked, sess.device,
                                      control=control)
    limit = work["correct"]["max_logit_gap"]
    return {"record": rec, "attempted": attempted, "failed": failed, "peak": peak,
            "check": {"logit_gap": gap, "limit": limit, "tokens_compared": compared,
                      "requests_compared": len(picked), "control_gap": gap_c},
            "correct": bool(compared > 0 and gap <= limit and failed == 0)}


def _profiled(sess: Session, traffic, t_open: float, nxt: int, seconds: float) -> tuple:
    """Serve ``seconds`` more under ``torch.profiler`` (traffic goes on as
    in the window) and read the stretch, with the live lengths of each
    graph replay profiled; returns it (None when the profile caught no
    device operation) and the open loop's next arrival."""
    from torch.profiler import ProfilerActivity, profile

    from portbench.trace import read_profile

    torch = sess.torch
    first = len(sess.replays)
    sess.sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        nxt = sess.serve(traffic, t0 + seconds, t_open, nxt)
        sess.sync()
        wall = time.perf_counter() - t0
    out = read_profile(prof, wall)
    if out is not None:
        out["replay_lengths"] = [ln for _, _, ln in sess.replays[first:]]
    return out, nxt


# ---------------------------------------------------------------- the CLI
def read_metrics(root: Path, specs: List[dict], rec: dict) -> Dict[str, dict]:
    """Each metric's reader, ``portbench/metrics/<name>.py``, over the
    record; a reader that finds nothing to read gives None, and the metric
    is left out."""
    out = {}
    for m in specs:
        path = root / "portbench" / "metrics" / f"{m['name']}.py"
        spec = importlib.util.spec_from_file_location(f"portbench_metric_{m['name']}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        value = mod.read(rec)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def live_cache(rec: dict) -> dict:
    """What the window's decode steps held cached (the live lengths at each
    graph replay, so ``--trace 1`` only): tokens a step, mean and peak, the
    mean context of a live row, and, where the architecture's counts give
    a token's cache bytes, the same in bytes. The pool reserves more than
    this; its peak allocation is ``memory_peak_bytes``."""
    reps = [ln for _, ln in rec.get("replays", []) if len(ln)]
    if not reps:
        return {}
    live = [int(sum(ln)) for ln in reps]
    out = {"live_tokens_mean": sum(live) / len(live), "live_tokens_peak": max(live),
           "live_context_mean": sum(live) / sum(len(ln) for ln in reps)}
    from portbench.counts import step_counts

    per_token = getattr(step_counts(rec["arch"]), "kv_bytes_per_token", None)
    if per_token is not None:
        b = per_token(rec["cfg"])
        out.update(live_kv_bytes_mean=out["live_tokens_mean"] * b,
                   live_kv_bytes_peak=out["live_tokens_peak"] * b)
    return out


def main(argv: List[str], t_start: float, root: Path) -> int:
    ap = argparse.ArgumentParser(description="one benchmark run of one cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    cell = Cell(root, args.workload)
    bench = _json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    chips = entry["chips"] if entry is not None else 1
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from portbench.power import PowerSampler

    sampler = PowerSampler(range(chips)).start()
    try:
        res = run_cell(cell, args.seed, args.seconds, bool(args.trace), t_start)
    finally:
        sampler.stop()
    res["record"]["power"] = sampler.window(*res["record"]["wall_window"])
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    rec = res["record"]
    specs = cell.per_layer if args.trace else cell.end_to_end
    metrics = read_metrics(root, specs, rec)
    missing = [m["name"] for m in specs if m["name"] not in metrics]
    if missing:
        print(f"portbench: no reading of {', '.join(missing)}", file=sys.stderr)
        return 4
    dev = torch.device("cuda", 0)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": chips,
              "memory_peak_bytes": int(res["peak"])}
    out = {"correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"],
           "metrics": metrics, "device": device}
    if args.trace:
        prof = rec["profile"]
        device.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
        out["breakdown"] = {"device_ops": prof["device_ops"], "idle_gaps": prof["idle_gaps"]}
    # what the driver ignores and a reader of the run's line wants: where
    # the window went
    steps = rec["phase_close"]["decode_steps"] - rec["phase_open"]["decode_steps"]
    out["context"] = {
        "prefill_s": rec["phase_close"]["prefill_s"] - rec["phase_open"]["prefill_s"],
        "prefills": rec["phase_close"]["prefill_calls"] - rec["phase_open"]["prefill_calls"],
        "decode_steps": steps,
        "decode_step_ms": (rec["phase_close"]["decode_s"] - rec["phase_open"]["decode_s"])
        / max(steps, 1) * 1e3,
        "window_s": rec["window_s"], "power_w": rec["power"].get("power_w"),
        "sm_mhz": rec["power"].get("sm_mhz")}
    out["context"].update(live_cache(rec), setup_parts=rec["setup_parts"])
    chk = res["check"]
    out["check"] = {"logit_gap": {"value": chk["logit_gap"], "limit": chk["limit"]},
                    "tokens_compared": chk["tokens_compared"], "failed": res["failed"]}
    print(f"check logit_gap {chk['logit_gap']!r} limit {chk['limit']!r}", file=sys.stderr)
    print(f"check tokens_compared {chk['tokens_compared']} limit >= 1", file=sys.stderr)
    print(f"check failed {res['failed']} limit 0", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
