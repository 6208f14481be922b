#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card (an H100).

    python3 chip_smoke.py

Phases; any failure exits non-zero:
1. device: name, count, ``nvidia-smi`` name and power limit;
2. build the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all started together);
3. hold each kernel (GQA decode attention, MLA latent decode; dense and
   paged) against its plain PyTorch version on the card, at the main paths'
   shapes and others, and time kernel, plain version and
   ``F.scaled_dot_product_attention`` (yardstick only; the port never calls it)
   beside the bound;
4. for each served model -- full-width gemma-2b (GQA) and minitron-4b-mla
   (absorbed MLA), random weights from a seeded generator -- serve through
   ``ServingEngine`` with a lock-mode ``ClockController``, dense then paged,
   counting kernel launches (the model's own kernels once per layer and
   decode step, the other family's never); compare one decode step's logits
   kernel vs plain; then an fp32 engine whose dense and paged greedy streams
   must agree;
5. print throughput, memory, sampled power/clocks, the kernels' JSON line and,
   last, ``{"ok": true, "device": {...}}``.

Imports neither ``jax`` nor ``repro``. Exits 2 without a CUDA card or outside
a checkout of the repository.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12                  # H100 SXM data sheet
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}
TOL = {"float32": dict(atol=5e-5, rtol=5e-5), "bfloat16": dict(atol=2e-2, rtol=2e-2)}
# bf16 model logits, kernel path vs plain path on the same state, per served
# model: kernel and plain version sum in other orders and round their bf16
# outputs differently (the GQA plain version also rounds P to bf16 before
# P.V, the kernel keeps it fp32), and every layer carries the difference on
# to the logits: 18 layers for gemma-2b, 32 for minitron-4b-mla
LOGIT_ATOL_BF16 = {"gemma-2b": 0.25, "minitron-4b-mla": 0.5}
L2_BYTES = 50 * 2**20
MLA_SCALE = 1.0 / math.sqrt(128 + 64)      # minitron-4b-mla: 1/sqrt(nope + rope)
# every kernel whose launches a main path counts
COUNTED = ("decode_attention", "paged_decode_attention",
           "mla_latent_decode", "mla_paged_latent_decode")
SOURCES = {
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attn.cu",
                         "src/repro/kernels/decode_attn/decode_attn.py:162"),
    "paged_decode_attention": ("src/repro_torch/kernels/csrc/decode_attn.cu",
                               "src/repro/kernels/decode_attn/decode_attn.py:107"),
    "mla_latent_decode": ("src/repro_torch/kernels/csrc/mla_decode.cu",
                          "src/repro/kernels/mla_decode/mla_decode.py:164"),
    "mla_paged_latent_decode": ("src/repro_torch/kernels/csrc/mla_decode.cu",
                                "src/repro/kernels/mla_decode/mla_decode.py:110"),
}
# served model -> (dense kernel, paged kernel) of its decode attention
MODELS = {"gemma-2b": ("decode_attention", "paged_decode_attention"),
          "minitron-4b-mla": ("mla_latent_decode", "mla_paged_latent_decode")}


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


class SmiSampler:
    """``nvidia-smi`` power.draw and clocks.sm sampled every 100 ms while
    the block runs (a child process, stopped on exit)."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=power.draw,clocks.sm",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=10)
        rows = []
        for line in out.splitlines():
            try:
                rows.append([float(x) for x in line.split(",")])
            except ValueError:
                continue
        self.samples = rows
        return False

    def summary(self) -> dict:
        if not self.samples:
            return {"samples": 0}
        p = [r[0] for r in self.samples]
        c = [r[1] for r in self.samples]
        return {"samples": len(p), "power_w_mean": sum(p) / len(p), "power_w_max": max(p),
                "clock_sm_mhz_mean": sum(c) / len(c), "clock_sm_mhz_min": min(c)}


def cuda_time_ms(torch, fn, arg_sets, reps: int = 40) -> tuple:
    """(device ms, eager ms) per call of ``fn(*args)``, cycling through
    ``arg_sets`` (copies of the inputs larger than L2 together, so each call
    finds its inputs cold, as a decode step does). Device time replays the
    calls captured in a CUDA graph, so host launch cost is left out; eager
    time is the same loop launched from Python, CUDA events around both."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for args in arg_sets:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    start.record()
    for i in range(reps):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    eager = start.elapsed_time(end) / reps
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (3 * reps), eager


# GQA decode attention: (name, paged, B, H, KV, Dk, Dv, L, bs, main); the
# first of each kind is the gemma-2b decode shape at batch 8 and
# max_seq_len 1024, the one timed
KERNEL_CASES = (
    ("decode_attention", False, 8, 8, 1, 256, 256, 1024, 0, True),
    ("decode_attention", False, 2, 8, 2, 32, 16, 128, 0, False),     # GQA, Dk != Dv
    ("decode_attention", False, 3, 6, 6, 16, 16, 96, 0, False),      # MHA
    ("decode_attention", False, 4, 32, 8, 128, 128, 512, 0, False),  # qwen3-4b heads
    ("decode_attention", False, 2, 16, 1, 64, 64, 300, 0, False),    # G = 16
    ("paged_decode_attention", True, 8, 8, 1, 256, 256, 1024, 16, True),
    ("paged_decode_attention", True, 2, 8, 2, 32, 16, 48, 16, False),
    ("paged_decode_attention", True, 3, 6, 6, 16, 16, 32, 8, False),
)
# MLA latent decode: (name, paged, B, H, rank, rope, L, bs, main); the first
# of each kind is the minitron-4b-mla decode shape at batch 8 and
# max_seq_len 1024, the one timed
MLA_CASES = (
    ("mla_latent_decode", False, 8, 24, 512, 64, 1024, 0, True),
    ("mla_latent_decode", False, 8, 4, 32, 8, 128, 0, False),        # reduced config
    ("mla_latent_decode", False, 8, 16, 512, 64, 512, 0, False),     # deepseek-v2-lite heads
    ("mla_latent_decode", False, 4, 128, 512, 64, 256, 0, False),    # deepseek-v2-236b heads
    ("mla_paged_latent_decode", True, 8, 24, 512, 64, 1024, 16, True),
    ("mla_paged_latent_decode", True, 8, 4, 32, 8, 128, 16, False),
    ("mla_paged_latent_decode", True, 8, 16, 512, 64, 512, 16, False),
    ("mla_paged_latent_decode", True, 4, 128, 512, 64, 256, 16, False),
)


def _valid_lens(torch, g, b, l):
    """Ragged valid_len including 1 and L."""
    valid = torch.randint(1, l + 1, (b,), generator=g, device="cuda")
    valid[0] = 1
    if b > 1:
        valid[1] = l
    return valid.to(torch.int32)


def _tables(torch, g, valid, bs, nb, n_pages):
    """Distinct live pages per request, shuffled; null page 0 past valid_len."""
    perm = torch.randperm(n_pages - 1, generator=g, device="cuda") + 1
    tables = torch.zeros((valid.shape[0], nb), dtype=torch.int32, device="cuda")
    used = 0
    for i, n in enumerate(((valid + bs - 1) // bs).tolist()):
        tables[i, :n] = perm[used:used + n].to(torch.int32)
        used += n
    return tables


def make_inputs(torch, case, dtype, seed):
    """Seeded inputs of one GQA case, in the kernel's argument order."""
    _, paged, b, h, kv, dk, dv, l, bs, _ = case
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    valid = _valid_lens(torch, g, b, l)
    q = torch.randn((b, h, dk), generator=g, device=dev).to(dtype)
    if not paged:
        k = torch.randn((b, l, kv, dk), generator=g, device=dev).to(dtype)
        v = torch.randn((b, l, kv, dv), generator=g, device=dev).to(dtype)
        return (q, k, v, valid)
    nb = l // bs
    n_pages = 1 + b * nb
    kp = torch.randn((n_pages, bs, kv, dk), generator=g, device=dev).to(dtype)
    vp = torch.randn((n_pages, bs, kv, dv), generator=g, device=dev).to(dtype)
    return (q, kp, vp, _tables(torch, g, valid, bs, nb, n_pages), valid)


def make_mla_inputs(torch, case, dtype, seed):
    """Seeded inputs of one MLA case, in the kernel's argument order."""
    _, paged, b, h, rank, rope, l, bs, _ = case
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    valid = _valid_lens(torch, g, b, l)
    q_lat = torch.randn((b, h, rank), generator=g, device=dev).to(dtype)
    q_rope = torch.randn((b, h, rope), generator=g, device=dev).to(dtype)
    rows = (1 + b * (l // bs), bs) if paged else (b, l)
    ckv = torch.randn(rows + (rank,), generator=g, device=dev).to(dtype)
    kr = torch.randn(rows + (rope,), generator=g, device=dev).to(dtype)
    if not paged:
        return (q_lat, q_rope, ckv, kr, valid)
    return (q_lat, q_rope, ckv, kr, _tables(torch, g, valid, bs, l // bs, rows[0]), valid)


def _bound(nbytes, ops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound(torch, case, dtype, inputs, elem):
    """(bound_ms, bound_by) of a GQA case: bytes this call must move (q, the
    K/V rows below valid_len, valid_len, table entries read, output) over
    HBM bandwidth, against its multiply-adds over the peak rate for the
    input type."""
    _, paged, b, h, kv, dk, dv, l, bs, _ = case
    valid = inputs[-1].clamp(max=l).to(torch.int64)
    keys = int(valid.sum())
    nbytes = b * h * dk * elem + keys * kv * (dk + dv) * elem + 4 * b + b * h * dv * elem
    if paged:
        nbytes += 4 * int(((valid + bs - 1) // bs).sum())
    return _bound(nbytes, 2 * keys * (h // kv) * kv * (dk + dv), dtype)


def mla_bound(torch, case, dtype, inputs, elem):
    """(bound_ms, bound_by) of an MLA case: q_lat and q_rope, the ckv and kr
    rows below valid_len, valid_len, table entries read and the output, over
    HBM bandwidth; against 2 * H * (rank + rope + rank) flops per key (scores
    over [ckv; kr], context over ckv) over the peak rate for the input type."""
    _, paged, b, h, rank, rope, l, bs, _ = case
    valid = inputs[-1].clamp(max=l).to(torch.int64)
    keys = int(valid.sum())
    nbytes = (b * h * (rank + rope) * elem + keys * (rank + rope) * elem + 4 * b
              + b * h * rank * elem)
    if paged:
        nbytes += 4 * int(((valid + bs - 1) // bs).sum())
    return _bound(nbytes, 2 * keys * h * (rank + rope + rank), dtype)


def gqa_sdpa(torch, F, l, scale):
    """One ``F.scaled_dot_product_attention`` call computing the dense GQA
    kernel's function (yardstick only)."""
    kpos = torch.arange(l, device="cuda")

    def sdpa(q, k, v, valid):
        mask = (kpos[None, :] < valid[:, None])[:, None, None, :]
        return F.scaled_dot_product_attention(
            q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, scale=scale, enable_gqa=True)

    return sdpa


def mla_sdpa(torch, F, l, scale):
    """One ``F.scaled_dot_product_attention`` call computing the dense MLA
    kernel's function (yardstick only): MQA of ``[q_lat; q_rope]`` over one
    head ``[ckv; kr]`` with V = ``ckv``. Both concatenations are made once
    per input set, OUTSIDE the timed call, which therefore times the
    attention alone."""
    kpos = torch.arange(l, device="cuda")

    def prepare(q_lat, q_rope, ckv, kr, valid):
        return (torch.cat([q_lat, q_rope], -1)[:, :, None],
                torch.cat([ckv, kr], -1)[:, None], ckv[:, None], valid)

    def sdpa(q_cat, k_cat, v, valid):
        mask = (kpos[None, :] < valid[:, None])[:, None, None, :]
        return F.scaled_dot_product_attention(q_cat, k_cat, v, attn_mask=mask, scale=scale,
                                              enable_gqa=True)

    return prepare, sdpa


def check_kernels(torch, F, kmod):
    """Phase 3: every case in fp32 and bf16 against the plain version; time
    the main-path cases. Returns {kernel name: record of its main case}."""
    records = {}
    cases = ([(c, make_inputs, bound) for c in KERNEL_CASES]
             + [(c, make_mla_inputs, mla_bound) for c in MLA_CASES])
    for ci, (case, make, bound_fn) in enumerate(cases):
        name, paged, main, l = case[0], case[1], case[-1], case[-3]
        mla = name.startswith("mla")
        kernel = getattr(kmod, name)
        plain = getattr(kmod, name + "_ref")
        scale = MLA_SCALE if mla else 1.0 / math.sqrt(case[5])
        shape = " ".join(f"{k}={v}" for k, v in zip(
            ("B", "H", "rank", "rope", "L") if mla else ("B", "H", "KV", "Dk", "Dv", "L"),
            case[2:-2]))
        for dname in ("float32", "bfloat16"):
            dtype = getattr(torch, dname)
            inputs = make(torch, case, dtype, seed=100 + ci)
            out = kernel(*inputs, scale=scale)
            want = plain(*inputs, scale=scale)
            torch.cuda.synchronize()
            err = (out.float() - want.float()).abs().max().item()
            ok = torch.allclose(out.float(), want.float(), **TOL[dname])
            print(f"[kernels] {name} {shape}{f' bs={case[-2]}' if paged else ''} {dname}: "
                  f"max_abs_err={err:.3e} tol={TOL[dname]} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"{name} disagrees with its plain version ({dname})")
            if not (main and dname == "bfloat16"):
                continue
            elem = out.element_size()
            big = [t for t in inputs if t.is_floating_point()]
            per_set = sum(t.numel() * t.element_size() for t in big)
            n_sets = max(2, -(-2 * L2_BYTES // per_set))
            sets = [inputs] + [tuple(t.clone() for t in inputs) for _ in range(n_sets - 1)]
            ms, ms_eager = cuda_time_ms(torch, lambda *a: kernel(*a, scale=scale), sets)
            plain_ms, plain_eager = cuda_time_ms(torch, lambda *a: plain(*a, scale=scale), sets)
            library_ms = lib_eager = None
            if not paged and mla:
                prepare, sdpa = mla_sdpa(torch, F, l, scale)
                lib_sets = [prepare(*a) for a in sets]
                library_ms, lib_eager = cuda_time_ms(torch, sdpa, lib_sets)
                del lib_sets
            elif not paged:
                library_ms, lib_eager = cuda_time_ms(torch, gqa_sdpa(torch, F, l, scale), sets)
            bound_ms, bound_by = bound_fn(torch, case, dname, inputs, elem)
            source, replaces = SOURCES[name]
            records[name] = {
                "name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
            }
            print(f"[kernels] {name} main shape bf16, device ms (CUDA graph): kernel {ms:.5f}, "
                  f"plain {plain_ms:.5f}, sdpa {library_ms}, bound {bound_ms:.5f} ({bound_by}); "
                  f"eager ms per call: kernel {ms_eager:.5f}, plain {plain_eager:.5f}, "
                  f"sdpa {lib_eager}; valid_len={inputs[-1].tolist()}")
            del sets
    return records


def serve(torch, cfg, params, prompts, *, paged, max_new, kmod, profile=False):
    """One engine run over ``prompts`` through ``ServingEngine.step``;
    returns (engine, requests, info). Every kernel's launch count is set to
    0 just before the run and read just after it. With ``profile``, five
    full-batch decode steps run under ``torch.profiler`` (and are left out
    of the step times) to split their wall time into device busy and idle."""
    from repro_torch.core.energy import EnergyModel
    from repro_torch.hw.chips import H200_SXM
    from repro_torch.serving import ClockController, ServingEngine

    controller = ClockController(EnergyModel(H200_SXM), cfg, mode="lock")
    engine = ServingEngine(cfg, params, max_batch=8, max_seq_len=1024, controller=controller,
                           paged=paged, kv_block_size=16, device="cuda")
    reqs = [engine.submit(p, max_new_tokens=max_new) for p in prompts]
    step_ms, prof_info = [], None
    n_full = 0
    torch.cuda.synchronize()
    for name in COUNTED:
        getattr(kmod, name).launches = 0
    with SmiSampler() as smi:
        while engine.waiting or engine.pool.occupancy() > 0:
            full = engine.pool.occupancy() == 8 and not engine.waiting
            n_full += full
            if profile and full and n_full == 10:
                prof_info = profile_steps(torch, engine, 5)
                continue
            t0 = time.perf_counter()
            engine.step()
            torch.cuda.synchronize()
            if full:
                step_ms.append((time.perf_counter() - t0) * 1e3)
    info = {
        "launches": {name: getattr(kmod, name).launches for name in COUNTED},
        "decode_steps": engine.stats.decode_steps,
        "step_ms_batch8": step_ms,
        "smi": smi.summary(),
        "profile": prof_info,
    }
    return engine, reqs, info


def profile_steps(torch, engine, n: int) -> dict:
    """``n`` engine steps under torch.profiler: wall ms per step, device busy
    ms per step (sum of kernel self time), the top kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            engine.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    rows = []
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0.0)
        if dev > 0 and getattr(e, "device_type", None) is not None and \
                "CUDA" in str(e.device_type):
            rows.append((dev / 1e3 / n, e.count / n, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    return {"wall_ms_per_step": wall, "device_busy_ms_per_step": busy,
            "device_idle_share": 1.0 - busy / wall if wall else None,
            "kernels_per_step": sum(r[1] for r in rows),
            "top": [{"kernel": k[:90], "ms_per_step": ms, "calls_per_step": c}
                    for ms, c, k in rows[:12]]}


def logits_kernel_vs_plain(torch, cfg, params, prompts, paged):
    """One decode step on the same admitted state, kernel path vs plain path."""
    from repro_torch.models import decode_step, decode_step_paged
    from repro_torch.serving import ServingEngine

    engine = ServingEngine(cfg, params, max_batch=8, max_seq_len=1024, paged=paged,
                           kv_block_size=16, device="cuda")
    for p in prompts:
        engine.submit(p, max_new_tokens=4)
    with torch.inference_mode():
        engine._admit()
        pool = engine.pool
        pre = pool._decode_begin()
        outs = []
        for plain in (False, True):
            cache = {"stages": [{n: {k: t.clone() for k, t in blk.items()}
                                 for n, blk in st.items()} for st in pool.cache["stages"]]}
            if paged:
                lg, _, _ = decode_step_paged(params, cfg, pre["tokens"], cache, pre["lengths"],
                                             pre["active_t"], pre["tables"], plain=plain)
            else:
                lg, _, _ = decode_step(params, cfg, pre["tokens"], cache, pre["lengths"],
                                       plain=plain)
            outs.append(lg.float())
        torch.cuda.synchronize()
    for lg in outs:
        if lg.shape != (len(prompts), cfg.vocab_size) or not bool(torch.isfinite(lg).all()):
            raise SystemExit(f"decode logits: shape {tuple(lg.shape)} or non-finite values")
    err = (outs[0] - outs[1]).abs().max().item()
    agree = (outs[0].argmax(-1) == outs[1].argmax(-1)).float().mean().item()
    return err, agree, outs[1].abs().max().item()


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing run", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC}/repro_torch not found; run from a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch import kernels as kmod
    from repro_torch.configs import get_config
    from repro_torch.kernels import build

    t_start = time.perf_counter()
    # ---- 1. device
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi_line = nvidia_smi("name,power.limit")
    print(f"[device] {kind} count={count} torch={torch.__version__} cuda={torch.version.cuda}")
    print(smi_line)

    # ---- 2. build
    t0 = time.perf_counter()
    info = build.build_all()
    print(f"[build] {time.perf_counter() - t0:.1f} s wall")
    for name, rec in info.items():
        print(f"[build] {name}: {rec['seconds']:.1f} s -> {rec['path']}")
        for line in rec["log"].splitlines():
            if "registers" in line or "spill" in line.lower():
                print(f"[build]   {line.strip()}")

    # ---- 3. kernels vs plain versions
    records = check_kernels(torch, F, kmod)

    # ---- 4. full-width models through ServingEngine
    for arch in MODELS:
        serve_model(torch, kmod, get_config(arch), records)

    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(nvidia_smi("name,power.limit"))
    print(json.dumps({"kernels": [records[name] for name in COUNTED]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


def serve_model(torch, kmod, cfg, records) -> None:
    """Phase 4 for one full-width model: bf16 serving dense then paged (the
    model's own kernel launched once per layer and decode step, the others
    never), bf16 logits kernel vs plain, fp32 dense == paged greedy streams.
    Writes each main-path launch count into ``records``."""
    from repro_torch.models import init_params
    from repro_torch.serving import ServingEngine
    from repro_torch.training import make_prompts

    arch = cfg.name
    n_layers = sum(s.n_units * len(s.unit) for s in cfg.stages)
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[serve] {arch} {cfg.param_dtype}: {n_params / 1e9:.3f} B params, "
          f"{n_layers} layers, init {time.perf_counter() - t0:.1f} s")
    prompts = make_prompts(cfg, 8, 64, 512, seed=0)
    warm = ServingEngine(cfg, params, max_batch=8, max_seq_len=1024, device="cuda")
    warm.submit(prompts[0], max_new_tokens=4)
    warm.run_to_completion()              # cuBLAS and allocator warm-up
    del warm
    torch.cuda.reset_peak_memory_stats()
    for paged in (False, True):
        tag = "paged" if paged else "dense"
        engine, reqs, info = serve(torch, cfg, params, prompts, paged=paged, max_new=32,
                                   kmod=kmod, profile=not paged)
        st = engine.stats
        eos = cfg.eos_token_id
        for r in reqs:
            if not (r.done and (len(r.output) == 32 or r.output[-1] == eos)):
                raise SystemExit(f"{arch} {tag}: request {r.uid} did not finish: {r.output}")
        own = MODELS[arch][paged]
        want = {name: n_layers * info["decode_steps"] if name == own else 0
                for name in COUNTED}
        if info["launches"] != want:
            raise SystemExit(f"{arch} {tag}: launches {info['launches']} != {want} "
                             f"({n_layers} layers x {info['decode_steps']} steps)")
        records[own]["launches"] = info["launches"][own]
        steps = info["step_ms_batch8"]
        run = {
            "requests": len(reqs), "prefill_tokens": st.prefill_tokens,
            "decode_tokens": st.decode_tokens, "decode_steps": st.decode_steps,
            "prefill_tok_s": st.prefill_tokens / st.prefill_s,
            "decode_tok_s": st.decode_tokens / st.decode_s,
            "decode_step_ms_batch8_mean": sum(steps) / len(steps) if steps else None,
            "decode_step_ms_batch8_n": len(steps),
            "modelled_decode_j": st.decode_j, "modelled_prefill_j": st.prefill_j,
            "lock_clock_mhz": st.actual_clock_mhz,
            "smi_during_run": info["smi"],
            "kernel_launches": info["launches"][own],
            "profile": info["profile"],
        }
        if paged:
            run["traffic_bytes"] = engine.pool.traffic.total_bytes
        print(f"[serve] {arch} {tag}: " + json.dumps(run))
        del engine
    print(f"[serve] {arch} max_memory_allocated={torch.cuda.max_memory_allocated()} bytes")

    atol = LOGIT_ATOL_BF16[arch]
    for paged in (False, True):
        err, agree, scale = logits_kernel_vs_plain(torch, cfg, params, prompts, paged)
        tag = "paged" if paged else "dense"
        print(f"[serve] {arch} {tag} bf16 logits kernel vs plain: max_abs_err={err:.4e} "
              f"(max |logit| {scale:.3f}, atol {atol}), argmax agreement {agree:.3f}")
        if not err <= atol:
            raise SystemExit(f"{arch} {tag}: kernel-path logits disagree with the plain path")

    cfg32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    params32 = _map(lambda t: t.float(), params)
    del params
    torch.cuda.empty_cache()
    streams = {}
    for paged in (False, True):
        engine, reqs, info = serve(torch, cfg32, params32, prompts, paged=paged, max_new=8,
                                   kmod=kmod)
        streams[paged] = [r.output for r in reqs]
        print(f"[serve] {arch} fp32 {'paged' if paged else 'dense'}: launches "
              f"{info['launches'][MODELS[arch][paged]]}, first stream {streams[paged][0]}")
        del engine
    if streams[False] != streams[True]:
        raise SystemExit(f"{arch}: fp32 dense and paged greedy streams differ")
    print(f"[serve] {arch} fp32 dense == paged greedy streams: ok")
    del params32
    torch.cuda.empty_cache()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


if __name__ == "__main__":
    sys.exit(main())
