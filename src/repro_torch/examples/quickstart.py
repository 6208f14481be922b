"""Quickstart: the three layers of the framework in one script.

1. Pick an architecture config (--arch, default gemma-2b, reduced).
2. Train it for a handful of steps (WSD schedule, checkpointing).
3. Serve a few requests through the continuous-batching engine.
4. Ask the energy layer the paper's question: what does a power cap do to
   this model's decode, and what clock should the decode pool lock?

Counterpart of ``examples/quickstart.py``; sections 1 and 4 are analytic
and print what the original prints. Sections 2 and 3 run on ``--device``
(default ``cuda``; ``cpu`` runs the kernels' plain versions).

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--arch minicpm-2b] [--device cpu]
"""
import argparse

import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.core import (
    ClockLock,
    Default,
    EnergyModel,
    PowerCap,
    best_clock,
    classify_arch,
    decode_workload,
    resolve,
)
from repro_torch.device import resolve_device
from repro_torch.hw import TPU_V5E
from repro_torch.launch.train import run_training
from repro_torch.models import init_params
from repro_torch.serving import ServingEngine
from repro_torch.training import make_prompts


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    print(f"=== 1. config: {args.arch} (reduced for CPU) ===")
    cfg = reduced_config(args.arch)
    full = get_config(args.arch)
    print(f"full config: {full.param_count()/1e9:.2f}B params, {full.n_blocks} blocks")

    print("\n=== 2. train a few steps ===")
    report = run_training(arch=args.arch, steps=20, batch_size=4, seq_len=64, log_every=5,
                          device=device)
    print(f"loss {report['first_loss']:.3f} -> {report['last_loss']:.3f}")

    print("\n=== 3. serve batched requests ===")
    params = init_params(cfg, torch.Generator(device).manual_seed(0), device=device)
    engine = ServingEngine(cfg, params, max_batch=4, max_seq_len=128, device=device)
    for p in make_prompts(cfg, 6, 8, 24):
        engine.submit(p, max_new_tokens=12)
    done = engine.run_to_completion()
    s = engine.stats
    print(f"completed {len(done)} requests; prefill {s.prefill_tokens} tok "
          f"/ decode {s.decode_tokens} tok")

    print("\n=== 4. the paper's question, for this arch on TPU v5e ===")
    em = EnergyModel(TPU_V5E)
    w = decode_workload(full, 32, 4096, fused=True)
    base = resolve(em, w, Default())
    print(f"decode draws {base.power_w:.0f}W on a {TPU_V5E.tdp:.0f}W chip "
          f"(dominant: {base.profile.dominant})")
    for cap in TPU_V5E.power_cap_levels[:2]:
        op = resolve(em, w, PowerCap(cap))
        print(f"cap {cap:.0f}W -> engaged={op.engaged}, clock {op.actual_clock_mhz:.0f}MHz")
    choice = best_clock(em, w)
    lock = resolve(em, w, ClockLock(choice.clock_mhz))
    print(f"lock {choice.clock_mhz:.0f}MHz -> saves "
          f"{100*(1-lock.energy_per_token_mj/base.energy_per_token_mj):.1f}% energy "
          f"at {100*(1-lock.throughput/base.throughput):.2f}% throughput loss")
    print(f"DVFS class: {classify_arch(em, full)}")
    return {"report": report, "completed": len(done), "stats": s}


if __name__ == "__main__":
    main()
