"""Train a MiniCPM-style model with the WSD schedule, fault tolerance, and
checkpoint/restart — the training-side example.

Default: ~25M-param model, 60 steps. --hundred-m trains a ~100M-param
config for --steps steps.

Counterpart of ``examples/train_wsd.py``: the same configs, schedule,
watchdog, preemption guard and checkpoints, on ``--device`` (default
``cuda``); the train step updates the state in place where the original
jits and donates it.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_wsd [--hundred-m --steps 300] [--device cpu]
"""
import argparse
import dataclasses
import os
import tempfile

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import ModelConfig, StageSpec, init_params
from repro_torch.training import (
    AdamW,
    DataConfig,
    PackedLMStream,
    PreemptionGuard,
    StepWatchdog,
    init_train_state,
    latest_step,
    make_train_step,
    restore_checkpoint,
    save_checkpoint,
    wsd_schedule,
)


def small_minicpm(hundred_m: bool) -> ModelConfig:
    base = get_config("minicpm-2b")
    if hundred_m:
        return dataclasses.replace(
            base, name="minicpm-100m", d_model=512,
            stages=(StageSpec(unit=("attn",), n_units=8),),
            n_heads=8, n_kv_heads=8, head_dim=64, d_ff=1536,
            vocab_size=32768, param_dtype="float32", compute_dtype="float32",
        )
    return dataclasses.replace(
        base, name="minicpm-25m", d_model=256,
        stages=(StageSpec(unit=("attn",), n_units=4),),
        n_heads=4, n_kv_heads=4, head_dim=64, d_ff=768,
        vocab_size=16384, param_dtype="float32", compute_dtype="float32",
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--hundred-m", action="store_true")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = small_minicpm(args.hundred_m)
    print(f"model: {cfg.name} ({cfg.param_count()/1e6:.1f}M params), WSD schedule")

    opt = AdamW()
    sched = wsd_schedule(
        6e-4, warmup_steps=max(args.steps // 10, 1),
        stable_steps=int(args.steps * 0.7), decay_steps=max(args.steps // 5, 1),
    )
    step = make_train_step(cfg, opt, sched, remat=True)

    ckpt_dir = args.ckpt_dir or os.path.join(tempfile.gettempdir(), f"wsd_torch_{cfg.name}")
    params = init_params(cfg, torch.Generator(device).manual_seed(0), device=device)
    state = init_train_state(cfg, params, opt)
    start = 0
    last = latest_step(ckpt_dir)
    if last:
        state = restore_checkpoint(ckpt_dir, last, state)
        start = last
        print(f"resumed from checkpoint step {last}")

    data = PackedLMStream(cfg, DataConfig(seq_len=args.seq_len, batch_size=args.batch_size))
    guard = PreemptionGuard(install=True)
    wd = StepWatchdog(stall_factor=10.0, min_stall_s=300.0)
    wd.start()
    losses = []
    try:
        for i in range(start, args.steps):
            batch = {k: torch.from_numpy(v).to(device) for k, v in data.next_batch().items()}
            state, m = step(state, batch)
            wd.beat()
            losses.append(float(m["loss"]))
            if (i + 1) % 10 == 0:
                print(f"step {i+1:4d} loss {losses[-1]:.4f} lr {float(m['lr']):.2e}")
            if (i + 1) % 25 == 0 or guard.should_stop:
                save_checkpoint(ckpt_dir, i + 1, state)
            if guard.should_stop:
                print("preempted: final checkpoint written, exiting cleanly")
                return {"losses": losses, "ckpt_dir": ckpt_dir, "preempted": True}
    finally:
        wd.stop()
        guard.restore()
    save_checkpoint(ckpt_dir, args.steps, state)
    print(f"done; checkpoints in {ckpt_dir}")
    return {"losses": losses, "ckpt_dir": ckpt_dir, "preempted": False}


if __name__ == "__main__":
    main()
