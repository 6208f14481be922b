"""Training driver: a fault-tolerant loop around the train step.

Counterpart of ``repro.launch.train``: weights -> train state -> loop with
watchdog heartbeats, preemption-safe checkpointing, and a restart from the
latest complete checkpoint. On one card (``device="cuda"``, the default)
it trains full-width configs (``reduced=False``); ``device="cpu"`` runs the
reduced configs on the plain PyTorch path. There is no mesh: the port runs
on one card, so ``use_mesh=True`` raises.

Run: ``python -m repro_torch.launch.train --arch gemma-2b`` (a CUDA card;
``--device cpu`` runs the plain PyTorch path, ``--full-config`` the
published widths).
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.device import resolve_device
from repro_torch.models import init_params
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


def run_training(
    *,
    arch: str,
    steps: int = 50,
    batch_size: int = 8,
    seq_len: int = 128,
    reduced: bool = True,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 20,
    microbatches: int = 1,
    peak_lr: float = 3e-4,
    seed: int = 0,
    log_every: int = 10,
    use_mesh: bool = False,
    compression: bool = False,
    device="cuda",
    params=None,
    schedule=None,
) -> dict:
    """Train ``steps`` steps of ``arch`` and return the reference's summary
    (steps, first / last loss, wall seconds, straggler events) plus every
    step's loss (``losses``), ``step_ms`` (the mean synchronised host-clock time of the
    steps after the first, None with fewer than two) and ``peak_mem_gb``
    (the card's peak allocation; None on the CPU).

    Weights come from ``init_params(cfg, torch.Generator(device)
    .manual_seed(seed))``, or ``params`` (e.g. the reference's, through
    ``params_from_numpy``), trained in place. ``schedule`` replaces the
    default WSD split of ``steps``; ``on_step(i, state, metrics)`` is called
    after each step (after the checkpoint, when one is due)."""
    if use_mesh:
        raise ValueError("use_mesh=True: the port trains on one card; multi-device "
                         "sharding is out of scope (ROADMAP.md queue 1 item 8)")
    device = resolve_device(device)
    cfg = reduced_config(arch) if reduced else get_config(arch)
    opt = AdamW()
    sched = schedule or wsd_schedule(peak_lr, max(steps // 10, 1), int(steps * 0.7),
                                     max(steps // 5, 1))
    step_fn = make_train_step(cfg, opt, sched, microbatches=microbatches, remat=True,
                              compression=compression)
    if params is None:
        params = init_params(cfg, torch.Generator(device).manual_seed(seed), device=device)
    state = init_train_state(cfg, params, opt, compression=compression)

    start = 0
    if checkpoint_dir:
        last = latest_step(checkpoint_dir)
        if last is not None:
            state = restore_checkpoint(checkpoint_dir, last, state)
            start = last
            print(f"[train] resumed from step {last}")

    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    data = PackedLMStream(cfg, DataConfig(seq_len=seq_len, batch_size=batch_size, seed=seed))
    guard = PreemptionGuard(install=False)
    watchdog = StepWatchdog(stall_factor=10.0, min_stall_s=120.0)
    losses, times = [], []
    t0 = time.time()
    for i in range(start, steps):
        batch = {k: torch.from_numpy(v).to(device) for k, v in data.next_batch().items()}
        ts = time.perf_counter()
        state, metrics = step_fn(state, batch)
        if cuda:
            torch.cuda.synchronize(device)
        times.append(time.perf_counter() - ts)
        watchdog.beat()
        losses.append(float(metrics["loss"]))
        if (i + 1) % log_every == 0:
            print(f"[train] step {i+1}/{steps} loss={losses[-1]:.4f} "
                  f"lr={float(metrics['lr']):.2e} gnorm={float(metrics['grad_norm']):.3f}")
        if checkpoint_dir and ((i + 1) % checkpoint_every == 0 or guard.should_stop):
            save_checkpoint(checkpoint_dir, i + 1, state)
        if guard.should_stop:
            print("[train] preempted; checkpointed and exiting cleanly")
            break
    wall = time.time() - t0
    return {
        "steps": len(losses),
        "first_loss": losses[0] if losses else None,
        "last_loss": losses[-1] if losses else None,
        "wall_s": wall,
        "straggler_events": len(watchdog.straggler_events),
        "losses": losses,
        "step_ms": 1e3 * sum(times[1:]) / len(times[1:]) if len(times) > 1 else None,
        "peak_mem_gb": torch.cuda.max_memory_allocated(device) / 1e9 if cuda else None,
    }


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compression", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run_training(
        arch=args.arch,
        steps=args.steps,
        batch_size=args.batch_size,
        seq_len=args.seq_len,
        reduced=not args.full_config,
        checkpoint_dir=args.checkpoint_dir,
        microbatches=args.microbatches,
        compression=args.compression,
        device=args.device,
    )
    print(f"[train] done: {out}")


if __name__ == "__main__":
    main()
