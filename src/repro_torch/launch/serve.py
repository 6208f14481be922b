"""Serving driver: continuous batching + phase-aware energy accounting.

Counterpart of ``repro.launch.serve``: the engine serves requests while a
PowerSampler integrates a *modelled* power trace per phase under a chosen
DVFS lever, and the result reports J/token per phase and the clock a
static lock would pick, per the policy table. The energy figures are the
analytic model's for ``chip`` (default the paper's H200 SXM; ``h100-sxm``
is the port's ``H100_SXM``), not readings of the card the model runs on.

Run: ``python -m repro_torch.launch.serve --arch gemma-2b`` (a CUDA card;
``--device cpu`` runs the plain PyTorch path).
"""
from __future__ import annotations

import argparse
from typing import Optional

import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.core.dvfs import ClockLock, Default, resolve
from repro_torch.core.energy import EnergyModel
from repro_torch.core.metering import EnergyMeter
from repro_torch.core.policy import best_clock
from repro_torch.core.workload import decode_workload, prefill_workload
from repro_torch.device import resolve_device
from repro_torch.hw import get_chip
from repro_torch.models import init_params
from repro_torch.serving import ServingEngine
from repro_torch.training import make_prompts


class PhasePowerSource:
    """Callable power source: returns modelled watts for the engine's
    current phase/operating point (feeds the sampler)."""

    def __init__(self, model: EnergyModel, cfg, lever, batch_hint: int = 8, ctx_hint: int = 512):
        self.model = model
        self.cfg = cfg
        self.lever = lever
        self.phase = "idle"
        self.batch = batch_hint
        self.ctx = ctx_hint

    def __call__(self) -> float:
        if self.phase == "prefill":
            w = prefill_workload(self.cfg, 1, max(self.ctx, 16))
        elif self.phase == "decode":
            w = decode_workload(self.cfg, max(self.batch, 1), max(self.ctx, 16))
        else:
            return self.model.spec.p_idle
        return resolve(self.model, w, self.lever).power_w


def run_serving(
    *,
    arch: str,
    n_requests: int = 8,
    max_new: int = 16,
    max_batch: int = 4,
    reduced: bool = True,
    chip: str = "h200-sxm",
    lock_mhz: Optional[float] = None,
    seed: int = 0,
    device="cuda",
) -> dict:
    device = resolve_device(device)
    cfg = reduced_config(arch) if reduced else get_config(arch)
    full_cfg = get_config(arch)  # energy accounting uses the real config
    emodel = EnergyModel(get_chip(chip))
    lever = ClockLock(lock_mhz) if lock_mhz else Default()

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = init_params(cfg, gen, device=device)
    engine = ServingEngine(cfg, params, max_batch=max_batch, max_seq_len=256,
                           device=device)
    prompts = make_prompts(cfg, n_requests, 8, 48, seed=seed)
    for p in prompts:
        engine.submit(p, max_new_tokens=max_new)

    source = PhasePowerSource(emodel, full_cfg, lever)
    with EnergyMeter(source, interval_s=0.01) as meter:
        source.phase = "decode"
        done = engine.run_to_completion()
    stats = engine.stats

    # analytic per-phase energy at the full config's operating point
    dec_op = resolve(emodel, decode_workload(full_cfg, max_batch, 1024), lever)
    pre_op = resolve(emodel, prefill_workload(full_cfg, 1, 1024), lever)
    rec = best_clock(emodel, decode_workload(full_cfg, max_batch, 1024))

    return {
        "completed": len(done),
        "prefill_tokens": stats.prefill_tokens,
        "decode_tokens": stats.decode_tokens,
        "wall_energy_j_modelled": meter.result.energy_j if meter.result else 0.0,
        "decode_power_w": dec_op.power_w,
        "decode_mj_per_tok": dec_op.energy_per_token_mj,
        "prefill_mj_per_tok": pre_op.energy_per_token_mj,
        "recommended_decode_clock_mhz": rec.clock_mhz,
        "lever": f"{lever}",
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--chip", default="h200-sxm")
    ap.add_argument("--lock-mhz", type=float, default=None)
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    out = run_serving(
        arch=args.arch,
        n_requests=args.requests,
        max_new=args.max_new,
        max_batch=args.max_batch,
        reduced=not args.full_config,
        chip=args.chip,
        lock_mhz=args.lock_mhz,
        device=args.device,
    )
    for k, v in out.items():
        print(f"[serve] {k}: {v}")


if __name__ == "__main__":
    main()
