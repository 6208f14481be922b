"""TPU-native characterisation: the paper's questions asked of the 10
assigned architectures on the v5e target — does cap inertness survive the
platform change, what are the DVFS classes, what does clock locking save.

Beyond-paper content: the fused (Pallas) execution is the TPU default, so
the eager-mode artefacts (kernel zoo, launch gaps) largely vanish; the
structural memory-boundedness of decode — the paper's scale-invariant claim
— is what remains, and the table quantifies it per arch.

Counterpart of the reference's ``benchmarks/tpu_native.py``: ``run()`` (the
v5e) gives the same recipe, CSV and ``derived`` string. ``run(chip=
"h100-sxm")`` asks the same questions of the card the port runs on, with the
``H100_SXM`` model (data-sheet ceilings, the power surface assumed from the
H200), and writes ``h100_native.csv``.
"""
from __future__ import annotations

from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.core import (
    ClockLock,
    Default,
    PowerCap,
    best_clock,
    classify_arch,
    decode_workload,
    resolve,
)
from repro_torch.benchmarks.common import Row, h100_model, timed, v5e_model, write_csv

# chip -> (the name of its table and of its row, its energy model)
TABLES = {"tpu-v5e": ("tpu_native", v5e_model), "h100-sxm": ("h100_native", h100_model)}


def run(chip: str = "tpu-v5e") -> list[Row]:
    if chip not in TABLES:
        raise ValueError(f"tpu_native: chip {chip!r} not one of {sorted(TABLES)}")
    table, make_model = TABLES[chip]
    model = make_model()
    spec = model.spec

    def build():
        rows = []
        any_engaged = False
        savings = []
        for arch in ASSIGNED_ARCHS:
            cfg = get_config(arch)
            w = decode_workload(cfg, 32, 4096, fused=True)
            base = resolve(model, w, Default())
            engaged = [resolve(model, w, PowerCap(c)).engaged for c in spec.power_cap_levels]
            any_engaged |= any(engaged)
            choice = best_clock(model, w)
            lock = resolve(model, w, ClockLock(choice.clock_mhz))
            sav = 1 - lock.energy_per_token_mj / base.energy_per_token_mj
            savings.append(sav)
            rows.append([
                arch, classify_arch(model, cfg), round(base.power_w, 1),
                any(engaged), round(choice.clock_mhz),
                round(sav * 100, 1),
                round(base.energy_per_token_mj, 2), round(lock.energy_per_token_mj, 2),
                base.profile.dominant,
            ])
        return rows, any_engaged, savings

    (rows, any_engaged, savings), us = timed(build)
    write_csv(
        table,
        ["arch", "dvfs_class", "decode_power_w", "any_cap_engaged",
         "best_clock_mhz", "lock_savings_pct", "e_tok_default_mj",
         "e_tok_locked_mj", "dominant"],
        rows,
    )
    derived = (
        f"any_cap_engaged={any_engaged};savings_min={min(savings):.1%};"
        f"savings_max={max(savings):.1%}"
    )
    return [(table, us, derived)]
