"""Fig 2: decode DVFS heatmaps — energy-optimal clock (left), clock-lock
supremacy over the best cap (centre), absolute energy/token vs seq (right).

Counterpart of the reference's ``benchmarks/fig2_heatmaps.py``: the same recipe, CSV
and ``derived`` string, on the port's copies of the analysis core.
"""
from __future__ import annotations

from repro_torch.configs.paper_models import PARADIGM
from repro_torch.core import (
    ClockLock,
    Default,
    PowerCap,
    decode_workload,
    min_energy_clock,
    resolve,
)

from repro_torch.benchmarks.common import Row, h200_model, paper_models, timed, write_csv

BATCHES = (1, 8, 32)
SEQS = (1024, 4096, 16384)


def run() -> list[Row]:
    model = h200_model()
    cfgs = paper_models()

    def build():
        rows = []
        for name, cfg in cfgs.items():
            for b in BATCHES:
                for s in SEQS:
                    w = decode_workload(cfg, b, s)
                    opt = min_energy_clock(model, w)
                    best_cap = min(
                        (resolve(model, w, PowerCap(c)) for c in model.spec.power_cap_levels),
                        key=lambda op: op.energy_per_token_mj,
                    )
                    lock = resolve(model, w, ClockLock(opt.clock_mhz))
                    supremacy = 1 - lock.energy_per_token_mj / best_cap.energy_per_token_mj
                    base = resolve(model, w, Default())
                    rows.append([
                        PARADIGM[name], b, s, opt.clock_mhz,
                        round(supremacy * 100, 2),
                        round(base.energy_per_token_mj, 2),
                        round(lock.energy_per_token_mj, 2),
                    ])
        return rows

    rows, us = timed(build)
    write_csv(
        "fig2_heatmaps",
        ["paradigm", "batch", "seq", "optimal_clock_mhz", "lock_vs_best_cap_pct",
         "e_per_tok_default_mj", "e_per_tok_opt_mj"],
        rows,
    )
    sup = [r[4] for r in rows]
    # the paper's E/tok growth panel: GQA ~2.26x 4K->16K at production batch
    gq = {(r[1], r[2]): r[5] for r in rows if r[0] == "GQA"}
    growth = gq[(8, 16384)] / gq[(8, 4096)]
    derived = f"supremacy_min={min(sup):.1f}%;supremacy_max={max(sup):.1f}%;gqa_growth_4k_16k={growth:.2f}x"
    return [("fig2_heatmaps", us, derived)]
