"""Fig 3: decode DVFS Pareto frontier — lock traces a clean frontier, the
five cap settings collapse to a degenerate blob, lock dominates universally.

Counterpart of the reference's ``benchmarks/fig3_pareto.py``: the same recipe, CSV
and ``derived`` string, on the port's copies of the analysis core.
"""
from __future__ import annotations

from repro_torch.configs.paper_models import PARADIGM
from repro_torch.core import cap_degeneracy, decode_workload, lock_dominates_caps, sweep_levers

from repro_torch.benchmarks.common import Row, h200_model, paper_models, timed, write_csv


def run() -> list[Row]:
    model = h200_model()
    cfgs = paper_models()

    def build():
        rows = []
        verdicts = []
        for name, cfg in cfgs.items():
            for b in (1, 32):
                locks, caps = sweep_levers(model, decode_workload(cfg, b, 1024))
                verdicts.append(lock_dominates_caps(locks, caps))
                for p in locks + caps:
                    rows.append([
                        PARADIGM[name], b, p.lever, p.configured,
                        round(p.clock_mhz), round(p.power_w, 1),
                        round(p.throughput, 2), round(p.tokens_per_joule, 4),
                        p.engaged,
                    ])
                rows.append([
                    PARADIGM[name], b, "cap_degeneracy",
                    round(cap_degeneracy(caps), 6), "", "", "", "", "",
                ])
        return rows, verdicts

    (rows, verdicts), us = timed(build)
    write_csv(
        "fig3_pareto",
        ["paradigm", "batch", "lever", "configured", "clock_mhz", "power_w",
         "tok_per_s", "tok_per_j", "engaged"],
        rows,
    )
    derived = f"lock_dominates_all={all(verdicts)};configs_checked={len(verdicts)}"
    return [("fig3_pareto", us, derived)]
