"""Table 1: power cap vs actual GPU behaviour during decode (BS=1, seq=1024).

Reproduces the paper's configured-vs-actual gap: under every cap from 280 W
to 700 W, the actual clock stays at the governor default and the power draw
is cap-independent — the cap never triggers.

Counterpart of the reference's ``benchmarks/table1_power_cap.py``: the same recipe, CSV
and ``derived`` string, on the port's copies of the analysis core.
"""
from __future__ import annotations

from repro_torch.configs.paper_models import PARADIGM
from repro_torch.core import Default, PowerCap, decode_workload, resolve

from repro_torch.benchmarks.common import Row, h200_model, paper_models, timed, write_csv


def run() -> list[Row]:
    model = h200_model()
    cfgs = paper_models()

    def build():
        rows = []
        for cap in model.spec.power_cap_levels:
            row = {"cap_w": cap}
            for name in ("qwen3-4b", "gdn-4b", "minitron-4b-mla"):
                op = resolve(model, decode_workload(cfgs[name], 1, 1024), PowerCap(cap))
                row[f"{PARADIGM[name]}_clock"] = round(op.actual_clock_mhz)
                row[f"{PARADIGM[name]}_power_w"] = round(op.power_w, 1)
                row[f"{PARADIGM[name]}_engaged"] = op.engaged
            rows.append(row)
        return rows

    rows, us = timed(build)
    header = list(rows[0])
    write_csv("table1_power_cap", header, [[r[k] for k in header] for r in rows])

    clocks = {r[k] for r in rows for k in r if k.endswith("_clock")}
    engaged = any(r[k] for r in rows for k in r if k.endswith("_engaged"))
    derived = (
        f"actual_clock_always={clocks.pop() if len(clocks) == 1 else sorted(clocks)}MHz;"
        f"any_cap_engaged={engaged};cap_range=2.5x"
    )
    return [("table1_power_cap", us, derived)]
