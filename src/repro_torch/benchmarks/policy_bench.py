"""§6.4 deployable policy table: per-arch DVFS class + static clocks, for
both the paper's models (H200) and the 10 assigned archs (TPU v5e).

Counterpart of the reference's ``benchmarks/policy_bench.py``: the same recipe, CSV
and ``derived`` string, on the port's copies of the analysis core.
"""
from __future__ import annotations

from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.configs.paper_models import PARADIGM
from repro_torch.core import policy_table

from repro_torch.benchmarks.common import Row, h200_model, paper_models, timed, v5e_model, write_csv


def run() -> list[Row]:
    rows_all = []

    def build():
        out = []
        h200 = h200_model()
        for r in policy_table(h200, paper_models()):
            out.append(["h200"] + list(r.as_dict().values()))
        v5e = v5e_model()
        assigned = {a: get_config(a) for a in ASSIGNED_ARCHS}
        for r in policy_table(v5e, assigned):
            out.append(["tpu-v5e"] + list(r.as_dict().values()))
        return out

    rows, us = timed(build)
    write_csv(
        "policy_table",
        ["chip", "arch", "dvfs_class", "decode_clock_bs1", "decode_clock_bs32",
         "decode_clock_bs32_long", "prefill_clock", "est_savings_w"],
        rows,
    )
    classes = {}
    for r in rows:
        classes[r[2]] = classes.get(r[2], 0) + 1
    derived = ";".join(f"{k}={v}" for k, v in sorted(classes.items()))
    return [("policy_table", us, derived)]
