"""Fig 4: total request energy vs decode output length, BS=1 and BS=32, at
the Pareto-5% clock and the min-energy clock. Reports the crossover points
(§6.3: recurrent models repay their prefill penalty after ~1e3 output
tokens at production batch; MLA is cheapest almost immediately).

Counterpart of the reference's ``benchmarks/fig4_request_energy.py``: the same recipe, CSV
and ``derived`` string, on the port's copies of the analysis core.
"""
from __future__ import annotations

from repro_torch.configs.paper_models import PARADIGM
from repro_torch.core import (
    ClockLock,
    best_clock,
    crossover_output_length,
    decode_workload,
    energy_curve,
)

from repro_torch.benchmarks.common import Row, h200_model, paper_models, timed, write_csv

OUT_LENS = (16, 64, 256, 1024, 4096, 16384)
PROMPT = 4096


def run() -> list[Row]:
    model = h200_model()
    cfgs = paper_models()

    def build():
        rows = []
        for name, cfg in cfgs.items():
            for batch in (1, 32):
                lock = ClockLock(
                    best_clock(model, decode_workload(cfg, batch, PROMPT), budget=0.05).clock_mhz
                )
                for re in energy_curve(
                    model, cfg, prompt_len=PROMPT, output_lens=list(OUT_LENS),
                    batch=batch, lever=lock,
                ):
                    rows.append([
                        PARADIGM[name], batch, re.output_len,
                        round(re.prefill_j, 3), round(re.decode_j, 3),
                        round(re.total_j, 3),
                    ])
        cross_m2 = crossover_output_length(
            model, cfgs["mamba2-4b"], cfgs["qwen3-4b"],
            prompt_len=PROMPT, batch=32, max_output=16384,
        )
        cross_gdn = crossover_output_length(
            model, cfgs["gdn-4b"], cfgs["qwen3-4b"],
            prompt_len=PROMPT, batch=32, max_output=16384,
        )
        cross_mla = crossover_output_length(
            model, cfgs["minitron-4b-mla"], cfgs["minitron-4b"],
            prompt_len=PROMPT, batch=32, max_output=16384,
        )
        return rows, (cross_m2, cross_gdn, cross_mla)

    (rows, (cm2, cgdn, cmla)), us = timed(build)
    write_csv(
        "fig4_request_energy",
        ["paradigm", "batch", "output_len", "prefill_j", "decode_j", "total_j"],
        rows,
    )
    derived = f"mamba2_x_gqa@bs32={cm2};gdn_x_gqa@bs32={cgdn};mla_x_ctrl@bs32={cmla}"
    return [("fig4_request_energy", us, derived)]
