"""§3.3: the six formalised hypotheses — four confirm, two qualify.

Counterpart of the reference's ``benchmarks/hypotheses_bench.py``: the same recipe, CSV
and ``derived`` string, on the port's copies of the analysis core.
"""
from __future__ import annotations

import json

from repro_torch.core import evaluate_hypotheses

from repro_torch.benchmarks.common import Row, h200_model, paper_models, timed, write_csv


def run() -> list[Row]:
    model = h200_model()
    cfgs = paper_models()

    results, us = timed(
        evaluate_hypotheses, model, cfgs,
        gqa_ctrl="minitron-4b", mla="minitron-4b-mla", recurrent="mamba2-4b",
    )
    rows = [[h.hid, h.verdict, h.statement, json.dumps(h.evidence)[:400]] for h in results]
    write_csv("hypotheses", ["id", "verdict", "statement", "evidence"], rows)
    counts = {}
    for h in results:
        counts[h.verdict] = counts.get(h.verdict, 0) + 1
    derived = ";".join(f"{k}={v}" for k, v in sorted(counts.items()))
    return [("hypotheses", us, derived)]
