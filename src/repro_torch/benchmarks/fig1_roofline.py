"""Fig 1: roofline placement of decode and prefill across paradigms.

Decode (BS=1 seq=1024) must cluster deep in the memory-bound region —
orders of magnitude below the ridge (H200: ~206 FLOPs/B); prefill GEMMs sit
compute-bound while recurrent prefill stays memory/overhead-bound.

Counterpart of the reference's ``benchmarks/fig1_roofline.py``: the same recipe, CSV
and ``derived`` string, on the port's copies of the analysis core.
"""
from __future__ import annotations

from repro_torch.configs.paper_models import PARADIGM
from repro_torch.core import decode_workload, prefill_workload
from repro_torch.hw import arithmetic_intensity, ridge_point

from repro_torch.benchmarks.common import Row, h200_model, paper_models, timed, write_csv


def run() -> list[Row]:
    model = h200_model()
    cfgs = paper_models()
    ridge = ridge_point(model.spec)

    def build():
        rows = []
        for name, cfg in cfgs.items():
            wd = decode_workload(cfg, 1, 1024)
            wp = prefill_workload(cfg, 1, 4096)
            for phase, w in (("decode", wd), ("prefill", wp)):
                ai = arithmetic_intensity(w.flops_mxu + w.flops_vpu, w.hbm_bytes)
                rows.append([
                    PARADIGM[name], name, phase, round(ai, 3), round(ridge, 1),
                    "compute" if ai >= ridge else "memory",
                ])
        return rows

    rows, us = timed(build)
    write_csv("fig1_roofline", ["paradigm", "arch", "phase", "flops_per_byte", "ridge", "bound"], rows)
    dec_ai = [r[3] for r in rows if r[2] == "decode"]
    derived = (
        f"ridge={ridge:.0f}FLOPs/B;decode_ai_max={max(dec_ai):.1f};"
        f"all_decode_memory_bound={all(r[5]=='memory' for r in rows if r[2]=='decode')}"
    )
    return [("fig1_roofline", us, derived)]
