"""The paper's six formalised hypotheses (§3.3: four confirmed, two
qualified), evaluated mechanically against the energy model.

H1  Decode is memory/overhead-bound (never compute-bound at BS=1) across all
    architectures. [confirmed]
H2  Power capping never engages during decode for any tested cap level,
    batch, or context. [confirmed]
H3  Static clock locking Pareto-dominates power capping at every matched
    operating point. [confirmed]
H4  Underclocking to ~40% of max clock saves >=20% decode energy at <1%
    throughput loss for every architecture. [confirmed]
H5  MLA's compressed KV saves decode energy vs GQA-ctrl. [QUALIFIED: only
    beyond a batch-size-dependent context threshold; at BS=1 it never does]
H6  Recurrent/compressed architectures win total request energy vs GQA.
    [QUALIFIED: only after ~1e3 output tokens at production batch; GDN's
    prefill penalty defers its crossover to long context]
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.core.crossover import crossover_output_length, request_energy
from repro_torch.core.dvfs import ClockLock, Default, PowerCap, resolve
from repro_torch.core.energy import EnergyModel
from repro_torch.core.pareto import lock_dominates_caps, sweep_levers
from repro_torch.core.workload import decode_workload
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class HypothesisResult:
    hid: str
    statement: str
    verdict: str          # confirmed | qualified | refuted
    evidence: Dict

    def as_dict(self):
        return dataclasses.asdict(self)


def evaluate_hypotheses(
    model: EnergyModel,
    cfgs: Dict[str, ModelConfig],
    *,
    gqa_ctrl: str,
    mla: str,
    recurrent: str,
) -> List[HypothesisResult]:
    out = []

    # H1: decode never compute-bound at BS=1
    ev = {}
    h1_ok = True
    for name, cfg in cfgs.items():
        prof = resolve(model, decode_workload(cfg, 1, 1024), Default()).profile
        ev[name] = {"dominant": prof.dominant, "t_comp/t_mem": prof.t_comp / max(prof.t_mem, 1e-12)}
        h1_ok &= prof.dominant != "compute"
    out.append(HypothesisResult(
        "H1", "decode is memory/overhead-bound at BS=1 across architectures",
        "confirmed" if h1_ok else "refuted", ev))

    # H2: no cap engages
    ev = {}
    h2_ok = True
    for name, cfg in cfgs.items():
        for bs in (1, 32):
            for ctx in (1024, 16384):
                w = decode_workload(cfg, bs, ctx)
                engaged = [
                    resolve(model, w, PowerCap(c)).engaged
                    for c in model.spec.power_cap_levels
                ]
                key = f"{name}/bs{bs}/ctx{ctx}"
                ev[key] = any(engaged)
                h2_ok &= not any(engaged)
    out.append(HypothesisResult(
        "H2", "power capping never engages during decode",
        "confirmed" if h2_ok else "refuted", ev))

    # H3: lock Pareto-dominates cap
    ev = {}
    h3_ok = True
    for name, cfg in cfgs.items():
        for bs in (1, 32):
            locks, caps = sweep_levers(model, decode_workload(cfg, bs, 1024))
            dom = lock_dominates_caps(locks, caps)
            ev[f"{name}/bs{bs}"] = dom
            h3_ok &= dom
    out.append(HypothesisResult(
        "H3", "clock locking Pareto-dominates power capping",
        "confirmed" if h3_ok else "refuted", ev))

    # H4: >=20% savings at <1% loss via underclock (~40% fmax)
    ev = {}
    h4_ok = True
    f_lock = 0.394 * model.spec.f_max  # the paper's 780/1980 point
    for name, cfg in cfgs.items():
        w = decode_workload(cfg, 1, 1024)
        base = resolve(model, w, Default()).profile
        lock = resolve(model, w, ClockLock(f_lock)).profile
        sav = 1 - lock.energy_per_token_mj / base.energy_per_token_mj
        loss = 1 - lock.throughput / base.throughput
        ev[name] = {"savings": round(sav, 4), "tput_loss": round(loss, 5)}
        h4_ok &= sav >= 0.20 and loss < 0.01
    out.append(HypothesisResult(
        "H4", ">=20% decode energy savings at <1% throughput loss",
        "confirmed" if h4_ok else "refuted", ev))

    # H5: MLA saves decode energy vs GQA-ctrl (qualified)
    ev = {}
    short_worse = True
    crosses_at_32 = False
    never_at_1 = True
    for bs, ctx in ((1, 1024), (32, 1024)):
        g = resolve(model, decode_workload(cfgs[gqa_ctrl], bs, ctx), Default())
        m = resolve(model, decode_workload(cfgs[mla], bs, ctx), Default())
        rel = m.energy_per_token_mj / g.energy_per_token_mj - 1
        ev[f"bs{bs}/ctx{ctx}"] = round(rel, 3)
        short_worse &= rel > 0
    for ctx in (4096, 16384, 65536):
        g = resolve(model, decode_workload(cfgs[gqa_ctrl], 32, ctx), Default())
        m = resolve(model, decode_workload(cfgs[mla], 32, ctx), Default())
        if m.energy_per_token_mj < g.energy_per_token_mj:
            crosses_at_32 = True
            ev["bs32_crossover_ctx<="] = ctx
            break
    for ctx in (1024, 4096, 16384, 65536):
        g = resolve(model, decode_workload(cfgs[gqa_ctrl], 1, ctx), Default())
        m = resolve(model, decode_workload(cfgs[mla], 1, ctx), Default())
        never_at_1 &= m.energy_per_token_mj >= g.energy_per_token_mj
    ev["never_crosses_at_bs1"] = never_at_1
    verdict = "qualified" if (short_worse and crosses_at_32 and never_at_1) else "refuted"
    out.append(HypothesisResult(
        "H5", "MLA saves decode energy vs GQA-ctrl (only beyond a "
              "batch-dependent context threshold)", verdict, ev))

    # H6: recurrent wins total request energy after ~1e3 output tokens @BS32
    cross = crossover_output_length(
        model, cfgs[recurrent], cfgs[gqa_ctrl],
        prompt_len=4096, batch=32, max_output=16384,
    )
    cross_bs1 = crossover_output_length(
        model, cfgs[recurrent], cfgs[gqa_ctrl],
        prompt_len=4096, batch=1, max_output=16384,
    )
    ev = {"crossover_bs32": cross, "crossover_bs1": cross_bs1}
    verdict = "qualified" if (cross is not None and cross > 16) else "refuted"
    out.append(HypothesisResult(
        "H6", "recurrent architectures win total request energy "
              "(only after a prefill-recoup horizon at production batch)",
        verdict, ev))
    return out
