"""Reproduce the paper's headline characterisation in one command.

Prints: Table-1 analogue, the DVFS class table, the lock-vs-cap verdict,
the six hypotheses, and the MLA/recurrent crossovers — all from the
H200-calibrated energy model (see tests/test_paper_fidelity.py for the
acceptance bands backing every number).

Counterpart of ``examples/characterize_paper.py``, on the port's copy of
the analysis core: analytic, its output equals the original's byte for
byte, and nothing runs on a device.

Run:  PYTHONPATH=src python -m repro_torch.examples.characterize_paper
"""
from repro_torch.configs.paper_models import PAPER_MODELS, PARADIGM
from repro_torch.core import (
    ClockLock,
    Default,
    EnergyModel,
    PowerCap,
    classify_arch,
    crossover_output_length,
    decode_workload,
    evaluate_hypotheses,
    lock_dominates_caps,
    resolve,
    sweep_levers,
)
from repro_torch.hw import H200_SXM


def main():
    model = EnergyModel(H200_SXM)
    cfgs = {k: v() for k, v in PAPER_MODELS.items()}

    print("== decode power vs caps (BS=1, seq=1024) ==")
    for name, cfg in cfgs.items():
        w = decode_workload(cfg, 1, 1024)
        base = resolve(model, w, Default())
        engaged = any(resolve(model, w, PowerCap(c)).engaged for c in H200_SXM.power_cap_levels)
        lock = resolve(model, w, ClockLock(780.0))
        print(f"{PARADIGM[name]:9s} {base.power_w:6.1f}W @ {base.actual_clock_mhz:.0f}MHz | "
              f"caps engage: {engaged} | lock@780: -{base.power_w - lock.power_w:5.1f}W "
              f"({100*(1-lock.energy_per_token_mj/base.energy_per_token_mj):.0f}% energy, "
              f"{100*(1-lock.throughput/base.throughput):.2f}% tput loss) | "
              f"class: {classify_arch(model, cfg)}")

    print("\n== lock vs cap Pareto ==")
    ok = all(
        lock_dominates_caps(*sweep_levers(model, decode_workload(cfg, b, 1024)))
        for cfg in cfgs.values() for b in (1, 32)
    )
    print(f"clock locking Pareto-dominates power capping in all tested configs: {ok}")

    print("\n== hypotheses ==")
    for h in evaluate_hypotheses(model, cfgs, gqa_ctrl="minitron-4b",
                                 mla="minitron-4b-mla", recurrent="mamba2-4b"):
        print(f"{h.hid} [{h.verdict:9s}] {h.statement}")

    print("\n== crossovers (prompt 4096, BS=32) ==")
    for chal, base_, label in (
        ("mamba2-4b", "qwen3-4b", "Mamba2 vs GQA"),
        ("gdn-4b", "qwen3-4b", "GDN vs GQA"),
        ("minitron-4b-mla", "minitron-4b", "MLA vs GQA-ctrl"),
    ):
        c = crossover_output_length(model, cfgs[chal], cfgs[base_],
                                    prompt_len=4096, batch=32, max_output=16384)
        print(f"{label}: total request energy crosses at ~{c} output tokens")


if __name__ == "__main__":
    main()
