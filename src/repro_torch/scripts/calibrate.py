"""Calibration check: H200 spec + paper models vs the paper's published
numbers. Prints the comparison table; used to tune the power coefficients
that are frozen into hw/chips.py (acceptance bands enforced by
tests/test_paper_fidelity.py).

Counterpart of ``scripts/calibrate.py``, on the port's copy of the analysis
core: analytic, its output equals the original's byte for byte.

Run:  PYTHONPATH=src python -m repro_torch.scripts.calibrate
"""
from repro_torch.configs.paper_models import PAPER_MODELS, PARADIGM
from repro_torch.core.dvfs import ClockLock, Default, PowerCap, resolve
from repro_torch.core.energy import EnergyModel
from repro_torch.core.workload import decode_workload, prefill_workload
from repro_torch.hw import H200_SXM


def main():
    model = EnergyModel(H200_SXM)

    print("=== Table-1 analogue: decode BS=1 seq=1024, default governor (1830) ===")
    print(f"paper targets: GQA 207 W, GDN 167 W, MLA 231 W, range 137-300 W")
    for name, ctor in PAPER_MODELS.items():
        cfg = ctor()
        w = decode_workload(cfg, 1, 1024)
        op = resolve(model, w, Default())
        p = op.profile
        print(
            f"{PARADIGM[name]:9s} {name:16s} P={p.power_w:6.1f}W "
            f"T={p.t_total*1e3:6.2f}ms tok/s={p.throughput:7.1f} "
            f"tmem={p.t_mem*1e3:5.2f} tcomp={p.t_comp*1e3:5.2f} tover={p.t_overhead*1e3:5.2f}"
        )

    print("\n=== caps never trigger (280..700W) ===")
    for name, ctor in PAPER_MODELS.items():
        cfg = ctor()
        for bs in (1, 32):
            w = decode_workload(cfg, bs, 16384)
            engaged = [resolve(model, w, PowerCap(c)).engaged
                       for c in H200_SXM.power_cap_levels]
            pw = resolve(model, w, Default()).power_w
            print(f"{PARADIGM[name]:9s} BS={bs:2d} P={pw:6.1f}W engaged={engaged}")

    print("\n=== clock 780 lock vs default: savings % and throughput loss % (BS=1 seq=1024) ===")
    print("paper: saves 24-32% energy, <1% tput loss; GDN 30%/49W")
    for name, ctor in PAPER_MODELS.items():
        cfg = ctor()
        w = decode_workload(cfg, 1, 1024)
        base = resolve(model, w, Default()).profile
        lock = resolve(model, w, ClockLock(780.0)).profile
        de = 100 * (1 - lock.energy_per_token_mj / base.energy_per_token_mj)
        dt = 100 * (1 - lock.throughput / base.throughput)
        dw = base.power_w - lock.power_w
        print(f"{PARADIGM[name]:9s} saves {de:5.1f}% energy ({dw:5.1f}W), tput loss {dt:5.2f}%")

    print("\n=== 1590 vs 1830: zero tput gain at +7-13% power ===")
    for name, ctor in PAPER_MODELS.items():
        cfg = ctor()
        w = decode_workload(cfg, 1, 1024)
        lo = resolve(model, w, ClockLock(1590.0)).profile
        hi = resolve(model, w, ClockLock(1980.0)).profile  # clamped to 1830
        dtput = 100 * (hi.throughput / lo.throughput - 1)
        dpow = 100 * (hi.power_w / lo.power_w - 1)
        print(f"{PARADIGM[name]:9s} clamped@{hi.clock_mhz:.0f}: tput +{dtput:4.2f}%  "
              f"power +{dpow:4.1f}%")

    print("\n=== energy/token growth 4K->16K (paper: GQA 2.26x=107->242, MLA 1.42x, "
          "Mamba2 1.16x=86->100) ===")
    for bs in (4, 8, 32):
        row = []
        for name in ("qwen3-4b", "minitron-4b-mla", "mamba2-4b"):
            cfg = PAPER_MODELS[name]()
            e4 = resolve(model, decode_workload(cfg, bs, 4096), Default()).energy_per_token_mj
            e16 = resolve(model, decode_workload(cfg, bs, 16384), Default()).energy_per_token_mj
            row.append(f"{PARADIGM[name]}: {e4:6.1f}->{e16:6.1f} ({e16/e4:4.2f}x)")
        print(f"BS={bs:2d}  " + "  ".join(row))

    print("\n=== MLA vs GQA-ctrl decode energy: crossover (paper: BS32@4K crosses; BS1 never; "
          "12-29% worse short) ===")
    for bs in (1, 32):
        for ctx in (1024, 4096, 16384, 65536):
            g = resolve(model, decode_workload(PAPER_MODELS["minitron-4b"](), bs, ctx),
                        Default())
            m = resolve(model, decode_workload(PAPER_MODELS["minitron-4b-mla"](), bs, ctx),
                        Default())
            rel = 100 * (m.energy_per_token_mj / g.energy_per_token_mj - 1)
            print(f"BS={bs:2d} ctx={ctx:6d}: MLA vs GQA-ctrl {rel:+6.1f}%")

    print("\n=== prefill penalty (paper: GDN/Mamba2 ~10x transformers mJ/tok; MLA 1.6x attn "
          "slowdown) ===")
    for name, ctor in PAPER_MODELS.items():
        cfg = ctor()
        w = prefill_workload(cfg, 1, 4096)
        op = resolve(model, w, Default()).profile
        print(f"{PARADIGM[name]:9s} prefill E/tok={op.energy_per_token_mj:7.2f} mJ "
              f"T={op.t_total*1e3:7.1f}ms P={op.power_w:6.1f}W")


if __name__ == "__main__":
    main()
