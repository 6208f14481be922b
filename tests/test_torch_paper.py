"""The port's analysis core and paper benchmarks against the reference's.

``repro_torch.core`` and ``repro_torch.hw`` export the reference's names;
the roofline functions agree on both chips of ``hw.chips``; every table and
figure driver (and ``tpu_native`` on the v5e) writes a CSV byte-equal to the
reference's, with the same ``derived`` string; ``roofline_report`` reads
dry-run artefacts as the reference does; ``kernels_micro``'s plain versions
agree with the reference's oracles on the same numpy inputs, with the same
modelled figures; ``H100_SXM`` engages no cap at BS 1 and keeps decode
memory-bound; ``launch/serve.py --chip h100-sxm`` resolves; the runner
reaches every driver. No test writes under the repo's ``results/``.
"""
import dataclasses
import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

import repro.core as jcore
import repro.hw as jhw
import repro.kernels as jkernels
import repro_torch.core as tcore
import repro_torch.hw as thw
from repro_torch.benchmarks import common as tcommon
from repro_torch.benchmarks import (
    fig1_roofline,
    fig2_heatmaps,
    fig3_pareto,
    fig4_request_energy,
    hypotheses_bench,
    kernels_micro,
    policy_bench,
    roofline_report,
    run as trun,
    table1_power_cap,
    tpu_native,
)
from repro_torch.configs.paper_models import PAPER_MODELS
from repro_torch.hw.h100 import H100_SXM

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
import benchmarks.common as jcommon  # noqa: E402
import benchmarks.kernels_micro as j_kernels_micro  # noqa: E402
import benchmarks.roofline_report as j_roofline_report  # noqa: E402

# reference driver module -> (the port's driver, the CSV both write, run() kwargs)
DRIVERS = {
    "table1_power_cap": (table1_power_cap, "table1_power_cap", {}),
    "fig1_roofline": (fig1_roofline, "fig1_roofline", {}),
    "fig2_heatmaps": (fig2_heatmaps, "fig2_heatmaps", {}),
    "fig3_pareto": (fig3_pareto, "fig3_pareto", {}),
    "fig4_request_energy": (fig4_request_energy, "fig4_request_energy", {}),
    "hypotheses_bench": (hypotheses_bench, "hypotheses", {}),
    "policy_bench": (policy_bench, "policy_table", {}),
    "tpu_native": (tpu_native, "tpu_native", {}),
}


@pytest.fixture
def outdirs(tmp_path, monkeypatch):
    """(reference, port) output dirs: the reference's module-level
    RESULTS_DIR patched, the port's REPRO_BENCH_OUT set."""
    ref, port = tmp_path / "ref", tmp_path / "port"
    monkeypatch.setattr(jcommon, "RESULTS_DIR", str(ref))
    monkeypatch.setenv("REPRO_BENCH_OUT", str(port))
    return ref, port


def _repo_csv_state(name):
    path = ROOT / "results" / "benchmarks" / f"{name}.csv"
    return path.stat().st_mtime_ns if path.exists() else None


def test_core_exports_the_reference_names():
    assert tcore.__all__ == jcore.__all__
    for name in tcore.__all__:
        assert type(getattr(tcore, name)).__name__ == type(getattr(jcore, name)).__name__, name


def test_hw_exports_the_reference_names_and_h100():
    assert [n for n in thw.__all__ if n != "H100_SXM"] == jhw.__all__
    assert thw.H100_SXM is H100_SXM
    for name in ("TPU_V5E", "H200_SXM"):
        assert dataclasses.asdict(getattr(thw, name)) == dataclasses.asdict(getattr(jhw, name))
        assert thw.get_chip(getattr(jhw, name).name) is getattr(thw, name)
    assert thw.get_chip("h100-sxm") is H100_SXM
    with pytest.raises(KeyError, match="h100-sxm"):
        thw.get_chip("no-such-chip")


FLOPS_BYTES = [(0.0, 1.0), (1e6, 0.0), (2e9, 1e9), (1.3e9, 1e9), (5e12, 1e10),
               (1e15, 4e12), (3.7e11, 2.2e9)]


@pytest.mark.parametrize("chip", ["TPU_V5E", "H200_SXM"])
def test_roofline_names_agree(chip):
    js, ts = getattr(jhw, chip), getattr(thw, chip)
    assert thw.ridge_point(ts) == jhw.ridge_point(js)
    for flops, nbytes in FLOPS_BYTES:
        assert thw.arithmetic_intensity(flops, nbytes) == jhw.arithmetic_intensity(flops, nbytes)
        assert thw.bound_class(ts, flops, nbytes) == jhw.bound_class(js, flops, nbytes)
        for kw in ({}, {"collective_bytes": nbytes / 7, "chips": 4},
                   {"clock_mhz": ts.clock_levels[0]}):
            jt = jhw.roofline_terms(js, flops=flops, hbm_bytes=nbytes, **kw)
            tt = thw.roofline_terms(ts, flops=flops, hbm_bytes=nbytes, **kw)
            assert dataclasses.asdict(tt) == dataclasses.asdict(jt)
            assert (tt.dominant, tt.t_bound, tt.t_serial, tt.fraction(1e-3)) == \
                (jt.dominant, jt.t_bound, jt.t_serial, jt.fraction(1e-3))


@pytest.mark.parametrize("driver", list(DRIVERS))
def test_driver_csv_and_derived_equal_the_reference(driver, outdirs):
    import importlib

    port_mod, csv_name, kwargs = DRIVERS[driver]
    ref_mod = importlib.import_module(f"benchmarks.{driver}")
    before = _repo_csv_state(csv_name)
    ref_rows = ref_mod.run(**kwargs)
    port_rows = port_mod.run(**kwargs)
    assert [(n, d) for n, _, d in port_rows] == [(n, d) for n, _, d in ref_rows]
    ref, port = outdirs
    assert (port / f"{csv_name}.csv").read_bytes() == (ref / f"{csv_name}.csv").read_bytes()
    assert _repo_csv_state(csv_name) == before


def test_h100_native_table(outdirs):
    _, port = outdirs
    [(name, _, derived)] = tpu_native.run(chip="h100-sxm")
    assert name == "h100_native"
    assert derived.startswith("any_cap_engaged=False;")
    lines = (port / "h100_native.csv").read_text().splitlines()
    assert lines[0] == ("arch,dvfs_class,decode_power_w,any_cap_engaged,best_clock_mhz,"
                        "lock_savings_pct,e_tok_default_mj,e_tok_locked_mj,dominant")
    assert len(lines) == 11
    with pytest.raises(ValueError):
        tpu_native.run(chip="h200-sxm")


def _dryrun_records():
    base = dict(applicable=True, ok=True, n_devices=256, collective_count=3,
                model_flops_per_step=4.0e15)
    return [
        dict(base, arch="gemma-2b", shape="decode", mesh="pod16x16",
             hlo_flops_per_device=2e13, hlo_bytes_per_device=1e9,
             collective_bytes_per_device=1e6),                 # compute
        dict(base, arch="gemma-2b", shape="decode", mesh="pod16x16", unrolled_accounting=True,
             hlo_flops_per_device=3e13, hlo_bytes_per_device=1e9,
             collective_bytes_per_device=1e6),                 # the same cell, unrolled
        dict(base, arch="qwen3-4b", shape="prefill", mesh="pod16x16",
             hlo_flops_per_device=1e9, hlo_bytes_per_device=4e10,
             collective_bytes_per_device=1e6),                 # memory
        dict(base, arch="qwen3-4b", shape="prefill", mesh="pod2x16x16", n_devices=512,
             hlo_flops_per_device=1e9, hlo_bytes_per_device=1e8,
             collective_bytes_per_device=5e9),                 # collective
        dict(base, arch="mamba2-780m", shape="decode", mesh="pod16x16", ok=False,
             hlo_flops_per_device=1.0, hlo_bytes_per_device=1.0,
             collective_bytes_per_device=0.0),
        dict(base, arch="zamba2-1.2b", shape="decode", mesh="pod16x16", applicable=False,
             hlo_flops_per_device=1.0, hlo_bytes_per_device=1.0,
             collective_bytes_per_device=0.0),
    ]


def test_roofline_report_analyse_cell_equals_the_reference():
    for rec in _dryrun_records():
        assert roofline_report.analyse_cell(rec) == j_roofline_report.analyse_cell(rec)


def test_roofline_report_run_equals_the_reference(tmp_path, outdirs, monkeypatch):
    ref, port = outdirs
    monkeypatch.setattr(j_roofline_report, "RESULTS_DIR", str(ref))
    monkeypatch.chdir(tmp_path)
    # no artefacts: the same message
    assert [r[::2] for r in roofline_report.run()] == [r[::2] for r in j_roofline_report.run()]
    assert not port.exists()
    # artefacts under the working directory's results/dryrun, as the dry run writes them
    art = tmp_path / "results" / "dryrun"
    art.mkdir(parents=True)
    for i, rec in enumerate(_dryrun_records()):
        (art / f"cell{i}.json").write_text(json.dumps(rec))
    cells = roofline_report.load_cells()
    assert cells == j_roofline_report.load_cells(str(art))
    assert [(c["arch"], c["mesh"], c["accounting"]) for c in cells] == [
        ("gemma-2b", "pod16x16", "unrolled"), ("qwen3-4b", "pod16x16", "scanned"),
        ("qwen3-4b", "pod2x16x16", "scanned")]
    assert roofline_report.to_markdown(cells) == j_roofline_report.to_markdown(cells)
    assert [r[::2] for r in roofline_report.run()] == [r[::2] for r in j_roofline_report.run()]
    for name in ("roofline.csv", "roofline.md"):
        assert (port / name).read_bytes() == (ref / name).read_bytes()


# CSV row -> the reference's oracle
REF_ORACLES = {"decode_attn": jkernels.decode_attention_ref,
               "mla_decode": jkernels.mla_latent_decode_ref,
               "ssd_prefill": jkernels.ssd_scan_ref, "gdn_prefill": jkernels.gdn_scan_ref}


@pytest.mark.parametrize("name", list(REF_ORACLES))
def test_kernels_micro_plain_versions_match_reference_oracles(name):
    import torch

    arrays, kwargs = kernels_micro.make_inputs()[name]
    _, kernel, plain, _, tol = kernels_micro.KERNELS[name]
    assert all(a.dtype in (np.float32, np.int32) for a in arrays)
    want = REF_ORACLES[name](*(jnp.asarray(a) for a in arrays), *kwargs.values())
    want = want if isinstance(want, tuple) else (want,)
    args = [torch.from_numpy(a) for a in arrays]
    for fn in (kernel, plain):       # on CPU tensors the wrapper runs the plain version
        got = fn(*args, **kwargs)
        got = got if isinstance(got, tuple) else (got,)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol, rtol=tol)


def test_kernels_micro_rows_on_cpu(outdirs, monkeypatch):
    ref, port = outdirs
    # the reference's modelled figures, its timing left out
    monkeypatch.setattr(j_kernels_micro, "_bench", lambda *a, **k: 0.0)
    ref_rows = j_kernels_micro.run()
    before = _repo_csv_state("kernels_micro")
    rows = kernels_micro.run(device="cpu")
    assert [r[0] for r in rows] == [r[0] for r in ref_rows]

    def modelled(derived):
        return [seg for seg in derived.split(";") if seg.startswith("modelled")]

    for (_, _, got), (_, _, want) in zip(rows, ref_rows):
        assert "ran=plain" in got and "launches=0" in got
        assert modelled(got) == modelled(want)
    assert sum(bool(modelled(r[2])) for r in rows) == 3
    lines = (port / "kernels_micro.csv").read_text().splitlines()
    assert lines[0] == "kernel,kernel_us,ref_us"
    assert [ln.split(",")[0] for ln in lines[1:]] == \
        [ln.split(",")[0] for ln in (ref / "kernels_micro.csv").read_text().splitlines()[1:]]
    assert _repo_csv_state("kernels_micro") == before


def test_kernels_micro_refuses_cuda_without_a_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        kernels_micro.run()


def test_h100_spec_fields():
    assert (H100_SXM.name, H100_SXM.peak_flops_bf16, H100_SXM.hbm_bw, H100_SXM.hbm_capacity,
            H100_SXM.ici_bw, H100_SXM.ici_links, H100_SXM.tdp) == \
        ("h100-sxm", 989e12, 3.35e12, 80e9, 450e9 / 18, 18, 700.0)
    h200 = dataclasses.asdict(thw.H200_SXM)
    differ = {k for k, v in dataclasses.asdict(H100_SXM).items() if h200[k] != v}
    assert differ == {"name", "hbm_bw", "hbm_capacity"}


def test_h100_engages_no_cap_at_bs1_and_decode_is_memory_bound():
    model = tcommon.h100_model()
    ridge = thw.ridge_point(H100_SXM)
    for arch, make in PAPER_MODELS.items():
        w = tcore.decode_workload(make(), 1, 1024)
        for cap in H100_SXM.power_cap_levels:
            op = tcore.resolve(model, w, tcore.PowerCap(cap))
            assert not op.engaged, (arch, cap)
            assert op.actual_clock_mhz == H100_SXM.governor_default_clock
        assert thw.arithmetic_intensity(w.flops_mxu + w.flops_vpu, w.hbm_bytes) < ridge, arch
        assert thw.bound_class(H100_SXM, w.flops_mxu + w.flops_vpu, w.hbm_bytes) == "memory"


def test_serve_chip_h100_resolves(monkeypatch, capsys):
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "gemma-2b", "--requests", "1",
                                      "--max-new", "2", "--max-batch", "1", "--chip",
                                      "h100-sxm", "--device", "cpu"])
    serve.main()
    out = dict(line.removeprefix("[serve] ").split(": ", 1)
               for line in capsys.readouterr().out.splitlines())
    w = tcore.decode_workload(get_config("gemma-2b"), 1, 1024)
    want = tcore.resolve(tcommon.h100_model(), w, tcore.Default())
    assert float(out["decode_power_w"]) == want.power_w
    assert out["completed"] == "1"
    h200 = tcore.resolve(tcommon.h200_model(), w, tcore.Default())
    assert want.power_w != h200.power_w


def test_runner_reaches_every_driver(monkeypatch, capsys):
    """``run.main`` calls every driver of the port once (``tpu_native``
    and ``serve_scale`` twice), passing ``--device`` to those that run a
    model or kernel."""
    import importlib
    import pkgutil

    import repro_torch.benchmarks as pkg

    calls = []
    names = sorted(m.name for m in pkgutil.iter_modules(pkg.__path__)
                   if m.name not in ("common", "run"))
    for name in names:
        mod = importlib.import_module(f"repro_torch.benchmarks.{name}")
        monkeypatch.setattr(mod, "run", lambda _n=name, **kw: calls.append((_n, kw)) or
                            [(_n, 1.0, "x")])
    trun.main(["--device", "cpu", "--smoke"])
    assert sorted({n for n, _ in calls}) == names
    assert [kw for n, kw in calls if n == "tpu_native"] == [{}, {"chip": "h100-sxm"}]
    assert [kw.pop("batched") for n, kw in calls if n == "serve_scale"] == [True, False]
    for n, kw in calls:
        if n.startswith("serve_"):
            assert kw == {"smoke": True, "device": "cpu"}
        elif n == "kernels_micro":
            assert kw == {"device": "cpu"}
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "name,us_per_call,derived" and len(out) == 1 + len(calls)
