"""The port's one-card dry run against the reference's abstract specs.

* Every (arch x shape) cell's meta arguments (``launch.specs``) equal the
  reference's ``jax.eval_shape`` leaves: the same paths, shapes and dtypes,
  and the same total argument bytes. No step runs, nothing compiles.
* ``kernels/cost.py`` reproduces the bound expressions ``chip_smoke.py``
  kept until it called them (copied below as the oracle), at phase 3's
  cases; the main cases print the bound digits of the last chip run
  (valid_len as that run drew them).
* A reduced step on meta counts each of its kernels once per layer (scans
  twice a train step with remat, their backward once) and launches none.
* The whole sweep (``ASSIGNED_ARCHS`` x ``ALL_SHAPES``) comes back 32 ok and
  8 skipped, and ``roofline_report`` reads its artefacts priced with
  ``H100_SXM``.
"""
import functools

import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.launch.specs as jspecs
from repro.models import abstract_params as j_abstract_params
from repro_torch import kernels as K
from repro_torch.benchmarks import roofline_report
from repro_torch.configs import (
    ALL_SHAPES,
    ASSIGNED_ARCHS,
    ShapeSpec,
    get_config,
    reduced_config,
    shape_applicable,
)
from repro_torch.hw.h100 import H100_SXM
from repro_torch.kernels import cost
from repro_torch.launch import dryrun, specs
from repro_torch.launch.cost import CostCounter
from repro_torch.models import decode_step_paged, init_paged_cache
from repro_torch.training import tree as T

CELLS = [(a, s.name) for a in ASSIGNED_ARCHS for s in ALL_SHAPES]


# ------------------------------------------------ meta specs vs the reference
def _jkey(k) -> str:
    for attr in ("key", "idx", "name"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    raise TypeError(k)


def _jleaves(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/" + "/".join(_jkey(k) for k in path): (tuple(x.shape), str(x.dtype))
            for path, x in flat}


def _tleaves(tree) -> dict:
    return {p: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for p, t in zip(T.paths(tree), T.leaves(tree))}


@functools.lru_cache(maxsize=None)
def _ref_args(arch, shape_name) -> dict:
    """The reference's abstract arguments of a cell, by name, as its
    ``build_lowered`` passes them, flattened to {path: (shape, dtype)}."""
    cfg, shape = jconfigs.get_config(arch), jconfigs.get_shape(shape_name)
    inp = jspecs.input_specs(cfg, shape)
    if shape.kind == "train":
        args = {"state": jspecs.abstract_train_state(cfg), "batch": inp}
    elif shape.kind == "prefill":
        args = {"params": j_abstract_params(cfg), "inputs": inp["inputs"],
                "cache": jspecs.abstract_prefill_cache(cfg, shape),
                "enc_states": inp.get("enc_states")}
    else:
        args = {"params": j_abstract_params(cfg), "token": inp["token"],
                "cache": jspecs.abstract_decode_cache(cfg, shape), "lengths": inp["lengths"]}
    return _jleaves(args)


def _nbytes(leaves: dict) -> int:
    return sum(int(np.prod(s, dtype=np.int64)) * np.dtype(jax.numpy.dtype(d)).itemsize
               for s, d in leaves.values())


@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_meta_specs_equal_the_reference_abstract_leaves(arch, shape_name):
    shape = next(s for s in ALL_SHAPES if s.name == shape_name)
    args = dryrun.cell_args(get_config(arch), shape)
    want = _ref_args(arch, shape_name)
    got = _tleaves(args)
    assert all(t.device.type == "meta" for t in T.leaves(args))
    assert got == want
    assert dryrun.storage_bytes(args) == _nbytes(want)


# ------------------------------------ kernels/cost.py vs the old bound expressions
HBM, PEAK = 3.35e12, {"float32": 67e12, "tfloat32": 495e12, "bfloat16": 989e12}


def _oracle_bound(nbytes, ops, dtype):
    t_bytes, t_ops = nbytes / HBM * 1e3, ops / PEAK[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _oracle_gqa(paged, b, h, kv, dk, dv, l, bs, window, valid, elem):
    valid = np.minimum(np.asarray(valid, np.int64), l)
    first = np.maximum(valid - window, 0) if window else np.zeros_like(valid)
    keys = int((valid - first).sum())
    nbytes = b * h * dk * elem + keys * kv * (dk + dv) * elem + 4 * b + b * h * dv * elem
    if paged:
        nbytes += 4 * int(((valid + bs - 1) // bs - first // bs).sum())
    return _oracle_bound(nbytes, 2 * keys * (h // kv) * kv * (dk + dv),
                         "bfloat16" if elem == 2 else "float32")


def _oracle_mla(paged, b, h, rank, rope, l, bs, valid, elem):
    valid = np.minimum(np.asarray(valid, np.int64), l)
    keys = int(valid.sum())
    nbytes = (b * h * (rank + rope) * elem + keys * (rank + rope) * elem + 4 * b
              + b * h * rank * elem)
    if paged:
        nbytes += 4 * int(((valid + bs - 1) // bs).sum())
    return _oracle_bound(nbytes, 2 * keys * h * (rank + rope + rank),
                         "bfloat16" if elem == 2 else "float32")


def _oracle_scan(name, shape, elem):
    q = 64
    if name == "ssd_scan":
        b, s, h, p, n = shape
        nbytes = 2 * b * s * h * p * elem + 4 * b * s * h + 4 * h + 2 * b * s * n * elem \
            + 4 * b * h * p * n
        ops = b * s * (2 * q * n + h * ((q + 1) * p + 4 * n * p))
        return _oracle_bound(nbytes, ops, "bfloat16" if elem == 2 else "float32")
    if name == "gdn_scan":
        b, s, h, k = shape
        nbytes = 4 * b * s * h * k * elem + 8 * b * s * h + 4 * b * h * k * k
        return _oracle_bound(nbytes, b * s * h * (5 * q * k + 6 * k * k),
                             "bfloat16" if elem == 2 else "tfloat32")
    if name == "ssd_scan_bwd":
        b, s, h, p, n = shape
        nbytes = 3 * b * s * h * p * elem + 4 * b * s * n * elem + 8 * b * s * h + 8 * h
        ops = 3 * b * s * (2 * q * n + h * ((q + 1) * p + 4 * n * p))
        return _oracle_bound(nbytes, ops, "bfloat16" if elem == 2 else "float32")
    b, s, h, k = shape
    nbytes = 7 * b * s * h * k * elem + 16 * b * s * h
    return _oracle_bound(nbytes, 3 * b * s * h * (5 * q * k + 6 * k * k),
                         "bfloat16" if elem == 2 else "tfloat32")


def _cost_gqa(paged, b, h, kv, dk, dv, l, bs, window, valid, elem):
    valid = np.minimum(np.asarray(valid, np.int64), l)
    first = np.maximum(valid - window, 0) if window else np.zeros_like(valid)
    keys = int((valid - first).sum())
    if paged:
        pages = int(((valid + bs - 1) // bs - first // bs).sum())
        return cost.paged_decode_attention(b, h, kv, dk, dv, elem, keys, pages)
    return cost.decode_attention(b, h, kv, dk, dv, elem, keys)


def _valid(b, l, seed):
    v = np.random.default_rng(seed).integers(1, l + 1, b)
    v[0] = 1
    if b > 1:
        v[1] = l
    return v


# phase 3's GQA cases (paged, B, H, KV, Dk, Dv, L, bs, window), a sample of
# each kind, both dtypes
GQA_CASES = [
    (False, 8, 8, 1, 256, 256, 1024, 0, 0), (False, 2, 8, 2, 32, 16, 128, 0, 0),
    (False, 12, 36, 36, 64, 64, 128, 0, 0), (True, 8, 8, 1, 256, 256, 1024, 16, 0),
    (True, 3, 6, 6, 16, 16, 32, 8, 0), (True, 12, 36, 36, 64, 64, 128, 8, 0),
    (False, 8, 16, 8, 256, 256, 1024, 0, 256), (True, 8, 8, 1, 256, 256, 1024, 16, 100),
    (True, 8, 8, 1, 256, 256, 1024, 8, 100), (False, 8, 16, 8, 256, 256, 8192, 0, 4096),
    (True, 8, 16, 8, 256, 256, 8192, 16, 4096),
]
MLA_CASES = [
    (False, 8, 24, 512, 64, 1024, 0), (False, 8, 4, 32, 8, 128, 0),
    (False, 4, 128, 512, 64, 256, 0), (True, 8, 24, 512, 64, 1024, 16),
    (True, 8, 16, 512, 64, 512, 16),
]
SCAN_CASES = [
    ("ssd_scan", (1, 512, 80, 64, 128)), ("ssd_scan", (2, 128, 4, 32, 16)),
    ("ssd_scan", (1, 32, 48, 64, 128)), ("gdn_scan", (1, 512, 20, 128)),
    ("gdn_scan", (2, 64, 2, 16)), ("ssd_scan_bwd", (8, 512, 48, 64, 128)),
    ("ssd_scan_bwd", (8, 512, 64, 64, 64)), ("ssd_scan_bwd", (2, 128, 4, 96, 64)),
    ("gdn_scan_bwd", (4, 512, 20, 128)), ("gdn_scan_bwd", (2, 96, 4, 64)),
]


@pytest.mark.parametrize("elem", [4, 2], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", GQA_CASES, ids=str)
def test_gqa_cost_equals_the_old_bound(case, elem):
    valid = _valid(case[1], case[6], seed=sum(case[1:8]))
    assert cost.bound_ms(_cost_gqa(*case, valid, elem)) == _oracle_gqa(*case, valid, elem)


@pytest.mark.parametrize("elem", [4, 2], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", MLA_CASES, ids=str)
def test_mla_cost_equals_the_old_bound(case, elem):
    paged, b, h, rank, rope, l, bs = case
    valid = _valid(b, l, seed=l + h)
    keys = int(np.minimum(valid, l).sum())
    got = (cost.mla_paged_latent_decode(b, h, rank, rope, elem, keys,
                                        int(((valid + bs - 1) // bs).sum())) if paged
           else cost.mla_latent_decode(b, h, rank, rope, elem, keys))
    assert cost.bound_ms(got) == _oracle_mla(*case, valid, elem)


@pytest.mark.parametrize("elem", [4, 2], ids=["fp32", "bf16"])
@pytest.mark.parametrize("name,shape", SCAN_CASES, ids=str)
def test_scan_cost_equals_the_old_bound(name, shape, elem):
    assert cost.bound_ms(getattr(cost, name)(*shape, elem)) == _oracle_scan(name, shape, elem)


# the main cases of the last chip run (PERF.md section 6), valid_len as that
# run drew them: the bound column's digits
MAIN_BOUNDS = [
    ("decode_attention", lambda: _cost_gqa(False, 8, 8, 1, 256, 256, 1024, 0, 0,
                                           [1, 1024, 900, 640, 705, 470, 734, 371], 2),
     "0.00150"),
    ("paged_decode_attention", lambda: _cost_gqa(True, 8, 8, 1, 256, 256, 1024, 16, 0,
                                                 [1, 1024, 1012, 180, 104, 129, 850, 406], 2),
     "0.00115"),
    ("mla_latent_decode", lambda: cost.mla_latent_decode(
        8, 24, 512, 64, 2, sum([1, 1024, 752, 748, 750, 229, 626, 6])), "0.00155"),
    ("mla_paged_latent_decode", lambda: cost.mla_paged_latent_decode(
        8, 24, 512, 64, 2, sum([1, 1024, 818, 295, 764, 932, 496, 785]),
        sum(-(-v // 16) for v in [1, 1024, 818, 295, 764, 932, 496, 785])), "0.00188"),
    ("ssd_scan", lambda: cost.ssd_scan(1, 512, 80, 64, 128, 2), "0.00404"),
    ("gdn_scan", lambda: cost.gdn_scan(1, 512, 20, 128, 4), "0.00668"),
    ("ssd_scan_bwd", lambda: cost.ssd_scan_bwd(8, 512, 48, 64, 128, 2), "0.02426"),
    ("gdn_scan_bwd", lambda: cost.gdn_scan_bwd(4, 512, 20, 128, 4), "0.04402"),
]


@pytest.mark.parametrize("name,make,digits", MAIN_BOUNDS, ids=[m[0] for m in MAIN_BOUNDS])
def test_main_case_bounds_print_the_last_chip_runs_digits(name, make, digits):
    ms, by = cost.bound_ms(make())
    assert (f"{ms:.5f}", by) == (digits, "bytes")


def test_meta_keys_count_every_key_below_the_extent():
    assert cost.meta_keys(4, 1024) == (4096, None)
    assert cost.meta_keys(4, 1024, bs=16) == (4096, 4 * 64)
    # a window of 100 over 1024 keys: keys 924..1023, pages 57..63
    assert cost.meta_keys(2, 1024, 100, 16) == (200, 2 * 7)


# ------------------------------------------------ reduced steps on meta tensors
def _kinds(cfg):
    return list(cfg.block_kinds_flat())


def _launch_counts():
    return {f.__name__: f.launches for f in K.COUNTED_KERNELS}


def _n(cfg, *kinds):
    return sum(k in kinds for k in _kinds(cfg))


META_STEPS = [
    ("gemma-2b", "decode", lambda c: {"decode_attention": _n(c, "attn")}),
    ("gemma2-9b", "decode", lambda c: {"decode_attention": _n(c, "attn", "attn_global")}),
    ("deepseek-v2-lite-16b", "decode", lambda c: {"mla_latent_decode": _n(c, "mla", "mla_moe")}),
    ("zamba2-1.2b", "decode", lambda c: {"decode_attention": _n(c, "shared_attn")}),
    ("mamba2-780m", "prefill", lambda c: {"ssd_scan": _n(c, "ssm")}),
    ("gdn-4b", "prefill", lambda c: {"gdn_scan": _n(c, "gdn")}),
    ("mamba2-780m", "train", lambda c: {"ssd_scan": 2 * _n(c, "ssm"),
                                         "ssd_scan_bwd": _n(c, "ssm")}),
    ("gdn-4b", "train", lambda c: {"gdn_scan": 2 * _n(c, "gdn"), "gdn_scan_bwd": _n(c, "gdn")}),
    ("llama-3.2-vision-11b", "prefill", lambda c: {}),
    ("musicgen-large", "decode", lambda c: {"decode_attention": _n(c, "attn")}),
]


@pytest.mark.parametrize("arch,kind,want", META_STEPS, ids=[f"{a}-{k}" for a, k, _ in META_STEPS])
def test_reduced_step_on_meta_counts_each_kernel_call_and_launches_none(arch, kind, want):
    cfg = reduced_config(arch)
    before = _launch_counts()
    counter, meta = dryrun.build_cell(arch, ShapeSpec("probe", 64, 2, kind), cfg=cfg)
    assert _launch_counts() == before
    calls = {k: v["calls"] for k, v in counter.kernels.items()}
    assert calls == want(cfg)
    assert counter.flops > 0 and counter.bytes > 0 and counter.peak_bytes > 0
    for name, k in counter.kernels.items():
        assert k["bytes"] > 0 and k["ops"] > 0, name
    assert meta["argument_bytes"] == dryrun.storage_bytes(
        dryrun.cell_args(cfg, ShapeSpec("probe", 64, 2, kind)))


def test_reduced_gemma_decode_counts_one_call_a_layer_with_the_cell_extent():
    """gemma-2b's decode cell: ``decode_attention`` once per layer, each
    call counted over every key below the cache's extent."""
    cfg = reduced_config("gemma-2b")
    b, l = 2, 64
    counter, _ = dryrun.build_cell("gemma-2b", ShapeSpec("d", l, b, "decode"), cfg=cfg)
    k = counter.kernels["decode_attention"]
    n = _n(cfg, "attn")
    one = cost.decode_attention(b, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.head_dim,
                                4, b * l)
    assert (k["calls"], k["bytes"], k["ops"]) == (n, n * one.bytes, n * one.ops)


def test_paged_decode_on_meta_counts_the_paged_kernel():
    cfg = reduced_config("gemma-2b")
    b, bs, nb = 2, 16, 4
    params = specs.abstract_params(cfg)
    cache = init_paged_cache(cfg, b, 1 + b * nb, bs, device="meta")
    meta = lambda shape, dtype: torch.empty(shape, dtype=dtype, device="meta")
    before = _launch_counts()
    with torch.no_grad(), CostCounter() as c:
        logits, _, _ = decode_step_paged(params, cfg, meta((b,), torch.int32), cache,
                                         meta((b,), torch.int32), meta((b,), torch.bool),
                                         meta((b, nb), torch.int32))
    assert _launch_counts() == before
    assert logits.shape == (b, cfg.vocab_size) and logits.device.type == "meta"
    n = _n(cfg, "attn")
    assert {k: v["calls"] for k, v in c.kernels.items()} == {"paged_decode_attention": n}
    one = cost.paged_decode_attention(b, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                                      cfg.head_dim, 4, b * nb * bs, b * nb)
    assert c.kernels["paged_decode_attention"]["bytes"] == n * one.bytes


def test_counter_counts_matmul_flops_bytes_and_peak_storage():
    a = torch.empty((64, 32), device="meta")
    w = torch.empty((32, 16), device="meta")
    with CostCounter() as c:
        c.exclude([a, w])
        y = a @ w                      # 2 * 64 * 32 * 16 FLOPs
        z = y.relu()
        del y
        z = z.view(16, 64)             # a view moves nothing
    assert c.flops == 2 * 64 * 32 * 16
    mm_bytes = 4 * (64 * 32 + 32 * 16 + 64 * 16)
    assert c.bytes == mm_bytes + 4 * 2 * 64 * 16
    assert c.peak_bytes == 2 * 4 * 64 * 16     # y and z alive together
    assert c.live_bytes == 4 * 64 * 16


def test_indexed_reads_and_writes_count_the_rows_they_touch():
    buf = torch.empty((4, 1000, 8), device="meta")
    rows = torch.empty((4,), dtype=torch.int64, device="meta")
    pos = torch.empty((4,), dtype=torch.int64, device="meta")
    val = torch.empty((4, 8), device="meta")
    with torch.no_grad(), CostCounter() as c:
        c.exclude([buf, rows, pos, val])
        got = buf[rows, pos]
        buf[rows, pos] = val
    assert got.shape == (4, 8)
    # read: the indices, the 4 rows read and written out; write: the
    # indices and values read, the 4 rows written
    assert c.bytes == (2 * 8 * 4 + 2 * 4 * 32) + (2 * 8 * 4 + 2 * 4 * 32)
    assert c.peak_bytes == 4 * 32              # the gathered rows only


# ------------------------------------------------------------ the whole sweep
@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    recs = dryrun.sweep(out_dir=str(out), log=lambda _: None)
    return out, {(r["arch"], r["shape"]): r for r in recs}


def test_sweep_writes_32_ok_and_8_skipped_records(sweep):
    out, recs = sweep
    assert len(recs) == 40 == len(list(out.glob("*__h100x1.json")))
    ok = [k for k, r in recs.items() if r.get("ok")]
    skipped = [k for k, r in recs.items() if not r["applicable"]]
    assert len(ok) == 32 and len(skipped) == 8
    assert all(s == "long_500k" for _, s in skipped)
    for (arch, shape_name), r in recs.items():
        cfg = get_config(arch)
        assert r["applicable"] == shape_applicable(
            cfg, next(s for s in ALL_SHAPES if s.name == shape_name))[0]


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_sweep_records_for_each_arch(sweep, arch):
    _, recs = sweep
    for shape in ALL_SHAPES:
        r = recs[(arch, shape.name)]
        if not r["applicable"]:
            continue
        assert r["ok"], r.get("error")
        assert (r["mesh"], r["n_devices"], r["collective_bytes_per_device"]) == ("h100x1", 1, 0)
        assert r["hlo_flops_per_device"] > 0 and r["hlo_bytes_per_device"] > 0
        ma = r["memory_analysis"]
        assert ma["argument_size_in_bytes"] == _nbytes(_ref_args(arch, shape.name))
        assert ma["temp_size_in_bytes"] > 0 and "estimate" in \
            r["memory_analysis_source"]["temp_size_in_bytes"]
        assert "dispatch counter" in r["counts_from"]
        toks = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
        assert r["tokens_per_step"] == toks
        assert r["model_flops_per_step"] == pytest.approx(
            r["model_flops_per_token"] * toks * (1.0 if shape.kind == "train" else 1 / 3))


def test_probe_cells(sweep):
    """The reference's four probe cells (tests/test_dryrun_integration.py)
    on one card: gemma-2b's decode FLOPs near 2 N B (attention on top),
    deepseek-v2-lite-16b's MLA kernel once a layer, mamba2-780m's 500k
    decode with no kernel (the recurrent step has none), minicpm-2b's train
    step near 6 N tokens (remat's recompute on top)."""
    _, recs = sweep
    g = recs[("gemma-2b", "decode_32k")]
    n_g = get_config("gemma-2b").active_param_count()
    assert 2 * n_g * 128 < g["hlo_flops_per_device"] < 2 * n_g * 128 * 6
    assert g["kernels"]["decode_attention"]["calls"] == 18
    d = recs[("deepseek-v2-lite-16b", "decode_32k")]
    assert d["kernels"] == {"mla_latent_decode": d["kernels"]["mla_latent_decode"]}
    assert d["kernels"]["mla_latent_decode"]["calls"] == 27
    assert recs[("mamba2-780m", "long_500k")]["kernels"] == {}
    m = recs[("minicpm-2b", "train_4k")]
    assert m["model_flops_per_step"] < m["hlo_flops_per_device"] < 3 * m["model_flops_per_step"]


def test_sweep_is_resumable(sweep, monkeypatch):
    out, recs = sweep
    monkeypatch.setattr(dryrun, "build_cell", lambda *a, **k: pytest.fail("re-ran a cell"))
    again = dryrun.run_cell("gemma-2b", "decode_32k", out_dir=str(out))
    assert again == recs[("gemma-2b", "decode_32k")]


def test_roofline_report_prices_the_card_cells_with_h100(sweep, tmp_path, monkeypatch):
    out, recs = sweep
    cells = roofline_report.load_cells(str(out))
    assert len(cells) == 32 and {c["mesh"] for c in cells} == {"h100x1"}
    by = {(c["arch"], c["shape"]): c for c in cells}
    for key, c in by.items():
        r = recs[key]
        assert c["t_compute_s"] == r["hlo_flops_per_device"] / H100_SXM.peak_flops_bf16
        assert c["t_memory_s"] == r["hlo_bytes_per_device"] / H100_SXM.hbm_bw
        assert c["t_collective_s"] == 0.0
    monkeypatch.setenv("REPRO_DRYRUN_OUT", str(out))
    monkeypatch.setenv("REPRO_BENCH_OUT", str(tmp_path))
    [(name, _, derived)] = roofline_report.run()
    assert name == "roofline_report"
    assert derived.startswith("single_pod_cells=0;multi_pod_cells=0;one_card_cells=32;")
    md = (tmp_path / "roofline.md").read_text()
    assert "## One H100 (h100x1), priced with H100_SXM" in md
    assert md.count("| h100x1 |") == 32
    rows = (tmp_path / "roofline.csv").read_text().splitlines()
    assert len(rows) == 33
