"""The port's CUDA kernels on a card, against their plain versions:
decode attention (GQA) and MLA latent decode, dense and paged (in bf16 all
four on the tensor cores, replayed from CUDA graphs too; the paged ones
never reading a page past a request's keys); the SSD and gated-delta-rule
prefill scans (the chunked GDN scan at every head dim, strong decay and
from a CUDA graph); the serving pool's decode step replayed from its CUDA
graph against the eager step (streams, recurrent state, launch counts,
defrag under a captured graph); the disaggregated ``Cluster`` (a prefill
pool handing its cache rows to a graph-captured decode pool) against the
eager one, the handoff writing into the captured cache's own storage, and
a two-replica ``Fleet`` replayed twice; prefix sharing on the card (the
paged kernel over tables whose rows share pages, a prefix hit and a
copy-on-write split into a captured decode graph, the guard broken on
purpose), a fused event replay equal to its serial replay, and the fold of
the fused decode; the fleet recipes' fleets (the autoscaled fleet powering
replicas down and up under captured graphs, the homogeneous paged fleet),
graph against eager; ``kernels_micro`` over four of the kernels; decode
attention with the logit softcap and the sliding window (splits and pages
wholly below the window); a deepseek-v2-lite-shaped MoE decode step replayed
from a CUDA graph, bitwise equal to eager; training on the card (remat
off against on, two microbatches against one, compressed steps, a restart
from a checkpoint against a straight run, and the recurrent kinds'
gradients through the scans' backward kernels against the CPU's); the two
backward kernels against their plain twins.

Marked ``gpu``: each test decides inside itself whether a card is present
and skips without one. This file imports neither jax nor ``repro``, so it
runs on a machine without JAX:

    PYTHONPATH=src python -m pytest -m gpu --noconftest tests/test_torch_gpu.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels import (
    COUNTED_KERNELS,
    decode_attention,
    gdn_prefill,
    gdn_scan,
    gdn_scan_ref,
    mla_latent_decode,
    mla_latent_decode_ref,
    mla_paged_latent_decode,
    mla_paged_latent_decode_ref,
    paged_decode_attention,
    ssd_prefill,
    ssd_scan,
    ssd_scan_ref,
)
from repro_torch.kernels.decode_attn.decode_attn import TC_TILE, plan, tc_split_plan
from repro_torch.kernels.decode_attn.ref import (
    decode_attention_ref,
    paged_decode_attention_ref,
)
from repro_torch.kernels.mla_decode.mla_decode import plan as mla_plan
from repro_torch.kernels.ssd.ssd import CHUNK
from repro_torch.models import decode_step, init_cache, init_params, prefill
from repro_torch.models.config import StageSpec
from repro_torch.models.model import DECODE_KINDS, SCAN_KINDS
from repro_torch.serving import ClockSpec, Cluster, Fleet, FleetSpec, PoolSpec, ReplicaSpec, \
    ServingEngine
from repro_torch.training import make_prompts

TOL = {torch.float32: 5e-5, torch.bfloat16: 2e-2}
SCAN_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}   # tests/test_kernels.py, SSD / GDN


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run with `pytest -m gpu` on the GPU machine")


def _inputs(paged, dtype, b=8, h=8, kv=1, d=256, l=1024, bs=16, seed=3):
    rng = np.random.default_rng(seed)
    vl = rng.integers(1, l + 1, (b,)).astype(np.int32)
    vl[0], vl[-1] = 1, l
    q = rng.standard_normal((b, h, d), np.float32)
    if not paged:
        k = rng.standard_normal((b, l, kv, d), np.float32)
        v = rng.standard_normal((b, l, kv, d), np.float32)
        arrays = [q, k, v, vl]
    else:
        nb = l // bs
        n_pages = 1 + b * nb
        kp = rng.standard_normal((n_pages, bs, kv, d), np.float32)
        vp = rng.standard_normal((n_pages, bs, kv, d), np.float32)
        perm = rng.permutation(np.arange(1, n_pages))
        tables = np.zeros((b, nb), np.int32)
        used = 0
        for i, n in enumerate(-(-vl // bs)):
            tables[i, :n] = perm[used:used + n]
            used += n
        arrays = [q, kp, vp, tables, vl]
    ts = [torch.from_numpy(a).cuda() for a in arrays]
    ts[:3] = [t.to(dtype) for t in ts[:3]]
    return ts


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain(paged, dtype):
    _need_card()
    kernel, plain = ((paged_decode_attention, paged_decode_attention_ref) if paged
                     else (decode_attention, decode_attention_ref))
    ts = _inputs(paged, dtype)
    before = kernel.launches
    out = kernel(*ts, scale=1 / 16)
    want = plain(*ts, scale=1 / 16)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    torch.testing.assert_close(out.float(), want.float(), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("softcap,window", [(50.0, 0), (0.0, 200), (30.0, 100), (50.0, 1)])
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_softcap_window_matches_plain(dtype, paged, softcap, window):
    """Kernels 1 and 2 with the logit softcap and the sliding window against
    their plain versions, every output finite. At L 1024 the bf16 plan cuts
    64-key splits (fp32: 32), so under window 200 the longest requests have
    splits, pages and 16-key steps that hold no valid key; window 100 starts
    inside a page and a step; window 1 attends the newest key alone."""
    _need_card()
    kernel, plain = ((paged_decode_attention, paged_decode_attention_ref) if paged
                     else (decode_attention, decode_attention_ref))
    ts = _inputs(paged, dtype)
    vl = ts[-1].long()
    split_len = plan(dtype, vl.shape[0], 1024).split_len
    if window:
        assert bool(((vl - window) // split_len >= 1).any())   # a split with no valid key
    kw = dict(scale=1 / 16, softcap=softcap, window=window)
    out = kernel(*ts, **kw)
    want = plain(*ts, **kw)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    torch.testing.assert_close(out.float(), want.float(), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.gpu
def test_cuda_kernel_rejects_bad_operands():
    _need_card()
    q, k, v, vl = _inputs(False, torch.float32, l=64)
    with pytest.raises(TypeError):
        decode_attention(q, k, v, vl.long(), scale=0.1)
    with pytest.raises(ValueError):
        decode_attention(q, k.transpose(1, 2), v, vl, scale=0.1)
    with pytest.raises(ValueError):
        decode_attention(q[..., :250].contiguous(), k[..., :250].contiguous(),
                         v, vl, scale=0.1)


def _tc_inputs(g, dk, dv, kv=1, l=1024, seed=11):
    """bf16 dense inputs whose valid_len sits on every edge of the tensor-core
    kernel's plan: 1, a warp step (16) +- 1, a CTA tile (64) +- 1 and itself,
    a split +- 1 and itself, and L."""
    tile, split = TC_TILE, tc_split_plan(10 * kv, l)[1]
    vl = np.array([1, 15, 17, tile - 1, tile, tile + 1, split - 1, split, split + 1, l],
                  np.int32)
    rng = np.random.default_rng(seed)
    b = len(vl)
    q = rng.standard_normal((b, kv * g, dk), np.float32)
    k = rng.standard_normal((b, l, kv, dk), np.float32)
    v = rng.standard_normal((b, l, kv, dv), np.float32)
    ts = [torch.from_numpy(t).cuda().to(torch.bfloat16) for t in (q, k, v)]
    return ts + [torch.from_numpy(vl).cuda()]


@pytest.mark.gpu
@pytest.mark.parametrize("g,kv,dk,dv", [
    (1, 2, 64, 64),           # G = 1 (MHA)
    (3, 2, 128, 128),         # minitron-4b's group
    (4, 2, 128, 128),         # qwen3-4b's group
    (8, 1, 256, 256),         # gemma-2b
    (16, 1, 64, 64),          # a full 16-row tile
    (8, 2, 32, 16),           # Dk != Dv
    (4, 1, 40, 24),           # head dims that are multiples of 8, not of 16
])
def test_tc_decode_attention_matches_plain(g, kv, dk, dv):
    """The bf16 dense tensor-core kernel at every valid_len edge of its plan."""
    _need_card()
    ts = _tc_inputs(g, dk, dv, kv)
    scale = 1 / np.sqrt(dk)
    before = decode_attention.launches
    out = decode_attention(*ts, scale=scale)
    want = decode_attention_ref(*ts, scale)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1 and out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), want.float(), rtol=TOL[torch.bfloat16],
                               atol=TOL[torch.bfloat16])


@pytest.mark.gpu
def test_tc_decode_attention_replays_in_a_cuda_graph():
    """The split kernel and its combine, launched with programmatic dependent
    launch, captured once in a CUDA graph and replayed twice on new inputs:
    equal to the plain version both times."""
    _need_card()
    _replays_in_a_graph(lambda *a: decode_attention(*a, scale=0.0625),
                        lambda *a: decode_attention_ref(*a, 0.0625),
                        lambda seed: _tc_inputs(8, 256, 256, seed=seed), (12, 13, 14),
                        TOL[torch.bfloat16], TOL[torch.bfloat16])


def _tc_paged_inputs(g, dk, dv, kv=1, bs=16, l=1024, seed=15):
    """bf16 paged inputs whose valid_len sits on page, warp-step, tile and
    split edges (1, bs +- 1, 64 +- 1, a split +- 1 and itself, L - 1, L).
    Returns (kernel inputs, plain inputs): in the kernel's, every table entry
    at or past ceil(valid_len / bs) names a page full of NaN and the rows of
    a request's last page past valid_len are NaN, so that a read of any of
    them shows; the plain version's are the same with those entries on the
    null page 0 and those rows finite."""
    nb = l // bs
    split = tc_split_plan(10 * kv, nb * bs)[1]
    vl = np.array([1, bs - 1, bs + 1, TC_TILE - 1, TC_TILE + 1, split - 1, split, split + 1,
                   l - 1, l], np.int32)
    rng = np.random.default_rng(seed)
    b, used = len(vl), -(-vl // bs)
    n_pages = 2 + int(used.sum())                        # null page 0, live pages, NaN page
    q = rng.standard_normal((b, kv * g, dk), np.float32)
    kp = rng.standard_normal((n_pages, bs, kv, dk), np.float32)
    vp = rng.standard_normal((n_pages, bs, kv, dv), np.float32)
    kp[0] = vp[0] = 0
    tables = np.zeros((b, nb), np.int32)
    perm = rng.permutation(np.arange(1, n_pages - 1))
    start = 0
    for i, n in enumerate(used):
        tables[i, :n] = perm[start:start + n]
        start += n
    nan_tables = tables.copy()
    nan_kp, nan_vp = kp.copy(), vp.copy()
    nan_kp[-1] = nan_vp[-1] = np.nan
    for i, n in enumerate(used):
        nan_tables[i, n:] = n_pages - 1
        tail = vl[i] - (n - 1) * bs                      # live rows of the last page
        nan_kp[tables[i, n - 1], tail:] = nan_vp[tables[i, n - 1], tail:] = np.nan
    cuda = lambda a: torch.from_numpy(a).cuda()
    bf = lambda a: cuda(a).to(torch.bfloat16)
    qt, vlt = bf(q), cuda(vl)
    return ([qt, bf(nan_kp), bf(nan_vp), cuda(nan_tables), vlt],
            [qt, bf(kp), bf(vp), cuda(tables), vlt])


@pytest.mark.gpu
@pytest.mark.parametrize("bs", [8, 16, 32])
@pytest.mark.parametrize("g,kv,dk,dv", [
    (1, 2, 64, 64),           # G = 1 (MHA)
    (3, 2, 128, 128),         # minitron-4b's group
    (4, 2, 128, 128),         # qwen3-4b's group
    (8, 1, 256, 256),         # gemma-2b
    (16, 1, 64, 64),          # a full 16-row tile
    (8, 2, 32, 16),           # Dk != Dv
])
def test_tc_paged_decode_attention_matches_plain(g, kv, dk, dv, bs):
    """The bf16 paged tensor-core kernel at every valid_len edge of its plan
    and of the pages, touching no page or row past a request's keys."""
    _need_card()
    ts, plain_ts = _tc_paged_inputs(g, dk, dv, kv, bs)
    scale = 1 / np.sqrt(dk)
    before = paged_decode_attention.launches
    out = paged_decode_attention(*ts, scale=scale)
    want = paged_decode_attention_ref(*plain_ts, scale)
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == before + 1 and out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), want.float(), rtol=TOL[torch.bfloat16],
                               atol=TOL[torch.bfloat16])


@pytest.mark.gpu
def test_tc_paged_decode_attention_replays_in_a_cuda_graph():
    """The paged split kernel and its combine, replayed from a CUDA graph on
    new inputs and tables."""
    _need_card()
    _replays_in_a_graph(lambda *a: paged_decode_attention(*a, scale=0.0625),
                        lambda *a: paged_decode_attention_ref(*a, 0.0625),
                        lambda seed: _tc_paged_inputs(8, 256, 256, seed=seed)[1], (16, 17, 18),
                        TOL[torch.bfloat16], TOL[torch.bfloat16])


def _replays_in_a_graph(call, plain, make, seeds, rtol, atol):
    """``call`` captured once in a CUDA graph on static inputs and replayed on
    new ones copied in: equal to ``plain`` on each."""
    static = make(seeds[0])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call(*static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = call(*static)
    for seed in seeds[1:]:
        inputs = make(seed)
        for dst, src in zip(static, inputs):
            dst.copy_(src)
        graph.replay()
        wants = plain(*inputs)
        torch.cuda.synchronize()
        for got, want in zip(outs if isinstance(outs, tuple) else (outs,),
                             wants if isinstance(wants, tuple) else (wants,)):
            torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


def _tables(rng, vl, bs, nb, n_pages):
    """Distinct live pages per request, shuffled; null page 0 past them."""
    perm = rng.permutation(np.arange(1, n_pages))
    tables = np.zeros((len(vl), nb), np.int32)
    used = 0
    for i, n in enumerate(-(-vl // bs)):
        tables[i, :n] = perm[used:used + n]
        used += n
    return tables


def _mla_inputs(paged, dtype, b, h, rank, rope, l, bs=16, seed=5):
    rng = np.random.default_rng(seed)
    vl = rng.integers(1, l + 1, (b,)).astype(np.int32)
    vl[0], vl[-1] = 1, l
    q_lat = rng.standard_normal((b, h, rank), np.float32)
    q_rope = rng.standard_normal((b, h, rope), np.float32)
    rows = (1 + b * (l // bs), bs) if paged else (b, l)
    ckv = rng.standard_normal(rows + (rank,), np.float32)
    kr = rng.standard_normal(rows + (rope,), np.float32)
    arrays = [q_lat, q_rope, ckv, kr]
    if paged:
        arrays.append(_tables(rng, vl, bs, l // bs, rows[0]))
    ts = [torch.from_numpy(a).cuda() for a in arrays + [vl]]
    ts[:4] = [t.to(dtype) for t in ts[:4]]
    return ts


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,rank,rope,l", [
    (24, 512, 64, 1024),      # minitron-4b-mla at max_seq_len 1024
    (4, 32, 8, 128),          # reduced minitron-4b-mla
    (16, 512, 64, 256),       # deepseek-v2-lite heads
    (128, 512, 64, 96),       # deepseek-v2-236b heads
])
def test_mla_cuda_kernel_matches_plain(paged, dtype, h, rank, rope, l):
    _need_card()
    kernel, plain = ((mla_paged_latent_decode, mla_paged_latent_decode_ref) if paged
                     else (mla_latent_decode, mla_latent_decode_ref))
    ts = _mla_inputs(paged, dtype, 8, h, rank, rope, l)
    scale = 1 / np.sqrt(192)
    before = kernel.launches
    out = kernel(*ts, scale=scale)
    want = plain(*ts, scale=scale)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    torch.testing.assert_close(out.float(), want.float(), rtol=TOL[dtype], atol=TOL[dtype])


def _tc_mla_inputs(paged, h, rank, rope, l=1024, bs=16, seed=21):
    """bf16 inputs, dense or paged, whose valid_len sits on the edges of the
    tensor-core kernel's plan (1, a step of 32 +- 1, a split +- 1, L); the
    paged tables repeat a page."""
    b = 10
    split = mla_plan(torch.bfloat16, b, h, l).split_len
    vl = np.array([1, 31, 32, 33, split - 1, split, split + 1, l // 2, l - 1, l], np.int32)
    rng = np.random.default_rng(seed)
    rows = (1 + 3 * (l // bs), bs) if paged else (b, l)
    q_lat = rng.standard_normal((b, h, rank), np.float32)
    q_rope = rng.standard_normal((b, h, rope), np.float32)
    ckv = rng.standard_normal(rows + (rank,), np.float32)
    kr = rng.standard_normal(rows + (rope,), np.float32)
    ts = [torch.from_numpy(t).cuda().to(torch.bfloat16) for t in (q_lat, q_rope, ckv, kr)]
    if paged:
        tables = rng.integers(1, rows[0], (b, l // bs)).astype(np.int32)
        tables[:, 1] = tables[:, 0]                      # a repeated page
        ts.append(torch.from_numpy(tables).cuda())
    return ts + [torch.from_numpy(vl).cuda()]


def _mla_pair(paged):
    return ((mla_paged_latent_decode, mla_paged_latent_decode_ref) if paged
            else (mla_latent_decode, mla_latent_decode_ref))


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("h,rank,rope,l", [
    (24, 512, 64, 1024),      # minitron-4b-mla at max_seq_len 1024
    (4, 32, 8, 128),          # reduced minitron-4b-mla
    (16, 512, 64, 512),       # deepseek-v2-lite heads
    (128, 512, 64, 256),      # deepseek-v2-236b heads
])
def test_tc_mla_matches_plain(paged, h, rank, rope, l):
    """The bf16 tensor-core kernel, dense and paged, at every valid_len edge
    of its plan (paged: a repeated page in every table)."""
    _need_card()
    kernel, plain = _mla_pair(paged)
    ts = _tc_mla_inputs(paged, h, rank, rope, l)
    before = kernel.launches
    out = kernel(*ts, scale=0.1)
    want = plain(*ts, 0.1)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1 and out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), want.float(), rtol=TOL[torch.bfloat16],
                               atol=TOL[torch.bfloat16])


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [False, True])
def test_tc_mla_replays_in_a_cuda_graph(paged):
    """The split kernel and its combine, launched with programmatic dependent
    launch, replayed from a CUDA graph on new inputs, dense and paged."""
    _need_card()
    kernel, plain = _mla_pair(paged)
    _replays_in_a_graph(lambda *a: kernel(*a, scale=0.1), lambda *a: plain(*a, 0.1),
                        lambda seed: _tc_mla_inputs(paged, 24, 512, 64, seed=seed), (31, 32, 33),
                        TOL[torch.bfloat16], TOL[torch.bfloat16])


@pytest.mark.gpu
def test_mla_cuda_kernel_rejects_bad_operands():
    _need_card()
    q_lat, q_rope, ckv, kr, vl = _mla_inputs(False, torch.float32, 2, 4, 32, 8, 64)
    with pytest.raises(TypeError):
        mla_latent_decode(q_lat, q_rope, ckv, kr, vl.long(), scale=0.1)
    with pytest.raises(TypeError):
        mla_latent_decode(q_lat, q_rope, ckv.bfloat16(), kr, vl, scale=0.1)
    with pytest.raises(ValueError):
        mla_latent_decode(q_lat, q_rope, ckv.transpose(0, 1), kr.transpose(0, 1), vl,
                          scale=0.1)
    with pytest.raises(ValueError):                      # rope 6 is not a 16-byte multiple
        mla_latent_decode(q_lat, q_rope[..., :6].contiguous(), ckv, kr[..., :6].contiguous(),
                          vl, scale=0.1)
    big = torch.zeros((2, 129, 32), device="cuda")
    with pytest.raises(ValueError):                      # H = 129 > 128
        mla_latent_decode(big, torch.zeros((2, 129, 8), device="cuda"), ckv, kr, vl,
                          scale=0.1)


def _ssd_inputs(dtype, b, s, h, p, n, seed=7):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p), np.float32) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h), np.float32)))
    a = -np.exp(np.linspace(-2, 0.5, h)).astype(np.float32)
    bm = rng.standard_normal((b, s, n), np.float32) * 0.3
    cm = rng.standard_normal((b, s, n), np.float32) * 0.3
    x, dt, a, bm, cm = (torch.from_numpy(t).cuda() for t in (x, dt, a, bm, cm))
    return x.to(dtype), dt, a, bm.to(dtype), cm.to(dtype)


def _gdn_inputs(dtype, b, s, h, k, seed=8):
    rng = np.random.default_rng(seed)
    unit = lambda t: t / np.linalg.norm(t, axis=-1, keepdims=True)
    q = unit(rng.standard_normal((b, s, h, k))).astype(np.float32)
    kk = unit(rng.standard_normal((b, s, h, k))).astype(np.float32)
    v = (rng.standard_normal((b, s, h, k)) * 0.5).astype(np.float32)
    beta = (1 / (1 + np.exp(-rng.standard_normal((b, s, h))))).astype(np.float32)
    alpha = (1 / (1 + np.exp(-rng.standard_normal((b, s, h)) - 2))).astype(np.float32)
    q, kk, v, beta, alpha = (torch.from_numpy(t).cuda() for t in (q, kk, v, beta, alpha))
    return q.to(dtype), kk.to(dtype), v.to(dtype), beta, alpha


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,n", [
    (1, 512, 80, 64, 128),    # mamba2-4b prefill, 512-token bucket
    (2, 128, 4, 32, 16),      # reduced mamba2-4b
    (1, 100, 8, 64, 64),      # not a chunk multiple (through ssd_prefill)
])
def test_ssd_cuda_kernel_matches_plain(dtype, b, s, h, p, n):
    _need_card()
    ts = _ssd_inputs(dtype, b, s, h, p, n)
    before = ssd_scan.launches
    y, fs = ssd_prefill(*ts)
    want_y, want_fs = ssd_scan_ref(*ts)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1 and y.dtype == dtype
    tol = SCAN_TOL[dtype]
    torch.testing.assert_close(y.float(), want_y, rtol=tol, atol=tol)
    torch.testing.assert_close(fs, want_fs, rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("s", [64, 100, 512, 1024])
@pytest.mark.parametrize("n", [16, 64, 128])
def test_ssd_tc_kernel_matches_plain(s, n):
    """The bf16 tensor-core scan at B = 2 over sequence lengths and state
    dims; its final state held at the fp32 tolerance, as the served model's
    per-layer check holds it."""
    _need_card()
    ts = _ssd_inputs(torch.bfloat16, 2, s, 4, 64, n)
    y, fs = ssd_prefill(*ts)
    want_y, want_fs = ssd_scan_ref(*ts)
    torch.cuda.synchronize()
    tol = SCAN_TOL[torch.bfloat16]
    torch.testing.assert_close(y.float(), want_y, rtol=tol, atol=tol)
    torch.testing.assert_close(fs, want_fs, rtol=SCAN_TOL[torch.float32],
                               atol=SCAN_TOL[torch.float32])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_zero_dt_chunk(dtype):
    """A whole chunk of dt = 0 rows leaves the state alone and adds nothing."""
    _need_card()
    x, dt, a, bm, cm = _ssd_inputs(dtype, 1, 4 * CHUNK, 8, 64, 128)
    dt[:, CHUNK:2 * CHUNK] = 0
    y, fs = ssd_prefill(x, dt, a, bm, cm)
    want_y, want_fs = ssd_scan_ref(x, dt, a, bm, cm)
    torch.cuda.synchronize()
    tol = SCAN_TOL[dtype]
    torch.testing.assert_close(y.float(), want_y, rtol=tol, atol=tol)
    torch.testing.assert_close(fs, want_fs, rtol=SCAN_TOL[torch.float32],
                               atol=SCAN_TOL[torch.float32])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,k", [
    (1, 512, 20, 128),        # gdn-4b prefill, 512-token bucket
    (2, 64, 2, 16),           # reduced gdn-4b
    (1, 50, 3, 64),           # not a chunk multiple (through gdn_prefill)
])
def test_gdn_cuda_kernel_matches_plain(dtype, b, s, h, k):
    _need_card()
    ts = _gdn_inputs(dtype, b, s, h, k)
    before = gdn_scan.launches
    y, fs = gdn_prefill(*ts)
    want_y, want_fs = gdn_scan_ref(*ts)
    torch.cuda.synchronize()
    assert gdn_scan.launches == before + 1 and y.dtype == dtype
    tol = SCAN_TOL[dtype]
    torch.testing.assert_close(y.float(), want_y, rtol=tol, atol=tol)
    torch.testing.assert_close(fs, want_fs, rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,k", [
    (1, 300, 20, 128),        # not a chunk multiple: gdn_prefill pads
    (2, 256, 20, 128),        # B = 2
    (2, 1024, 4, 64),         # 32 chunks
    (1, 32, 3, 32),           # one chunk
])
def test_gdn_chunked_kernel_matches_plain(dtype, b, s, h, k):
    """The chunked tensor-core scan (prep and chain kernels) at the shapes
    ``chip_smoke.py`` checks beside the ones above, every K it takes; the
    final state held at the fp32 tolerance in both dtypes."""
    _need_card()
    ts = _gdn_inputs(dtype, b, s, h, k, seed=9)
    y, fs = gdn_prefill(*ts)
    want_y, want_fs = gdn_scan_ref(*ts)
    torch.cuda.synchronize()
    torch.testing.assert_close(y.float(), want_y, rtol=SCAN_TOL[dtype], atol=SCAN_TOL[dtype])
    torch.testing.assert_close(fs, want_fs, rtol=SCAN_TOL[torch.float32],
                               atol=SCAN_TOL[torch.float32])


@pytest.mark.gpu
def test_gdn_kernel_strong_decay_and_unit_beta():
    """alpha near 0.05 (the in-chunk decays underflow) and beta = 1."""
    _need_card()
    q, k, v, beta, alpha = _gdn_inputs(torch.float32, 1, 256, 4, 128, seed=10)
    alpha = torch.full_like(alpha, 0.05)
    beta = torch.ones_like(beta)
    y, fs = gdn_prefill(q, k, v, beta, alpha)
    want_y, want_fs = gdn_scan_ref(q, k, v, beta, alpha)
    torch.cuda.synchronize()
    tol = SCAN_TOL[torch.float32]
    torch.testing.assert_close(y, want_y, rtol=tol, atol=tol)
    torch.testing.assert_close(fs, want_fs, rtol=tol, atol=tol)


@pytest.mark.gpu
def test_gdn_kernel_replays_in_a_cuda_graph():
    """The prep kernel and the chain, launched with programmatic dependent
    launch, replayed from a CUDA graph on new inputs."""
    _need_card()
    tol = SCAN_TOL[torch.float32]
    _replays_in_a_graph(gdn_scan, gdn_scan_ref,
                        lambda seed: _gdn_inputs(torch.float32, 1, 512, 20, 128, seed=seed),
                        (41, 42, 43), tol, tol)


@pytest.mark.gpu
def test_scan_kernels_reject_bad_operands():
    _need_card()
    x, dt, a, bm, cm = _ssd_inputs(torch.float32, 1, 64, 2, 32, 16)
    with pytest.raises(TypeError):                       # dt must be fp32
        ssd_scan(x, dt.bfloat16(), a, bm, cm)
    with pytest.raises(TypeError):                       # b, c in x's dtype
        ssd_scan(x, dt, a, bm.bfloat16(), cm.bfloat16())
    b2, c2 = torch.stack([bm, bm.flip(1)], 2), torch.stack([cm, -cm], 2)   # ssm_groups 2
    before = ssd_scan.launches
    y2, fs2 = ssd_prefill(x, dt, a, b2, c2)
    assert ssd_scan.launches == before + 1               # the kernel, not the twin
    wy, wfs = ssd_scan_ref(x, dt, a, b2, c2)
    tol = SCAN_TOL[torch.float32]
    torch.testing.assert_close(y2, wy, rtol=tol, atol=tol)
    torch.testing.assert_close(fs2, wfs, rtol=tol, atol=tol)
    with pytest.raises(ValueError):                      # 3 groups do not divide 2 heads
        ssd_scan(x, dt, a, torch.stack([bm] * 3, 2), torch.stack([cm] * 3, 2))
    with pytest.raises(ValueError):                      # a CPU operand for the kernel
        ssd_scan(x, dt.cpu(), a, bm, cm)
    with pytest.raises(ValueError):                      # P = 16: not a multiple of 32
        ssd_scan(x[..., :16].contiguous(), dt, a, bm, cm)
    with pytest.raises(ValueError):                      # the same for the bf16 kernel
        ssd_scan(x[..., :16].bfloat16(), dt, a, bm.bfloat16(), cm.bfloat16())
    q, k, v, beta, alpha = _gdn_inputs(torch.float32, 1, 32, 2, 16)
    with pytest.raises(TypeError):
        gdn_scan(q, k, v, beta.bfloat16(), alpha)
    with pytest.raises(TypeError):
        gdn_scan(q, k.bfloat16(), v, beta, alpha)
    with pytest.raises(ValueError):
        gdn_scan(q, k, v.cpu(), beta, alpha)
    with pytest.raises(ValueError):                      # K = 8: no instance
        gdn_scan(*(t[..., :8].contiguous() for t in (q, k, v)), beta, alpha)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["gemma-2b", "minitron-4b-mla", "mamba2-4b", "gdn-4b"])
def test_decode_step_on_card_matches_cpu(arch):
    """Reduced model in fp32: one prefill + decode step on the card (kernel
    path: the scan kernels in prefill for mamba2-4b and gdn-4b, the decode
    kernels for the others) against the same weights on the CPU (plain
    path)."""
    _need_card()
    cfg = reduced_config(arch)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    gpu_params = _to(params, "cuda")
    toks = torch.from_numpy(np.random.default_rng(0).integers(1, cfg.vocab_size, (2, 10)))
    lens = torch.tensor([10, 6], dtype=torch.int32)
    outs = []
    for dev, p in (("cpu", params), ("cuda", gpu_params)):
        cache = init_cache(cfg, 2, 32, device=dev)
        logits, cache, _ = prefill(p, cfg, toks.to(dev), cache, prompt_lengths=lens.to(dev))
        tok = torch.argmax(logits, -1).to(torch.int32)
        logits, _, _ = decode_step(p, cfg, tok, cache, lens.to(dev))
        outs.append(logits.cpu())
    torch.testing.assert_close(outs[1], outs[0], rtol=1e-4, atol=1e-4)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


# reduced model -> (its decode kernels (dense, paged), its prefill scan)
GRAPH_MODELS = {
    "gemma-2b": (("decode_attention", "paged_decode_attention"), None),
    "minitron-4b-mla": (("mla_latent_decode", "mla_paged_latent_decode"), None),
    "mamba2-4b": (None, "ssd_scan"),
    "gdn-4b": (None, "gdn_scan"),
    "gemma2-9b": (("decode_attention", "paged_decode_attention"), None),
    "deepseek-v2-lite-16b": (("mla_latent_decode", "mla_paged_latent_decode"), None),
    "zamba2-1.2b": (("decode_attention", "paged_decode_attention"), "ssd_scan"),
}


def _layers(cfg, kinds):
    return sum(k in kinds for k in cfg.block_kinds_flat())


def _reduced(arch, dtype):
    cfg = dataclasses.replace(reduced_config(arch), param_dtype=dtype, compute_dtype=dtype)
    return cfg, init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")


def _serve(cfg, params, *, paged, graphs, steps=None, defrag=False,
           max_new=(16, 5, 9, 12, 7, 14)):
    """A reduced engine over six prompts of ``max_new`` new tokens each
    (max_batch 4; staggered lengths, so that admissions and finishes
    interleave and freed pages leave holes); ``steps`` stops it early. With ``defrag``,
    the pool compacts its pages after every step once its graph exists.
    Returns (engine, streams, launch counts moved, defrags that moved pages)."""
    engine = ServingEngine(cfg, params, max_batch=4, max_seq_len=128, paged=paged,
                           kv_block_size=8, device="cuda", cuda_graphs=graphs)
    reqs = [engine.submit(p, max_new_tokens=m)
            for p, m in zip(make_prompts(cfg, 6, 5, 40, seed=1), max_new)]
    before = {fn.__name__: fn.launches for fn in COUNTED_KERNELS}
    n, moved = 0, 0
    while (engine.waiting or engine.pool.occupancy()) and n != steps:
        engine.step()
        n += 1
        if defrag and engine.pool._graph is not None:
            tables = engine.pool.block_tables.copy()
            engine.pool.defrag()
            moved += not np.array_equal(tables, engine.pool.block_tables)
    torch.cuda.synchronize()
    counted = {fn.__name__: fn.launches - before[fn.__name__] for fn in COUNTED_KERNELS}
    return engine, [r.output for r in reqs], counted, moved


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", list(GRAPH_MODELS))
def test_graph_engine_matches_eager(arch, dtype, paged):
    """The pool's decode step replayed from its CUDA graph gives the eager
    step's greedy streams, runs one eager step and replays every later one,
    and launches each counted kernel as often as the eager engine: eager
    launches plus replays x captured launches = attention layers x decode
    steps for the model's decode kernel, recurrent layers x prefills for
    its scan, 0 for the others."""
    _need_card()
    cfg, params = _reduced(arch, dtype)
    decode, scan = GRAPH_MODELS[arch]
    streams = {}
    for graphs in (True, False):
        engine, streams[graphs], counted, _ = _serve(cfg, params, paged=paged, graphs=graphs)
        pool, st = engine.pool, engine.stats
        want = dict.fromkeys(counted, 0)
        if decode:
            want[decode[paged]] = _layers(cfg, DECODE_KINDS) * st.decode_steps
        if scan:
            want[scan] = _layers(cfg, SCAN_KINDS) * st.prefill_calls
        got = {k: n + pool.graph_replays * pool.captured_launches.get(k, 0)
               for k, n in counted.items()}
        assert got == want
        assert pool.graph_replays == (st.decode_steps - 1 if graphs else 0)
        assert (pool._graph is not None) == graphs
        assert pool.jit_dispatches == 2 * st.prefill_calls + st.decode_steps
    assert streams[True] == streams[False]


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [False, True])
def test_moe_decode_step_replays_bitwise_in_a_cuda_graph(paged):
    """A deepseek-v2-lite-16b decode step at its full widths (d 2048, MLA
    rank 512, 64 experts of 1408, top 6, two shared), cut to its dense first
    block and one ``mla_moe`` block, bf16, batch 8: captured in a CUDA graph
    and replayed, its logits and every cache leaf bitwise equal to the eager
    step on the same inputs. The MoE dispatch writes each (expert, rank)
    slot once and sums each token's k outputs in a fixed order, so no atomic
    reorders a sum."""
    _need_card()
    full = get_config("deepseek-v2-lite-16b")
    cfg = dataclasses.replace(full, stages=(StageSpec(unit=("mla",), n_units=1),
                                            StageSpec(unit=("mla_moe",), n_units=1)))
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    b, l, bs = 8, 256, 16
    g = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(1, cfg.vocab_size, (b,), generator=g, device="cuda").to(torch.int32)
    lengths = torch.randint(1, l - 1, (b,), generator=g, device="cuda").to(torch.int32)
    if paged:
        from repro_torch.models import decode_step_paged, init_paged_cache

        nb = l // bs
        cache = init_paged_cache(cfg, b, 1 + b * nb, bs, device="cuda")
        tables = (1 + torch.arange(b * nb, device="cuda", dtype=torch.int32)).reshape(b, nb)
        active = torch.ones(b, dtype=torch.bool, device="cuda")
        step = lambda c: decode_step_paged(params, cfg, tokens, c, lengths, active, tables)[0]
    else:
        cache = init_cache(cfg, b, l, device="cuda")
        step = lambda c: decode_step(params, cfg, tokens, c, lengths)[0]
    for leaf in _leaf_list(cache):
        leaf.normal_(generator=g)
    saved = [t.clone() for t in _leaf_list(cache)]

    def restore():
        for dst, src in zip(_leaf_list(cache), saved):
            dst.copy_(src)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.inference_mode(), torch.cuda.stream(side):
        step(cache)                                        # warm-up before the capture
    torch.cuda.current_stream().wait_stream(side)
    with torch.inference_mode():
        restore()
        eager = step(cache).clone()
        eager_cache = [t.clone() for t in _leaf_list(cache)]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = step(cache)
        restore()
        graph.replay()
        torch.cuda.synchronize()
    assert bool(torch.isfinite(eager).all())
    assert torch.equal(out, eager)
    for got, want in zip(_leaf_list(cache), eager_cache):
        assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("arch", ["mamba2-4b", "gdn-4b"])
def test_graph_replays_advance_recurrent_state_as_eager_steps(arch, paged):
    """After N decode steps (one eager, one captured, N - 2 replayed) the
    recurrent state equals N eager steps': neither the warm-up nor the
    capture advanced it."""
    _need_card()
    cfg, params = _reduced(arch, "float32")
    caches = []
    for graphs in (True, False):
        engine, _, _, _ = _serve(cfg, params, paged=paged, graphs=graphs, steps=6,
                                 max_new=(30,) * 6)
        assert engine.pool.graph_replays == (5 if graphs else 0)
        caches.append(engine.pool.cache)
    for got, want in zip(_leaf_list(caches[0]), _leaf_list(caches[1])):
        torch.testing.assert_close(got, want)


@pytest.mark.gpu
def test_defrag_under_a_captured_graph_matches_eager():
    """A graph-captured paged pool compacted after every step keeps replaying
    the right pages: its streams equal the eager pool's without defrag."""
    _need_card()
    cfg, params = _reduced("gemma-2b", "float32")
    engine, got, _, moved = _serve(cfg, params, paged=True, graphs=True, defrag=True)
    assert engine.pool.graph_replays > 0 and moved > 0
    assert got == _serve(cfg, params, paged=True, graphs=False)[1]


def _leaf_list(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaf_list(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaf_list(v)]
    return [tree]


# reduced disaggregated-cluster models -> (decode kernels (dense, paged), scan)
CLUSTER_MODELS = {
    "minicpm-2b": (("decode_attention", "paged_decode_attention"), None),
    "mamba2-780m": (None, "ssd_scan"),
}


def _cluster(cfg, params, *, paged, graphs, chunk=48):
    return Cluster(cfg, params, decode_batch=4, max_seq_len=128, prefill_chunk_tokens=chunk,
                   paged=paged, kv_block_size=8, device="cuda", cuda_graphs=graphs)


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", list(CLUSTER_MODELS))
def test_graph_cluster_matches_eager(arch, dtype, paged):
    """A ``Cluster`` whose decode pool replays its step from a CUDA graph,
    while the prefill pool hands it cache rows between replays, gives the
    eager cluster's greedy streams; launches across both pools are the
    decode kernel layers x decode steps (eager + replays x captured) and the
    scan layers x prefill calls."""
    _need_card()
    cfg, params = _reduced(arch, dtype)
    decode, scan = CLUSTER_MODELS[arch]
    layers = sum(st.n_units * len(st.unit) for st in cfg.stages)
    prompts = make_prompts(cfg, 6, 5, 40, seed=1)
    streams = {}
    for graphs in (True, False):
        cl = _cluster(cfg, params, paged=paged, graphs=graphs)
        reqs = [cl.submit(p, max_new_tokens=m) for p, m in zip(prompts, (16, 5, 9, 12, 7, 14))]
        before = {fn.__name__: fn.launches for fn in COUNTED_KERNELS}
        cl.run_to_completion()
        torch.cuda.synchronize()
        dec, pre = cl.decode_pool, cl.prefill_pool
        got = {fn.__name__: fn.launches - before[fn.__name__]
               + dec.graph_replays * dec.captured_launches.get(fn.__name__, 0)
               for fn in COUNTED_KERNELS}
        want = dict.fromkeys(got, 0)
        if decode:
            want[decode[paged]] = layers * cl.decode_stats.decode_steps
        if scan:
            want[scan] = layers * cl.prefill_stats.prefill_calls
        assert got == want
        assert dec.graph_replays == (cl.decode_stats.decode_steps - 1 if graphs else 0)
        assert pre.graph_replays == 0 and pre.cache is None
        streams[graphs] = [r.output for r in reqs]
    assert streams[True] == streams[False]


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("arch", list(CLUSTER_MODELS))
def test_handoff_into_a_captured_cache_keeps_addresses(arch, paged):
    """Admissions placed into the decode cache after its graph was captured
    write into every leaf's own storage (``data_ptr()`` unchanged), and the
    next step's logits from a graph replay equal the eager step's on a copy
    of the same cache, exactly."""
    _need_card()
    cfg, params = _reduced(arch, "bfloat16")
    prompts = make_prompts(cfg, 4, 5, 40, seed=2)
    cl = _cluster(cfg, params, paged=paged, graphs=True, chunk=128)
    for p in prompts[:2]:
        cl.submit(p, max_new_tokens=30)
    for _ in range(3):                           # eager step, capture, one replay
        cl.step()
    pool = cl.decode_pool
    assert pool._graph is not None and pool.graph_replays == 2   # the capture step replays too
    leaves = _leaf_list(pool.cache)
    ptrs = [t.data_ptr() for t in leaves]
    for p in prompts[2:]:
        cl.submit(p, max_new_tokens=30)
    admitted = cl.scheduler.tick(cl.waiting, cl.prefill_pool, pool)
    assert len(admitted) == 2 and pool.occupancy() == 4
    assert [t.data_ptr() for t in _leaf_list(pool.cache)] == ptrs
    with torch.inference_mode():
        pool._decode_begin()
        saved = [t.clone() for t in leaves]
        pool._graph.replay()
        graph_logits = pool._graph_out[0].clone()
        for dst, src in zip(leaves, saved):
            dst.copy_(src)
        eager_logits = pool._decode_fn()[0]
    torch.cuda.synchronize()
    assert torch.equal(graph_logits, eager_logits)
    assert bool(torch.isfinite(graph_logits).all())


@pytest.mark.gpu
def test_two_replica_fleet_replays_equal_on_the_card():
    """A reduced two-replica fleet (GQA and Mamba2, weights made on the card
    from each spec's seed), replayed twice with the barrier engine on split
    virtual clocks: equal placements, streams, stamps and joules."""
    _need_card()
    from repro_torch.core.traces import generate_trace

    spec = FleetSpec(replicas=tuple(
        ReplicaSpec(name=f"r{i}", arch=arch, clock=ClockSpec(mode="lock"),
                    decode=PoolSpec(batch=4, paged=True, kv_block_size=8, kv_blocks=48),
                    max_seq_len=128, prefill_chunk_tokens=64)
        for i, arch in enumerate(("qwen3-4b", "mamba2-780m"))), router="jsq")
    trace = generate_trace(reduced_config("qwen3-4b"), 10, arrival="poisson",
                           lengths="short_chat", rate_rps=40.0, seed=3, max_total_len=96)

    def replay():
        fleet = Fleet.from_spec(spec, device="cuda")
        done = sorted(fleet.run_trace(trace, engine="barrier"), key=lambda r: r.uid)
        assert all(r.decode_pool.graph_replays > 0 for r in fleet.replicas)
        return ([(r.replica, r.output, r.ledger.finish_s, r.decode_j) for r in done],
                fleet.total_energy_j())

    first = replay()
    assert len(first[0]) == 10 and {r[0] for r in first[0]} == {"r0", "r1"}
    assert replay() == first


# ------------------------------------------------ prefix sharing on the card
# kernel 2 over block tables whose rows share pages (as prefix hits make
# them): rows 0-4 share a three-page trunk, rows 3 and 4 the page after it
SHARED_VALID = (128, 113, 60, 52, 56, 17, 33, 1)
SHARED_TABLES = ((1, 2, 3, 5, 6, 7, 8, 9), (1, 2, 3, 10, 11, 12, 13, 14), (1, 2, 3, 15),
                 (1, 2, 3, 4), (1, 2, 3, 4), (16, 17), (18, 19, 20), (21,))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_over_shared_pages_matches_plain(dtype):
    """Kernel 2 at the ``serve_prefix`` shape (gemma-2b heads, bs 16, L 128)
    over tables whose rows name the same pages: equal to its plain version,
    with every page no entry below ceil(valid_len / bs) names, and every
    row of a named page past the longest valid_len reading it, NaN."""
    _need_card()
    bs, nb, d = 16, 8, 256
    rng = np.random.default_rng(4)
    n_pages = 2 + max(max(t) for t in SHARED_TABLES)
    kp = rng.standard_normal((n_pages, bs, 1, d), np.float32)
    vp = rng.standard_normal((n_pages, bs, 1, d), np.float32)
    kp[0] = vp[0] = 0
    tables = np.zeros((8, nb), np.int32)
    nan_tables = np.full((8, nb), n_pages - 1, np.int32)
    rows_read = np.zeros(n_pages, np.int64)
    for i, (vl, row) in enumerate(zip(SHARED_VALID, SHARED_TABLES)):
        tables[i, :len(row)] = nan_tables[i, :len(row)] = row
        for j, page in enumerate(row):
            rows_read[page] = max(rows_read[page], min(bs, vl - j * bs))
    nan_kp, nan_vp = kp.copy(), vp.copy()
    for page in range(1, n_pages):
        nan_kp[page, rows_read[page]:] = nan_vp[page, rows_read[page]:] = np.nan
    cuda = lambda a: torch.from_numpy(a).cuda()
    q = cuda(rng.standard_normal((8, 8, d), np.float32)).to(dtype)
    valid = cuda(np.asarray(SHARED_VALID, np.int32))
    got = paged_decode_attention(q, cuda(nan_kp).to(dtype), cuda(nan_vp).to(dtype),
                                 cuda(nan_tables), valid, scale=1.0 / 16)
    want = paged_decode_attention_ref(q, cuda(kp).to(dtype), cuda(vp).to(dtype),
                                      cuda(tables), valid, scale=1.0 / 16)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype], atol=TOL[dtype])


def _sharing_engine(cfg, params, graphs):
    return ServingEngine(cfg, params, max_batch=4, max_seq_len=128, paged=True,
                         kv_block_size=8, prefix_sharing=True, device="cuda",
                         cuda_graphs=graphs)


def _fork_setup(cfg, params, graphs):
    """A sharing engine whose decode graph is captured and whose index holds
    a finished 20-token request's transcript; its exact fork is queued
    (a boundary tail hit, so the fork's first decode write lands in a
    shared page). A long anchor request keeps the pool stepping."""
    anchor, trunk = make_prompts(cfg, 2, 20, 21, seed=3)
    trunk = trunk[:20]
    engine = _sharing_engine(cfg, params, graphs)
    engine.submit(anchor, max_new_tokens=60)
    first = engine.submit(trunk, max_new_tokens=3)
    while not first.done:
        engine.step()
    assert engine.pool.prefix_stats.registrations == 1
    fork = engine.submit(trunk, max_new_tokens=8)
    return engine, fork


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefix_hit_and_cow_split_into_a_captured_graph(dtype):
    """A prefix hit placed into a captured decode cache and the COW split of
    its shared tail page before the next step: every cache leaf keeps its
    ``data_ptr()``, the index's page is not written, and the step's logits
    from the graph replay equal the eager step's on a copy of the same
    cache. A graph engine and an eager one then give the same streams."""
    _need_card()
    cfg, params = _reduced("gemma-2b", dtype)
    engine, fork = _fork_setup(cfg, params, graphs=True)
    pool = engine.pool
    assert pool._graph is not None
    leaves = _leaf_list(pool.cache)
    ptrs = [t.data_ptr() for t in leaves]
    with torch.inference_mode():
        assert engine._admit() == [fork]
        assert pool.prefix_stats.hits == 1 and fork.prefix_tokens > 0
        slot = pool.slot_req.index(fork)
        entry = int(pool._host_lengths[slot]) // pool.kv_block_size
        shared = int(pool.block_tables[slot, entry])
        assert pool.allocator.is_shared(shared)
        before = [t[:, shared].clone() for t in leaves]
        pool._decode_begin()
        assert pool.prefix_stats.cow_splits == 1
        assert int(pool.block_tables[slot, entry]) != shared
        assert [t.data_ptr() for t in leaves] == ptrs
        saved = [t.clone() for t in leaves]
        pool._graph.replay()
        graph_logits = pool._graph_out[0].clone()
        assert all(torch.equal(t[:, shared], b) for t, b in zip(leaves, before))
        for dst, src in zip(leaves, saved):
            dst.copy_(src)
        eager_logits = pool._decode_fn()[0]
    torch.cuda.synchronize()
    assert torch.equal(graph_logits, eager_logits)
    assert bool(torch.isfinite(graph_logits).all())

    streams = []
    for graphs in (True, False):
        engine, fork = _fork_setup(cfg, params, graphs)
        engine.run_to_completion()
        assert engine.pool.prefix_stats.cow_splits >= 1
        streams.append(fork.output)
    assert streams[0] == streams[1]


@pytest.mark.gpu
def test_cow_guard_is_what_keeps_shared_pages_unwritten():
    """Break the copy-on-write guard on purpose: the fork's first decode
    step then writes its new token into the page the prefix index (and the
    finished request's transcript) shares. With the guard the page is
    split first and stays as it was. The fork continues with another token
    than its parent did (a greedy fork would write the very bytes the page
    holds), so that a write into the shared row shows."""
    _need_card()
    cfg, params = _reduced("gemma-2b", "bfloat16")
    written = {}
    for guard in (True, False):
        engine, fork = _fork_setup(cfg, params, graphs=True)
        pool = engine.pool
        if not guard:
            pool._cow_guard = lambda: None
        with torch.inference_mode():
            engine._admit()
            slot = pool.slot_req.index(fork)
            pool._host_cur_token[slot] = (pool._host_cur_token[slot] + 1) % cfg.vocab_size
            entry = int(pool._host_lengths[slot]) // pool.kv_block_size
            shared = int(pool.block_tables[slot, entry])
            before = [t[:, shared].clone() for t in _leaf_list(pool.cache)]
            pool.decode_once()
        torch.cuda.synchronize()
        written[guard] = not all(torch.equal(t[:, shared], b)
                                 for t, b in zip(_leaf_list(pool.cache), before))
        assert pool.prefix_stats.cow_splits == (1 if guard else 0)
    assert written == {True: False, False: True}


@pytest.mark.gpu
def test_fused_event_replay_equals_serial_on_the_card():
    """A 4-replica reduced gemma-2b fleet (fp32, the reduced config's own
    dtype; one weight set) on the event engine: the batched dispatch (one
    step over a replica bank, its own graph), the tuple dispatch and the
    serial engine replay byte-identically; every decode pool replays its
    own graph at each of its own steps but the first, and kernel 1
    launches layers x (the pools' own steps + the bank steps)."""
    _need_card()
    from repro_torch.core.energy import EnergyModel
    from repro_torch.core.traces import TracedRequest
    from repro_torch.hw import H200_SXM

    cfg, params = _reduced("gemma-2b", "float32")
    spec = FleetSpec(replicas=tuple(
        ReplicaSpec(name=f"r{i}", arch="gemma-2b", clock=ClockSpec(mode="lock"),
                    decode=PoolSpec(batch=2), max_seq_len=64, prefill_chunk_tokens=64)
        for i in range(4)), router="jsq")
    rng = np.random.default_rng(0)
    trace = [TracedRequest(arrival_s=1e-4 * (i % 3), prompt=rng.integers(1, 100, 16)
                           .astype(np.int32), max_new_tokens=6, bucket="mixed")
             for i in range(12)]
    layers = sum(st.n_units * len(st.unit) for st in cfg.stages)
    blobs = {}
    for mode, opts in (("batched", {"fast_path_min": 2}),
                       ("tuple", {"fast_path_min": 2, "batch_replicas": False}),
                       ("serial", {"fast_path_min": 99, "batch_replicas": False})):
        fleet = Fleet.from_spec(spec, emodel=EnergyModel(H200_SXM), params_for={"gemma-2b": params},
                                device="cuda")
        before = {fn.__name__: fn.launches for fn in COUNTED_KERNELS}
        done = sorted(fleet.run_trace(trace, engine_opts=opts), key=lambda r: r.uid)
        torch.cuda.synchronize()
        pools = [r.decode_pool for r in fleet.replicas]
        got = sum(fn.launches - before[fn.__name__] for fn in COUNTED_KERNELS
                  if fn.__name__ == "decode_attention")
        got += sum(p.graph_replays * p.captured_launches.get("decode_attention", 0)
                   for p in pools) + _bank_launches(fleet, "decode_attention")
        assert got == layers * (sum(p._decode_steps_run for p in pools)
                                + _bank_steps(fleet))
        assert all(p._decode_steps_run + p.bank_steps == p.stats.decode_steps
                   and p.graph_replays == max(p._decode_steps_run - 1, 0) for p in pools)
        st = fleet.last_engine_stats
        assert (st.fused_decode_calls > 0) == (mode != "serial")
        assert (_bank_steps(fleet) > 0) == (mode == "batched")
        blobs[mode] = [(r.output, r.ledger.first_token_s, r.ledger.finish_s, r.decode_j)
                       for r in done]
    assert blobs["batched"] == blobs["tuple"] == blobs["serial"]


@pytest.mark.gpu
@pytest.mark.parametrize("k", [4, 16])
def test_fold_of_the_fused_decode(k):
    """The fold measurement on a reduced bf16 gemma-2b: K member caches of
    B = 8 rows stepped as K member steps (what the fused dispatch runs) and
    as one step folded to batch K x B give logits within the bf16
    tolerance; whether they are bitwise equal is what ``chip_smoke.py``
    measures at full width."""
    _need_card()
    cfg, params = _reduced("gemma-2b", "bfloat16")
    b, l = 8, 64
    g = torch.Generator(device="cuda").manual_seed(k)
    cache = init_cache(cfg, k * b, l, device="cuda")
    for t in _leaf_list(cache):
        t.copy_(torch.randn(t.shape, generator=g, device="cuda") * 0.5)
    lengths = torch.randint(1, l - 1, (k * b,), generator=g, device="cuda", dtype=torch.int32)
    tokens = torch.randint(1, cfg.vocab_size, (k * b,), generator=g, device="cuda",
                           dtype=torch.int32)
    members = [[t[:, i * b:(i + 1) * b].clone() for t in _leaf_list(cache)] for i in range(k)]

    def rebuild(flat):
        it = iter(flat)
        return {"stages": [{name: {key: next(it) for key in blk} for name, blk in st.items()}
                           for st in cache["stages"]]}

    with torch.inference_mode():
        folded = decode_step(params, cfg, tokens, cache, lengths)[0]
        member = torch.cat([decode_step(params, cfg, tokens[i * b:(i + 1) * b],
                                        rebuild(members[i]), lengths[i * b:(i + 1) * b])[0]
                            for i in range(k)])
    torch.testing.assert_close(folded, member, rtol=2e-2, atol=2e-2)


# ------------------------------------------- the fleet recipes' fleets on the card
def _bank_steps(fleet):
    """The last replay's replica-bank steps, every config."""
    return sum(e["decode_steps"] for e in (fleet.last_batched_calls or {}).values())


def _bank_launches(fleet, name):
    """``name``'s launches by the last replay's bank graph replays."""
    return sum(e["replay_launches"].get(name, 0)
               for e in (fleet.last_batched_calls or {}).values())


def _decode_launches(fleet, name, before):
    """``name``'s launches since ``before`` across the fleet's decode pools
    and replica banks: eager launches plus graph replays x the launches
    each capture recorded."""
    fn = next(f for f in COUNTED_KERNELS if f.__name__ == name)
    return fn.launches - before + sum(r.decode_pool.graph_replays
                                      * r.decode_pool.captured_launches.get(name, 0)
                                      for r in fleet.replicas) + _bank_launches(fleet, name)


@pytest.mark.gpu
def test_autoscaled_fleet_keeps_graphs_across_power_cycles(monkeypatch):
    """``serve_autoscale``'s fleet (four dense reduced qwen3-4b replicas on
    one weight set, fp32) under its ``schedule`` autoscaler on the smoke
    trace, decode steps within one modelled step of each other fused from
    two members up (the recipe's own options fuse only same-instant steps
    of four, which its trace never lines up): a replica powered down and up
    again replays the graph it captured before (one capture per pool that
    took two steps of its own, every cache leaf of its own at the address
    it had when the replica powered up), fused groups of changing size form
    from the powered members on replica banks, kernel 1 launches layers x
    (the pools' own steps + the bank steps), and the streams equal the
    eager replay's."""
    _need_card()
    from repro_torch.benchmarks import serve_autoscale as sa
    from repro_torch.serving import Replica
    from repro_torch.serving.pool import Pool

    cfg, params = _reduced(sa.ARCH, "float32")
    tbt_s, ttft_s, replica_rps, t_dec = sa.autoscale_targets(sa.h200_model())
    rate = sa.RATE_X * replica_rps
    period_s = 120 / rate / 2.0
    scaler = sa.autoscaler_spec("schedule", t_dec=t_dec, replica_rps=replica_rps,
                                period_s=period_s, tbt_s=tbt_s)
    spec = sa.fleet_spec("schedule", tbt_s, ttft_s, scaler)
    trace = sa.make_trace(120, rate, period_s)
    captures, ups = {}, []
    capture, power_up = Pool._capture, Replica.power_up

    def counted_capture(self, stream):
        captures[id(self)] = captures.get(id(self), 0) + 1
        capture(self, stream)

    def noted_power_up(self, warmup_s=0.0):
        pool = self.decode_pool
        ups.append((self, pool._graph, pool.graph_replays,
                    pool._own_cache is not None
                    and [t.data_ptr() for t in _leaf_list(pool._own_cache)]))
        power_up(self, warmup_s)

    monkeypatch.setattr(Pool, "_capture", counted_capture)
    monkeypatch.setattr(Replica, "power_up", noted_power_up)
    layers = sum(st.n_units * len(st.unit) for st in cfg.stages)
    streams = {}
    for graphs in (True, False):
        fleet = Fleet.from_spec(spec, emodel=sa.h200_model(), params_for={sa.ARCH: params},
                                device="cuda")
        pools = [r.decode_pool for r in fleet.replicas]
        for p in pools:
            p.cuda_graphs = graphs
        ups.clear()
        before = decode_attention.launches
        done = sorted(fleet.run_trace(trace, engine_opts={
            "fast_path_min": 2, "fusion_quantum_s": t_dec, "time_dispatch": True}),
                      key=lambda r: (r.ledger.arrival_s, r.uid))
        torch.cuda.synchronize()
        assert len(done) == 120
        assert _decode_launches(fleet, "decode_attention", before) == layers * (sum(
            p._decode_steps_run for p in pools) + _bank_steps(fleet))
        assert all(p._decode_steps_run + p.bank_steps == p.stats.decode_steps for p in pools)
        st = fleet.last_engine_stats
        assert st.fused_decode_calls > 0 and len(st.fused_decode_wall) >= 2
        assert st.batched_decode_calls == _bank_steps(fleet) > 0
        actions = [e.action for e in fleet.scale_events]
        assert "power_down" in actions and "power_up" in actions
        if graphs:
            assert all(captures.get(id(p), 0) == (p._decode_steps_run >= 2) for p in pools)
            assert all(p.graph_replays == max(p._decode_steps_run - 1, 0) for p in pools)
            rewoken = [(r, g, ptrs) for r, g, n, ptrs in ups
                       if g is not None and r.decode_pool.graph_replays > n]
            assert rewoken
            for r, g, ptrs in rewoken:
                assert r.decode_pool._graph is g
                assert [t.data_ptr() for t in _leaf_list(r.decode_pool._own_cache)] == ptrs
        else:
            assert all(p.graph_replays == 0 and p._graph is None for p in pools)
        streams[graphs] = [(r.replica, r.output) for r in done]
    assert streams[True] == streams[False]


@pytest.mark.gpu
def test_homogeneous_paged_fleet_on_the_card():
    """``serve_fleet``'s GQA monoculture (three paged reduced qwen3-4b
    replicas on one weight set, fp32) behind affinity routing on the smoke
    trace: paged groups are stepped one pool at a time even where fusion is
    allowed from two members (as in the reference's engine), kernel 2
    launches layers x decode steps, and the graph replay's streams equal
    the eager replay's."""
    _need_card()
    from repro_torch.benchmarks import serve_fleet as sf

    cfg, params = _reduced(sf.HOMO_ARCHS[0], "float32")
    tbt_s, ttft_s, rate = sf.fleet_targets(sf.h200_model(), sf.HET_ARCHS)
    spec = sf.fleet_spec(sf.HOMO_ARCHS, "affinity", "lock", tbt_s, ttft_s)
    trace = sf.make_trace(120, rate)
    layers = sum(st.n_units * len(st.unit) for st in cfg.stages)
    streams = {}
    for graphs in (True, False):
        fleet = Fleet.from_spec(spec, emodel=sf.h200_model(),
                                params_for={sf.HOMO_ARCHS[0]: params}, device="cuda")
        for r in fleet.replicas:
            r.decode_pool.cuda_graphs = graphs
        before = paged_decode_attention.launches
        done = sorted(fleet.run_trace(trace, engine_opts={"fast_path_min": 2}),
                      key=lambda r: (r.ledger.arrival_s, r.uid))
        torch.cuda.synchronize()
        assert len(done) == 120 and len({r.replica for r in done}) == 3
        steps = sum(r.decode_stats.decode_steps for r in fleet.replicas)
        assert _decode_launches(fleet, "paged_decode_attention", before) == layers * steps
        st = fleet.last_engine_stats
        assert st.fused_decode_calls == 0 and st.serial_decode_calls == steps
        assert all(r.decode_pool.graph_replays == (max(r.decode_stats.decode_steps - 1, 0)
                                                   if graphs else 0) for r in fleet.replicas)
        streams[graphs] = [(r.replica, r.output) for r in done]
    assert streams[True] == streams[False]


@pytest.mark.gpu
def test_kernels_micro_on_the_card(tmp_path, monkeypatch):
    """``kernels_micro.run`` on the card: each of its four fp32 kernels
    launched (no plain fallback: the counted wrapper's launches rise by
    ``LAUNCHES``), within its tolerance of the plain version, timed with
    CUDA events; the CSV written where ``REPRO_BENCH_OUT`` points."""
    _need_card()
    from repro_torch.benchmarks import kernels_micro as km

    monkeypatch.setenv("REPRO_BENCH_OUT", str(tmp_path))
    before = {name: getattr(km.kmod, c).launches
              for name, (_, _, _, c, _) in km.KERNELS.items()}
    rows = km.run(device="cuda")
    torch.cuda.synchronize()
    assert [r[0] for r in rows] == [v[0] for v in km.KERNELS.values()]
    for (row, us, derived), (name, (_, _, _, counted, tol)) in zip(rows, km.KERNELS.items()):
        fields = dict(kv.split("=", 1) for kv in derived.split(";") if "=" in kv)
        assert fields["ran"] == "cuda" and int(fields["launches"]) == km.LAUNCHES, derived
        assert float(fields["max_abs_err"]) <= tol and us > 0, derived
        assert getattr(km.kmod, counted).launches - before[name] == km.LAUNCHES
    assert (tmp_path / "kernels_micro.csv").read_text().splitlines()[0] == \
        "kernel,kernel_us,ref_us"


# ----------------------------------------------------------------- training
def _train_setup(arch="gemma-2b", dtype="float32", seed=0, batch_size=8, seq_len=64):
    from repro_torch.training import DataConfig, PackedLMStream

    cfg = dataclasses.replace(reduced_config(arch), param_dtype=dtype, compute_dtype=dtype)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(seed), device="cuda")
    stream = PackedLMStream(cfg, DataConfig(seq_len=seq_len, batch_size=batch_size, seed=seed))
    batches = [{k: torch.from_numpy(v).cuda() for k, v in stream.next_batch().items()}
               for _ in range(6)]
    return cfg, params, batches


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_invariants_on_card(dtype):
    """On one batch and the same weights: remat off against on (loss 1e-3,
    grad norm 1e-2 relative), two microbatches against one (loss 1e-3);
    then compressed steps whose losses stay finite and fall, with a finite
    error buffer. No decode or scan kernel is launched."""
    from repro_torch.training import (AdamW, global_norm, init_train_state, make_train_step,
                                      wsd_schedule)
    from repro_torch.training import tree as T
    from repro_torch.training.train import value_and_grad

    _need_card()
    cfg, params, batches = _train_setup(dtype=dtype)
    before = {k: k.launches for k in COUNTED_KERNELS}
    got = {}
    for remat in (True, False):
        loss, grads = value_and_grad(params, cfg, batches[0], remat=remat)
        got[remat] = (loss.item(), global_norm(grads).item())
        assert all(bool(torch.isfinite(g).all()) for g in T.leaves(grads))
    assert got[False][0] == pytest.approx(got[True][0], rel=1e-3)
    assert got[False][1] == pytest.approx(got[True][1], rel=1e-2)
    sched = wsd_schedule(1e-3, 1, 4, 1)
    losses = {}
    for m in (1, 2):
        state = init_train_state(cfg, T.map(torch.clone, params), AdamW())
        losses[m] = make_train_step(cfg, AdamW(), sched, microbatches=m)(state, batches[0])[1]
    assert losses[2]["loss"].item() == pytest.approx(losses[1]["loss"].item(), rel=1e-3)
    step = make_train_step(cfg, AdamW(), sched, compression=True)
    state = init_train_state(cfg, params, AdamW(), compression=True)
    seen = []
    for b in batches:
        state, m = step(state, b)
        seen.append(m["loss"].item())
    assert all(np.isfinite(seen)) and seen[-1] < seen[0]
    assert all(bool(torch.isfinite(e).all()) for e in T.leaves(state.error_buf))
    torch.cuda.synchronize()
    assert {k: k.launches for k in COUNTED_KERNELS} == before


@pytest.mark.gpu
def test_restart_from_checkpoint_on_card(tmp_path):
    """3 steps, a checkpoint, a fresh state restored from it and 3 more,
    against 6 straight steps, fp32: losses within 1e-5 relative and the
    params within 1e-5 (the embedding backward accumulates with atomics,
    so bitwise equality is not asserted)."""
    from repro_torch.training import (AdamW, init_train_state, latest_step, make_train_step,
                                      restore_checkpoint, save_checkpoint, wsd_schedule)
    from repro_torch.training import tree as T

    _need_card()
    cfg, params, batches = _train_setup()
    step = make_train_step(cfg, AdamW(), wsd_schedule(3e-4, 2, 12, 6))

    def fresh(seed):
        return init_train_state(cfg, init_params(cfg, torch.Generator(device="cuda")
                                                 .manual_seed(seed), device="cuda"), AdamW())

    def run(state, bs):
        out = []
        for b in bs:
            state, m = step(state, b)
            out.append(m["loss"].item())
        return state, out

    straight, want = run(fresh(0), batches)
    half, got = run(fresh(0), batches[:3])
    save_checkpoint(str(tmp_path), 3, half)
    restored = restore_checkpoint(str(tmp_path), latest_step(str(tmp_path)), fresh(1))
    assert all(t.device.type == "cuda" for t in T.leaves(restored))
    resumed, more = run(restored, batches[3:])
    np.testing.assert_allclose(got + more, want, rtol=1e-5)
    for a, b in zip(T.leaves(straight.params), T.leaves(resumed.params)):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mamba2-780m", "gdn-4b", "zamba2-1.2b"])
def test_forward_with_grad_refuses_scan_kinds_on_card(arch):
    """A CUDA ``forward`` with grad through the scan kernels trains (the
    name is kept from when the card refused it): ``value_and_grad`` on
    reduced fp32 weights launches the forward scan twice per recurrent
    layer (the forward and the remat recompute) and its backward kernel
    once, and every leaf's gradient is within 2e-4 of its largest entry of
    the same step on CPU copies of the weights, which run the twins;
    under ``torch.no_grad`` the forward scan alone, once per recurrent
    layer."""
    from repro_torch.kernels import gdn_scan_bwd, ssd_scan_bwd
    from repro_torch.models import forward
    from repro_torch.training import tree as T
    from repro_torch.training.train import value_and_grad

    _need_card()
    cfg, params, batches = _train_setup(arch, batch_size=2, seq_len=80)
    kernel, bwd = (gdn_scan, gdn_scan_bwd) if arch == "gdn-4b" else (ssd_scan, ssd_scan_bwd)
    layers = sum(stage.n_units * sum(k in SCAN_KINDS for k in stage.unit)
                 for stage in cfg.stages)
    before = {k: k.launches for k in COUNTED_KERNELS}
    loss, grads = value_and_grad(params, cfg, batches[0])
    torch.cuda.synchronize()
    after = {k: k.launches - before[k] for k in COUNTED_KERNELS}
    assert after == {k: {kernel: 2 * layers, bwd: layers}.get(k, 0) for k in COUNTED_KERNELS}
    cpu = T.map(lambda t: t.detach().cpu(), params)
    closs, cgrads = value_and_grad(cpu, cfg, {k: v.cpu() for k, v in batches[0].items()})
    assert loss.item() == pytest.approx(closs.item(), rel=2e-4)
    for path, g, c in zip(T.paths(grads), T.leaves(grads), T.leaves(cgrads)):
        scale = c.abs().max().item()
        assert scale > 0, path
        assert (g.cpu() - c).abs().max().item() <= 2e-4 * scale, path
    toks = batches[0]["inputs"]
    with torch.no_grad():
        h = forward(params, cfg, toks)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(h).all())
    assert kernel.launches - before[kernel] == 3 * layers


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,shape", [
    ("ssd", (2, 128, 4, 32, 16)),       # reduced mamba2-780m
    ("ssd", (1, 256, 8, 64, 64)),       # zamba2-1.2b's N
    ("gdn", (2, 64, 2, 16)),            # reduced gdn-4b
    ("gdn", (1, 96, 4, 128)),           # gdn-4b's head dim
])
def test_scan_bwd_kernels_match_twins(kind, shape, dtype):
    """The backward kernels against their plain twins on the same inputs,
    with and without the final state's cotangent: each gradient in its
    input's dtype and within 2e-4 (fp32) / 2e-2 (bf16, the gradients are
    returned in bf16) of the twin's largest entry; two calls bitwise
    equal."""
    from repro_torch.kernels import gdn_scan_bwd, gdn_scan_bwd_ref, ssd_scan_bwd, \
        ssd_scan_bwd_ref

    _need_card()
    if kind == "ssd":
        inputs, kernel, twin = _ssd_inputs(dtype, *shape), ssd_scan_bwd, ssd_scan_bwd_ref
        state = (shape[0], shape[2], shape[3], shape[4])
    else:
        inputs, kernel, twin = _gdn_inputs(dtype, *shape), gdn_scan_bwd, gdn_scan_bwd_ref
        state = (shape[0], shape[2], shape[3], shape[3])
    g = torch.Generator(device="cuda").manual_seed(9)
    dy = torch.randn(inputs[0].shape, generator=g, device="cuda").to(dtype)
    dfinal = torch.randn(state, generator=g, device="cuda")
    rtol = 2e-4 if dtype == torch.float32 else 2e-2
    before = kernel.launches
    for df in (None, dfinal):
        got = kernel(*inputs, dy, df)
        again = kernel(*inputs, dy, df)
        want = twin(*inputs, dy, df)
        torch.cuda.synchronize()
        assert [t.dtype for t in got] == [t.dtype for t in inputs]
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        for a, w in zip(got, want):
            assert (a.float() - w).abs().max().item() <= rtol * w.abs().max().item()
    assert kernel.launches - before == 4
