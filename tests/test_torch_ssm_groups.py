"""``ssm_groups > 1`` in the port against the JAX package, on the CPU.

The reference's jnp SSM takes G groups of B/C, head h reading group
``h // (H / G)`` (``repro.models.ssm.ssd_chunked``'s ``rep``). The port
scans them with the plain version here (each head reading its group's
row) and with kernel 3 and its backward on a card (each CTA loading its
own head's group; ``tests/test_torch_gpu.py``):

* reduced mamba2-780m with ``ssm_groups=2`` (the config made here with
  ``dataclasses.replace``): ``prefill`` and greedy ``decode_step`` against
  ``repro.models`` at fp32 1e-4, the greedy tokens equal;
* the ``SsdScan`` gradients (``ssd_prefill`` under autograd) against
  ``jax.grad`` of the reference's ``ssd_chunked`` with G = 2 and G = 4;
* the plain twins of the backward (``ssd_scan_bwd_ref`` and the chunked
  form) on grouped b / c against each other, with db and dc per group;
* the work counts of ``kernels/cost.py`` with G groups.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as R
from repro.configs import reduced_config as jax_reduced_config
from repro.models import ssm as jax_ssm
import repro_torch.models as T
from repro_torch.configs import reduced_config
from repro_torch.kernels import cost, ssd_prefill
from repro_torch.kernels.ssd.ref import ssd_scan_bwd_chunked_ref, ssd_scan_bwd_ref, ssd_scan_ref

ARCH = "mamba2-780m"
TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_RTOL = 2e-4
NAMES = ("x", "dt", "a", "b", "c")


def _configs(groups):
    return (dataclasses.replace(jax_reduced_config(ARCH), ssm_groups=groups),
            dataclasses.replace(reduced_config(ARCH), ssm_groups=groups))


def _inputs(seed, b, s, h, p, g, n):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, s, h, p)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = (-np.exp(np.linspace(-2, 0.5, h))).astype(np.float32)
    bm = (rng.standard_normal((b, s, g, n)) * 0.3).astype(np.float32)
    cm = (rng.standard_normal((b, s, g, n)) * 0.3).astype(np.float32)
    dy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dfinal = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return (x, dt, a, bm, cm), dy, dfinal


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("groups", [2])
def test_grouped_model_prefill_and_decode_match_the_reference(groups):
    """Reduced mamba2-780m, ``ssm_groups=2``: logits within fp32 1e-4 over
    a ragged prefill and four greedy decode steps, the tokens equal, the
    final SSM states within 1e-4."""
    jcfg, cfg = _configs(groups)
    assert cfg.ssm_heads % groups == 0 and cfg.ssm_heads > groups
    jp = R.init_params(jcfg, jax.random.PRNGKey(0))
    tp = T.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    rng = np.random.default_rng(1)
    toks = rng.integers(1, cfg.vocab_size, (2, 40)).astype(np.int32)
    plens = np.array([17, 40], np.int32)
    jl, jc, jlen = R.prefill(jp, jcfg, jnp.asarray(toks), R.init_cache(jcfg, 2, 64),
                             prompt_lengths=jnp.asarray(plens))
    tl, tc, tlen = T.prefill(tp, cfg, torch.from_numpy(toks), T.init_cache(cfg, 2, 64, device="cpu"),
                             prompt_lengths=torch.from_numpy(plens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    jtok = jnp.argmax(jl, -1).astype(jnp.int32)
    ttok = torch.argmax(tl, -1).to(torch.int32)
    for _ in range(4):
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        jl, jc, jlen = R.decode_step(jp, jcfg, jtok, jc, jlen)
        tl, tc, tlen = T.decode_step(tp, cfg, ttok, tc, tlen)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        jtok = jnp.argmax(jl, -1).astype(jnp.int32)
        ttok = torch.argmax(tl, -1).to(torch.int32)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    jstate = np.asarray(jc["stages"][0]["b0"]["ssm"])
    np.testing.assert_allclose(tc["stages"][0]["b0"]["ssm"].numpy(), jstate, **TOL)


@pytest.mark.parametrize("with_dfinal", [False, True])
@pytest.mark.parametrize("b,s,h,p,g,n", [
    (2, 64, 4, 8, 2, 16),       # on the kernel's chunk
    (1, 100, 8, 16, 4, 8),      # off it: ssd_prefill pads, autograd slices back
    (1, 70, 6, 8, 2, 16),       # three heads a group
])
def test_ssd_function_matches_jax_grad_of_grouped_ssd_chunked(b, s, h, p, g, n, with_dfinal):
    """``SsdScan``'s gradients of every input, b and c per group, within
    2e-4 (of each gradient's largest entry) of ``jax.grad`` through the
    reference's ``ssd_chunked`` on the same grouped inputs."""
    inputs, dy, dfinal = _inputs(11 + s + g, b, s, h, p, g, n)

    def jloss(*t):
        y, fs = jax_ssm.ssd_chunked(*t, chunk=16)
        out = (y * dy).sum()
        return out + (fs * dfinal).sum() if with_dfinal else out

    want = jax.grad(jloss, argnums=tuple(range(5)))(*(jnp.asarray(t) for t in inputs))
    leaves = [torch.from_numpy(t).requires_grad_(True) for t in inputs]
    y, fs = ssd_prefill(*leaves)
    loss = (y * torch.from_numpy(dy)).sum()
    if with_dfinal:
        loss = loss + (fs * torch.from_numpy(dfinal)).sum()
    got = torch.autograd.grad(loss, leaves)
    for name, gr, w in zip(NAMES, got, want):
        assert _rel(gr.numpy(), w) <= GRAD_RTOL, name


def test_grouped_plain_scan_is_the_per_head_scan():
    """The twin's G groups are the one-group scan over each head with its
    group's b and c (within 1e-6), and equal the reference's forward."""
    inputs, _, _ = _inputs(5, 2, 40, 6, 8, 3, 16)
    x, dt, a, bm, cm = (torch.from_numpy(t) for t in inputs)
    y, fs = ssd_scan_ref(x, dt, a, bm, cm)
    for hh in range(6):
        yh, fh = ssd_scan_ref(x[:, :, hh:hh + 1], dt[:, :, hh:hh + 1], a[hh:hh + 1],
                              bm[:, :, hh // 2], cm[:, :, hh // 2])
        torch.testing.assert_close(y[:, :, hh:hh + 1], yh, rtol=0, atol=1e-6)
        torch.testing.assert_close(fs[:, hh:hh + 1], fh, rtol=0, atol=1e-6)
    jy, jfs = jax_ssm.ssd_chunked(*(jnp.asarray(t) for t in inputs), chunk=16)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(fs.numpy(), np.asarray(jfs), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("bf16", [False, True])
def test_grouped_backward_twins_agree(bf16):
    """The reverse scan and the kernel's chunked closed form on grouped b /
    c: db and dc come per group, the two forms within fp32 2e-4 (bf16
    rounding points: 2e-2)."""
    inputs, dy, dfinal = _inputs(9, 2, 90, 4, 8, 2, 16)
    t = [torch.from_numpy(v) for v in (*inputs, dy, dfinal)]
    twin = ssd_scan_bwd_ref(*t)
    chunked = ssd_scan_bwd_chunked_ref(*t, bf16=bf16)
    assert twin[3].shape == twin[4].shape == (2, 90, 2, 16)
    for name, u, v in zip(NAMES, chunked, twin):
        assert _rel(u.numpy(), v.numpy()) <= (2e-2 if bf16 else 2e-4), name


def test_grouped_work_counts():
    """``cost.ssd_scan`` / ``ssd_scan_bwd`` read G groups of b and c: G = 1
    is the old count, and each more group adds its b / c bytes and c.b
    products."""
    one, eight = cost.ssd_scan(1, 512, 80, 64, 128, 2), cost.ssd_scan(1, 512, 80, 64, 128, 2, g=8)
    assert eight.bytes - one.bytes == 7 * 2 * 512 * 128 * 2
    assert eight.ops - one.ops == 7 * 512 * 2 * cost.SCAN_CHUNK * 128
    bone, beight = (cost.ssd_scan_bwd(1, 512, 80, 64, 128, 2, g=g) for g in (1, 8))
    assert beight.bytes - bone.bytes == 7 * 4 * 512 * 128 * 2
    assert beight.ops == 3 * eight.ops
