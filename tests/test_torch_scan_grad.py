"""The gradients of the port's two scans (kernels 3 and 6) on the CPU.

The scans run through the autograd Functions ``SsdScan`` and ``GdnScan``:
on a CUDA tensor their backward is a CUDA kernel, on a CPU tensor its plain
twin (``ssd_scan_bwd_ref`` / ``gdn_scan_bwd_ref``), the reverse scan that
this file holds. Inputs come from numpy with a seed, fp32 throughout.

* The twins against ``torch.autograd`` through ``ssd_scan_ref`` and
  ``gdn_scan_ref``, with the final state's cotangent absent and present, at
  S on and off the kernels' chunks: the same fp32 recurrence differentiated
  two ways, each gradient within ``TWIN_RTOL`` (1e-5) of its largest entry.
* ``ssd_prefill`` / ``gdn_prefill`` (padding to the chunk, then the
  Functions) against ``jax.grad`` of the reference's jnp scans
  ``repro.models.ssm.ssd_chunked`` and ``repro.models.gdn.gdn_scan`` on the
  same inputs and cotangents: the SSD pair at the SSD scans' tolerance 2e-4
  (the reference differentiates the chunked form, the port the sequential
  one: the same math summed in another order), the GDN pair at 1e-5 (both
  sequential). Each gradient is held relative to its largest entry.
* ``ssd_scan_bwd_chunked_ref``, the per-chunk closed form that the
  backward kernel evaluates, on the SSD shapes above with the cotangent
  absent and present: in fp32 against the twin and against ``jax.grad`` of
  ``ssd_chunked`` (at the port's chunk), both at ``SSD_JAX_RTOL`` (the
  closed form's fp32 sums cancel: its da is ~1e-5 of max |da| from the
  float64 answer where the twin's is ~1e-6); with the
  bf16 kernel's rounding points against the twin at ``SSD_BF16_RTOL``
  (2e-2, the bf16 tolerance of ``chip_smoke.py``'s phase 3), on inputs
  that are bf16 already, as the kernel receives them.
* ``gdn_scan_bwd_chunked_ref``, the chunked (WY) form that the GDN backward
  kernels evaluate, on and off several chunks with the cotangent absent and
  present: in fp32 against the twin and against ``jax.grad`` of
  ``gdn_scan`` at ``GDN_JAX_RTOL``; with the kernels' products
  (``rounding="f16x3"``, fp16 hi + lo operands) against the twin at
  ``GDN_F16X3_RTOL`` (2e-4, the fp32 tolerance of ``chip_smoke.py``'s phase
  3), also with cotangents of 1e-5 (the scale ``cotangent_scale`` keeps the
  splits in fp16's normal range); with the bf16 path's rounding points on
  bf16 inputs at ``GDN_BF16_RTOL`` (2e-2); dalpha zero below the floor.
* The Functions' ``needs_input_grad`` handling (a gradient no input needs
  comes back as None, and none is computed without a cotangent), the
  missing ``dy``, ``torch.no_grad`` (no graph, the forward alone), the
  dtypes of the returned gradients, the wrappers' contract and the CPU
  path's launch counts (none).
The per-leaf ``jax.grad`` parity of whole reduced mamba2-780m, gdn-4b and
zamba2-1.2b through remat is in ``tests/test_torch_training.py``; the
kernels themselves run only on a card (``tests/test_torch_gpu.py``,
``chip_smoke.py``).
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import gdn as jax_gdn
from repro.models import ssm as jax_ssm
from repro_torch.kernels import (
    gdn_prefill,
    gdn_scan,
    gdn_scan_bwd,
    gdn_scan_bwd_ref,
    gdn_scan_ref,
    ssd_prefill,
    ssd_scan,
    ssd_scan_bwd,
    ssd_scan_bwd_ref,
    ssd_scan_ref,
)
from repro_torch.kernels.gdn.gdn import CHUNK as GDN_CHUNK
from repro_torch.kernels.gdn.gdn import GdnScan
from repro_torch.kernels.gdn.ref import ALPHA_MIN, cotangent_scale, gdn_scan_bwd_chunked_ref
from repro_torch.kernels.ssd.ref import ssd_scan_bwd_chunked_ref
from repro_torch.kernels.ssd.ssd import CHUNK as SSD_CHUNK
from repro_torch.kernels.ssd.ssd import SsdScan

TWIN_RTOL = 1e-5
SSD_JAX_RTOL = 2e-4
SSD_BF16_RTOL = 2e-2
GDN_JAX_RTOL = 1e-5
GDN_F16X3_RTOL = 2e-4
GDN_BF16_RTOL = 2e-2
SSD_NAMES = ("x", "dt", "a", "b", "c")
GDN_NAMES = ("q", "k", "v", "beta", "alpha")


def _ssd_inputs(seed, b, s, h, p, n):
    """x, dt, a, b, c and the cotangents dy, dfinal, as numpy fp32."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, s, h, p)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)   # softplus
    a = (-np.exp(np.linspace(-2, 0.5, h))).astype(np.float32)
    bm = (rng.standard_normal((b, s, n)) * 0.3).astype(np.float32)
    cm = (rng.standard_normal((b, s, n)) * 0.3).astype(np.float32)
    dy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dfinal = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return (x, dt, a, bm, cm), dy, dfinal


def _gdn_inputs(seed, b, s, h, k):
    """q, k, v, beta, alpha (unit-norm q and k, as the model's L2 norm makes
    them) and the cotangents dy, dfinal, as numpy fp32."""
    rng = np.random.default_rng(seed)
    unit = lambda t: t / np.linalg.norm(t, axis=-1, keepdims=True)
    q = unit(rng.standard_normal((b, s, h, k))).astype(np.float32)
    kk = unit(rng.standard_normal((b, s, h, k))).astype(np.float32)
    v = (rng.standard_normal((b, s, h, k)) * 0.5).astype(np.float32)
    beta = (1 / (1 + np.exp(-rng.standard_normal((b, s, h))))).astype(np.float32)
    alpha = (1 / (1 + np.exp(-rng.standard_normal((b, s, h)) - 2))).astype(np.float32)
    dy = rng.standard_normal((b, s, h, k)).astype(np.float32)
    dfinal = rng.standard_normal((b, h, k, k)).astype(np.float32)
    return (q, kk, v, beta, alpha), dy, dfinal


def _t(arrays, grad=False):
    return [torch.from_numpy(a).requires_grad_(grad) for a in arrays]


def _assert_rel(got, want, rtol, what):
    """max |got - want| within rtol of max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, f"{what}: shape {got.shape} != {want.shape}"
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert scale > 0, f"{what}: the reference gradient is zero"
    assert err <= rtol * scale, f"{what}: max |diff| {err:.3e} > {rtol} x {scale:.3e}"


def _autograd(fn, inputs, dy, dfinal):
    """torch.autograd's gradients of <y, dy> + <final, dfinal> through fn."""
    leaves = _t(inputs, grad=True)
    y, fs = fn(*leaves)
    loss = (y * torch.from_numpy(dy)).sum()
    if dfinal is not None:
        loss = loss + (fs * torch.from_numpy(dfinal)).sum()
    return [g.numpy() for g in torch.autograd.grad(loss, leaves)]


# ------------------------------------------------------- twins vs autograd
SSD_TWIN_SHAPES = [
    (2, 64, 3, 8, 16),          # one kernel chunk
    (1, 37, 2, 16, 8),          # off the chunk
    (2, 130, 2, 8, 4),          # a few chunks, ragged
]
SSD_JAX_SHAPES = [
    (2, SSD_CHUNK, 4, 8, 16),   # on the port's chunk
    (1, 100, 3, 16, 8),         # off it: ssd_prefill pads, autograd slices back
]


@pytest.mark.parametrize("with_dfinal", [False, True])
@pytest.mark.parametrize("b,s,h,p,n", SSD_TWIN_SHAPES)
def test_ssd_twin_matches_autograd_of_plain_scan(b, s, h, p, n, with_dfinal):
    inputs, dy, dfinal = _ssd_inputs(b * 1000 + s, b, s, h, p, n)
    df = dfinal if with_dfinal else None
    want = _autograd(ssd_scan_ref, inputs, dy, df)
    got = ssd_scan_bwd_ref(*_t(inputs), torch.from_numpy(dy),
                           None if df is None else torch.from_numpy(df))
    for name, g, w in zip(SSD_NAMES, got, want):
        assert g.dtype == torch.float32
        _assert_rel(g.numpy(), w, TWIN_RTOL, f"d{name}")


@pytest.mark.parametrize("with_dfinal", [False, True])
@pytest.mark.parametrize("b,s,h,k", [
    (2, 32, 3, 8),              # one kernel chunk
    (1, 21, 2, 16),             # off the chunk
    (2, 70, 2, 4),              # a few chunks, ragged
])
def test_gdn_twin_matches_autograd_of_plain_scan(b, s, h, k, with_dfinal):
    inputs, dy, dfinal = _gdn_inputs(b * 1000 + s, b, s, h, k)
    df = dfinal if with_dfinal else None
    want = _autograd(gdn_scan_ref, inputs, dy, df)
    got = gdn_scan_bwd_ref(*_t(inputs), torch.from_numpy(dy),
                           None if df is None else torch.from_numpy(df))
    for name, g, w in zip(GDN_NAMES, got, want):
        assert g.dtype == torch.float32
        _assert_rel(g.numpy(), w, TWIN_RTOL, f"d{name}")


def test_gdn_twin_gives_no_dalpha_below_the_floor():
    """Where the kernels floor log(alpha) at -80, alpha's gradient is the
    floor's: 0; the other gradients run the recurrence at the floor."""
    inputs, dy, dfinal = _gdn_inputs(5, 1, 16, 2, 8)
    alpha = inputs[4].copy()
    alpha[0, 3, 1] = 0.0
    alpha[0, 9, 0] = ALPHA_MIN / 4
    floored = (inputs[0], inputs[1], inputs[2], inputs[3], alpha)
    at_floor = alpha.copy()
    at_floor[alpha < ALPHA_MIN] = ALPHA_MIN
    got = gdn_scan_bwd_ref(*_t(floored), torch.from_numpy(dy), torch.from_numpy(dfinal))
    want = _autograd(gdn_scan_ref, (*inputs[:4], at_floor), dy, dfinal)
    dalpha = got[4].numpy()
    assert dalpha[0, 3, 1] == 0.0 and dalpha[0, 9, 0] == 0.0
    want[4][alpha < ALPHA_MIN] = 0.0
    for name, g, w in zip(GDN_NAMES, got, want):
        _assert_rel(g.numpy(), w, TWIN_RTOL, f"d{name}")


# ------------------------------------------- the Functions vs jax.grad
@pytest.mark.parametrize("with_dfinal", [False, True])
@pytest.mark.parametrize("b,s,h,p,n", SSD_JAX_SHAPES)
def test_ssd_function_matches_jax_grad_of_ssd_chunked(b, s, h, p, n, with_dfinal):
    inputs, dy, dfinal = _ssd_inputs(7 + s, b, s, h, p, n)
    x, dt, a, bm, cm = inputs

    def jloss(x, dt, a, bm, cm):
        y, fs = jax_ssm.ssd_chunked(x, dt, a, bm[:, :, None], cm[:, :, None], chunk=16)
        out = (y * dy).sum()
        return out + (fs * dfinal).sum() if with_dfinal else out

    want = jax.grad(jloss, argnums=tuple(range(5)))(*(jnp.asarray(t) for t in inputs))
    got = _autograd(lambda *t: ssd_prefill(*t), inputs, dy, dfinal if with_dfinal else None)
    for name, g, w in zip(SSD_NAMES, got, want):
        _assert_rel(g, np.asarray(w), SSD_JAX_RTOL, f"d{name}")


@pytest.mark.parametrize("with_dfinal", [False, True])
@pytest.mark.parametrize("b,s,h,k", [
    (2, GDN_CHUNK, 3, 8),       # on the port's chunk
    (1, 45, 2, 16),             # off it: gdn_prefill pads, autograd slices back
])
def test_gdn_function_matches_jax_grad_of_gdn_scan(b, s, h, k, with_dfinal):
    inputs, dy, dfinal = _gdn_inputs(11 + s, b, s, h, k)

    def jloss(q, kk, v, beta, alpha):
        y, fs = jax_gdn.gdn_scan(q, kk, v, beta, alpha)
        out = (y * dy).sum()
        return out + (fs * dfinal).sum() if with_dfinal else out

    want = jax.grad(jloss, argnums=tuple(range(5)))(*(jnp.asarray(t) for t in inputs))
    got = _autograd(lambda *t: gdn_prefill(*t), inputs, dy, dfinal if with_dfinal else None)
    for name, g, w in zip(GDN_NAMES, got, want):
        _assert_rel(g, np.asarray(w), GDN_JAX_RTOL, f"d{name}")


# ------------------------------- the kernel's closed form, in plain torch
def _chunked_case(b, s, h, p, n, with_dfinal):
    inputs, dy, dfinal = _ssd_inputs(b * 1000 + s + 17, b, s, h, p, n)
    return inputs, dy, dfinal if with_dfinal else None


def _twin(inputs, dy, df):
    return ssd_scan_bwd_ref(*_t(inputs), torch.from_numpy(dy),
                            None if df is None else torch.from_numpy(df))


def _chunked(inputs, dy, df, bf16=False):
    return ssd_scan_bwd_chunked_ref(*_t(inputs), torch.from_numpy(dy),
                                    None if df is None else torch.from_numpy(df), bf16=bf16)


@pytest.mark.parametrize("with_dfinal", [False, True])
@pytest.mark.parametrize("b,s,h,p,n", SSD_TWIN_SHAPES + SSD_JAX_SHAPES)
def test_ssd_chunked_form_matches_the_twin(b, s, h, p, n, with_dfinal):
    inputs, dy, df = _chunked_case(b, s, h, p, n, with_dfinal)
    for name, g, w in zip(SSD_NAMES, _chunked(inputs, dy, df), _twin(inputs, dy, df)):
        assert g.dtype == torch.float32
        _assert_rel(g.numpy(), w.numpy(), SSD_JAX_RTOL, f"d{name}")


@pytest.mark.parametrize("with_dfinal", [False, True])
@pytest.mark.parametrize("b,s,h,p,n", SSD_TWIN_SHAPES + SSD_JAX_SHAPES)
def test_ssd_chunked_form_matches_jax_grad_of_ssd_chunked(b, s, h, p, n, with_dfinal):
    inputs, dy, df = _chunked_case(b, s, h, p, n, with_dfinal)

    def jloss(x, dt, a, bm, cm):
        y, fs = jax_ssm.ssd_chunked(x, dt, a, bm[:, :, None], cm[:, :, None], chunk=SSD_CHUNK)
        out = (y * dy).sum()
        return out if df is None else out + (fs * df).sum()

    want = jax.grad(jloss, argnums=tuple(range(5)))(*(jnp.asarray(t) for t in inputs))
    for name, g, w in zip(SSD_NAMES, _chunked(inputs, dy, df), want):
        _assert_rel(g.numpy(), np.asarray(w), SSD_JAX_RTOL, f"d{name}")


@pytest.mark.parametrize("with_dfinal", [False, True])
@pytest.mark.parametrize("b,s,h,p,n", SSD_TWIN_SHAPES + SSD_JAX_SHAPES)
def test_ssd_chunked_form_with_bf16_rounding_holds_the_bf16_tolerance(b, s, h, p, n,
                                                                      with_dfinal):
    inputs, dy, df = _chunked_case(b, s, h, p, n, with_dfinal)
    to_bf16 = lambda t: torch.from_numpy(t).bfloat16().float().numpy()
    x, dt, a, bm, cm = inputs
    inputs, dy = (to_bf16(x), dt, a, to_bf16(bm), to_bf16(cm)), to_bf16(dy)
    got = _chunked(inputs, dy, df, bf16=True)
    exact = _chunked(inputs, dy, df)
    for name, g, w in zip(SSD_NAMES, got, _twin(inputs, dy, df)):
        _assert_rel(g.numpy(), w.numpy(), SSD_BF16_RTOL, f"d{name}")
    assert not all(torch.equal(g, e) for g, e in zip(got, exact)), "bf16 rounded nothing"


# ------------------------- the GDN kernels' chunked form, in plain torch
GDN_CHUNKED_SHAPES = [
    (2, GDN_CHUNK, 3, 8),       # one kernel chunk
    (1, 45, 2, 16),             # off the chunk: padded with beta = 0, alpha = 1 rows
    (2, 96, 2, 16),             # three chunks
    (1, 128, 2, 32),            # four chunks, K 32
]


def _gdn_chunked_case(b, s, h, k, with_dfinal, dscale=1.0):
    inputs, dy, dfinal = _gdn_inputs(b * 1000 + s + 29, b, s, h, k)
    return inputs, dy * dscale, (dfinal * dscale if with_dfinal else None)


def _gdn_twin(inputs, dy, df):
    return gdn_scan_bwd_ref(*_t(inputs), torch.from_numpy(dy),
                            None if df is None else torch.from_numpy(df))


def _gdn_chunked(inputs, dy, df, rounding=None):
    return gdn_scan_bwd_chunked_ref(*_t(inputs), torch.from_numpy(dy),
                                    None if df is None else torch.from_numpy(df),
                                    rounding=rounding)


@pytest.mark.parametrize("with_dfinal", [False, True])
@pytest.mark.parametrize("b,s,h,k", GDN_CHUNKED_SHAPES)
def test_gdn_chunked_form_matches_the_twin(b, s, h, k, with_dfinal):
    inputs, dy, df = _gdn_chunked_case(b, s, h, k, with_dfinal)
    got = _gdn_chunked(inputs, dy, df)
    for name, g, w, t in zip(GDN_NAMES, got, _gdn_twin(inputs, dy, df), inputs):
        assert g.dtype == torch.float32 and g.shape == t.shape
        _assert_rel(g.numpy(), w.numpy(), GDN_JAX_RTOL, f"d{name}")


@pytest.mark.parametrize("with_dfinal", [False, True])
@pytest.mark.parametrize("b,s,h,k", GDN_CHUNKED_SHAPES)
def test_gdn_chunked_form_matches_jax_grad_of_gdn_scan(b, s, h, k, with_dfinal):
    inputs, dy, df = _gdn_chunked_case(b, s, h, k, with_dfinal)

    def jloss(q, kk, v, beta, alpha):
        y, fs = jax_gdn.gdn_scan(q, kk, v, beta, alpha)
        out = (y * dy).sum()
        return out if df is None else out + (fs * df).sum()

    want = jax.grad(jloss, argnums=tuple(range(5)))(*(jnp.asarray(t) for t in inputs))
    for name, g, w in zip(GDN_NAMES, _gdn_chunked(inputs, dy, df), want):
        _assert_rel(g.numpy(), np.asarray(w), GDN_JAX_RTOL, f"d{name}")


@pytest.mark.parametrize("dscale", [1.0, 1e-5])
@pytest.mark.parametrize("with_dfinal", [False, True])
@pytest.mark.parametrize("b,s,h,k", GDN_CHUNKED_SHAPES)
def test_gdn_chunked_form_with_f16x3_products_holds_the_fp32_tolerance(b, s, h, k, with_dfinal,
                                                                       dscale):
    """Every product on fp16 hi + lo operands, as the kernels take them, at
    unit cotangents and at training's small ones."""
    inputs, dy, df = _gdn_chunked_case(b, s, h, k, with_dfinal, dscale)
    got = _gdn_chunked(inputs, dy, df, rounding="f16x3")
    exact = _gdn_chunked(inputs, dy, df)
    for name, g, w in zip(GDN_NAMES, got, _gdn_twin(inputs, dy, df)):
        _assert_rel(g.numpy(), w.numpy(), GDN_F16X3_RTOL, f"d{name}")
    assert not all(torch.equal(g, e) for g, e in zip(got, exact)), "f16x3 rounded nothing"


@pytest.mark.parametrize("with_dfinal", [False, True])
@pytest.mark.parametrize("b,s,h,k", GDN_CHUNKED_SHAPES)
def test_gdn_chunked_form_with_bf16_rounding_holds_the_bf16_tolerance(b, s, h, k, with_dfinal):
    """The kernels' path for bf16 inputs: q, k, v and dy bf16 already, the
    same products, dq, dk and dv written in bf16."""
    inputs, dy, df = _gdn_chunked_case(b, s, h, k, with_dfinal)
    to_bf16 = lambda t: torch.from_numpy(t).bfloat16().float().numpy()
    q, kk, v, beta, alpha = inputs
    inputs, dy = (to_bf16(q), to_bf16(kk), to_bf16(v), beta, alpha), to_bf16(dy)
    got = _gdn_chunked(inputs, dy, df, rounding="bf16")
    exact = _gdn_chunked(inputs, dy, df)
    for name, g, w in zip(GDN_NAMES, got, _gdn_twin(inputs, dy, df)):
        _assert_rel(g.numpy(), w.numpy(), GDN_BF16_RTOL, f"d{name}")
    assert not all(torch.equal(g, e) for g, e in zip(got, exact)), "bf16 rounded nothing"


@pytest.mark.parametrize("rounding", [None, "f16x3"])
def test_gdn_chunked_form_gives_no_dalpha_below_the_floor(rounding):
    inputs, dy, dfinal = _gdn_inputs(6, 1, 64, 2, 8)
    alpha = inputs[4].copy()
    alpha[0, 3, 1] = 0.0
    alpha[0, 40, 0] = ALPHA_MIN / 4
    floored = (*inputs[:4], alpha)
    got = _gdn_chunked(floored, dy, dfinal, rounding)
    dalpha = got[4].numpy()
    assert dalpha[0, 3, 1] == 0.0 and dalpha[0, 40, 0] == 0.0
    tol = GDN_JAX_RTOL if rounding is None else GDN_F16X3_RTOL
    for name, g, w in zip(GDN_NAMES, got, _gdn_twin(floored, dy, dfinal)):
        assert np.isfinite(g.numpy()).all()
        _assert_rel(g.numpy(), w.numpy(), tol, f"d{name}")


def test_gdn_cotangent_scale_is_a_power_of_two_into_half_one():
    dy = torch.zeros(2, 4, 3, 8)
    dy[0, 1, 0, 2] = 3.0e-6
    dy[0, 2, 1, 5] = -0.75
    dy[1, 0, 2, 0] = 1024.0
    scale = cotangent_scale(dy, None)
    assert scale.shape == (2, 3)
    m = dy.abs().amax(dim=(1, 3))
    for (b, h), sc in np.ndenumerate(scale.numpy()):
        if m[b, h] == 0:
            assert sc == 1.0
        else:
            assert 0.5 <= m[b, h] * sc < 1.0 and np.log2(sc) == np.round(np.log2(sc))
    dfinal = torch.zeros(2, 3, 8, 8)
    dfinal[1, 1, 2, 3] = 2.0
    assert cotangent_scale(dy, dfinal)[1, 1] == 0.25


# ------------------------------------------------ the Functions' plumbing
def _padded(kind):
    """Inputs on the kernels' chunk, as the Functions receive them."""
    if kind == "ssd":
        inputs, dy, dfinal = _ssd_inputs(3, 2, SSD_CHUNK, 2, 8, 4)
        return SsdScan, ssd_scan, ssd_scan_bwd, inputs, dy, dfinal
    inputs, dy, dfinal = _gdn_inputs(3, 2, GDN_CHUNK, 2, 8)
    return GdnScan, gdn_scan, gdn_scan_bwd, inputs, dy, dfinal


@pytest.mark.parametrize("kind", ["ssd", "gdn"])
@pytest.mark.parametrize("needed", [0, 2, 4])
def test_function_honours_needs_input_grad(kind, needed):
    """The backward returns a gradient only where an input needs one, each
    equal to the twin's."""
    fn, _, bwd, inputs, dy, dfinal = _padded(kind)
    need = tuple(i == needed for i in range(5))
    ctx = SimpleNamespace(needs_input_grad=need, saved_tensors=tuple(_t(inputs)))
    out = fn.backward(ctx, torch.from_numpy(dy), torch.from_numpy(dfinal))
    want = bwd(*_t(inputs), torch.from_numpy(dy), torch.from_numpy(dfinal))
    assert [g is not None for g in out] == list(need)
    torch.testing.assert_close(out[needed], want[needed], rtol=0, atol=0)
    # through autograd: the one leaf that requires grad gets the same gradient
    leaves = [torch.from_numpy(t).requires_grad_(i == needed) for i, t in enumerate(inputs)]
    y, fs = fn.apply(*leaves)
    (y * torch.from_numpy(dy)).sum().add((fs * torch.from_numpy(dfinal)).sum()).backward()
    assert [t.grad is not None for t in leaves] == list(need)
    torch.testing.assert_close(leaves[needed].grad, want[needed], rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["ssd", "gdn"])
def test_function_without_a_cotangent(kind):
    """No cotangent at all: every gradient None. Only the final state's
    (y unused): the twin's gradients with dy = 0."""
    fn, _, bwd, inputs, dy, dfinal = _padded(kind)
    ctx = SimpleNamespace(needs_input_grad=(True,) * 5, saved_tensors=tuple(_t(inputs)))
    assert fn.backward(ctx, None, None) == (None,) * 5
    got = fn.backward(ctx, None, torch.from_numpy(dfinal))
    want = bwd(*_t(inputs), torch.zeros_like(torch.from_numpy(dy)), torch.from_numpy(dfinal))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["ssd", "gdn"])
def test_no_grad_runs_the_forward_alone(kind):
    _, scan, bwd, inputs, _, _ = _padded(kind)
    leaves = _t(inputs, grad=True)
    with torch.no_grad():
        y, fs = scan(*leaves)
    assert y.grad_fn is None and fs.grad_fn is None
    y2, fs2 = scan(*leaves)
    assert y2.grad_fn is not None
    torch.testing.assert_close(y, y2.detach(), rtol=0, atol=0)
    torch.testing.assert_close(fs, fs2.detach(), rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["ssd", "gdn"])
def test_bwd_wrapper_dtypes_contract_and_cpu_counts(kind):
    """Each gradient in its input's dtype (bf16 tensors, fp32 gates); dy
    and dfinal of the wrong shape or dtype refused; the CPU path launches
    nothing."""
    _, _, bwd, inputs, dy, dfinal = _padded(kind)
    t = _t(inputs)
    # x, b, c (SSD) or q, k, v (GDN) in bf16; dt, a or beta, alpha stay fp32
    wide = (0, 3, 4) if kind == "ssd" else (0, 1, 2)
    t = [a.bfloat16() if i in wide else a for i, a in enumerate(t)]
    before = bwd.launches
    grads = bwd(*t, torch.from_numpy(dy).bfloat16(), torch.from_numpy(dfinal))
    assert bwd.launches == before
    assert [g.dtype for g in grads] == [a.dtype for a in t]
    assert [g.shape for g in grads] == [a.shape for a in t]
    with pytest.raises(ValueError):
        bwd(*t, torch.from_numpy(dy), None)                       # fp32 dy, bf16 inputs
    with pytest.raises(ValueError):
        bwd(*t, torch.from_numpy(dy).bfloat16()[:, :-1], None)
    with pytest.raises(ValueError):
        bwd(*t, torch.from_numpy(dy).bfloat16(), torch.from_numpy(dfinal)[:, :1])
