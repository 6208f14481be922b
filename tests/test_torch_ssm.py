"""The port's Mamba2 SSD pieces against the JAX package, on the CPU.

* The plain ``ssd_scan_ref`` and the ``ssd_scan`` / ``ssd_prefill``
  wrappers (which take the plain version on a CPU tensor, padding to the
  kernel's chunk with dt = 0 rows first) against the Pallas ``ssd_prefill``
  (interpret mode, as ``tests/test_kernels.py`` runs it) and the JAX
  ``ssd_scan_ref``, at the ``TestSSD`` shapes plus lengths that are not a
  chunk multiple; fp32 at the SSD tolerance 2e-4 (sequential recurrence
  against the chunked form: the same math, summed in another order).
* The ``ssm`` block's prefill (with its SSM and conv states) and decode
  steps against ``repro.models.ssm`` on reduced mamba2-4b, weights from
  ``repro.models.init_params`` through numpy, at 1e-4 (the JAX block scans
  with its jnp ``ssd_chunked``, the port with the sequential plain version).
* The reference's bucket padding: a prompt prefilled inside a longer,
  token-0-padded row runs the pads through the recurrence, so its decode
  state holds them; the port reproduces the reference's state exactly
  that way.
Whole-model steps and engine replays of mamba2-4b are in
``tests/test_torch_model.py`` and ``tests/test_torch_serving.py``; the CUDA
kernel itself runs only on a card (``tests/test_torch_gpu.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as R
from repro.configs import reduced_config as jax_reduced_config
from repro.kernels import ssd_prefill as jax_ssd_prefill
from repro.kernels import ssd_scan_ref as jax_ssd_scan_ref
from repro.models import ssm as jax_ssm
import repro_torch.models as T
from repro_torch.configs import reduced_config
from repro_torch.kernels import ssd_prefill, ssd_scan, ssd_scan_ref
from repro_torch.kernels.ssd.ssd import CHUNK
from repro_torch.models import ssm as port_ssm

TOL = dict(rtol=2e-4, atol=2e-4)
BLOCK_TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(seed, b, s, h, p, n):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, s, h, p)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)   # softplus
    a = (-np.exp(np.linspace(-2, 0.5, h))).astype(np.float32)
    bm = (rng.standard_normal((b, s, n)) * 0.3).astype(np.float32)
    cm = (rng.standard_normal((b, s, n)) * 0.3).astype(np.float32)
    return x, dt, a, bm, cm


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("b,s,h,p,n,q,hb", [
    (1, 32, 4, 16, 32, 8, 2),       # the TestSSD shapes
    (2, 64, 8, 16, 32, 16, 4),
    (2, 48, 4, 32, 16, 16, 4),
    (1, 37, 4, 16, 16, 16, 4),      # not a chunk multiple of either
    (1, 100, 4, 32, 16, 32, 4),     # several kernel chunks, ragged
])
def test_plain_scan_matches_pallas_and_oracle(b, s, h, p, n, q, hb):
    arrays = _inputs(s + h, b, s, h, p, n)
    jargs = [jnp.asarray(a) for a in arrays]
    y_pl, fs_pl = jax_ssd_prefill(*jargs, q_chunk=q, head_block=hb)
    y_or, fs_or = jax_ssd_scan_ref(*jargs)
    y, fs = ssd_scan_ref(*_t(*arrays))
    before = ssd_scan.launches
    y_w, fs_w = ssd_prefill(*_t(*arrays))                 # pads to CHUNK, slices back
    assert ssd_scan.launches == before                    # CPU: no kernel launch
    for got_y, got_fs in ((y, fs), (y_w, fs_w)):
        assert tuple(got_y.shape) == (b, s, h, p) and tuple(got_fs.shape) == (b, h, p, n)
        np.testing.assert_allclose(got_y.numpy(), np.asarray(y_or), **TOL)
        np.testing.assert_allclose(got_fs.numpy(), np.asarray(fs_or), **TOL)
        np.testing.assert_allclose(got_y.numpy(), np.asarray(y_pl), **TOL)
        np.testing.assert_allclose(got_fs.numpy(), np.asarray(fs_pl), **TOL)


def test_dt_zero_padding_rows_are_noops():
    x, dt, a, bm, cm = _t(*_inputs(3, 1, 20, 2, 8, 16))
    y, fs = ssd_scan_ref(x, dt, a, bm, cm)
    pad = lambda t: torch.cat([t, torch.zeros((1, CHUNK - 20) + t.shape[2:])], dim=1)
    yp, fsp = ssd_scan(pad(x), pad(dt), a, pad(bm), pad(cm))
    torch.testing.assert_close(yp[:, :20], y, rtol=0, atol=0)
    torch.testing.assert_close(fsp, fs, rtol=0, atol=0)


def test_wrapper_contract():
    x, dt, a, bm, cm = _t(*_inputs(4, 1, CHUNK, 2, 8, 16))
    with pytest.raises(ValueError, match="multiple"):
        ssd_scan(x[:, :40], dt[:, :40], a, bm[:, :40], cm[:, :40])
    with pytest.raises(TypeError):
        ssd_scan(x, dt.double(), a, bm, cm)
    with pytest.raises(TypeError):
        ssd_scan(x, dt, a, bm.bfloat16(), cm)
    # ssm_groups > 1: two B/C groups, heads 0 and 1 on group 0, 2 and 3 on
    # group 1, as the reference's ssd_chunked reads them
    b2, c2 = torch.stack([bm, bm.flip(1)], 2), torch.stack([cm, -cm], 2)
    y2, fs2 = ssd_prefill(x, dt, a, b2, c2)
    jy2, jfs2 = jax_ssm.ssd_chunked(*(jnp.asarray(t.numpy()) for t in (x, dt, a, b2, c2)),
                                    chunk=16)
    np.testing.assert_allclose(y2.numpy(), np.asarray(jy2), **TOL)
    np.testing.assert_allclose(fs2.numpy(), np.asarray(jfs2), **TOL)
    with pytest.raises(ValueError, match="G dividing"):
        ssd_scan(x, dt, a, torch.stack([bm] * 3, 2), torch.stack([cm] * 3, 2))
    y, fs = ssd_scan(x.bfloat16(), dt, a, bm.bfloat16(), cm.bfloat16())
    assert y.dtype == torch.bfloat16 and fs.dtype == torch.float32


def _block(arch="mamba2-4b"):
    jcfg, cfg = jax_reduced_config(arch), reduced_config(arch)
    jp = R.init_params(jcfg, jax.random.PRNGKey(0))["stages"][0]["b0"]["ssm"]
    jp = jax.tree.map(lambda a: a[0], jp)                      # unit 0
    tp = T.params_from_numpy({"stages": [{"b0": {"ssm": jax.tree.map(np.asarray, jp)}}]},
                             cfg, device="cpu")["stages"][0]["b0"]["ssm"]
    return jcfg, cfg, jp, tp


def test_fp32_leaves_stay_fp32_at_bf16():
    """a_log, d_skip and dt_bias are fp32 at every param dtype, in the
    bridge and in the init, as in the JAX init."""
    cfg = dataclasses.replace(reduced_config("mamba2-4b"), param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    jcfg = dataclasses.replace(jax_reduced_config("mamba2-4b"), param_dtype="bfloat16",
                               compute_dtype="bfloat16")
    jp = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)),
                      R.init_params(jcfg, jax.random.PRNGKey(0)))
    for tree in (T.params_from_numpy(jp, cfg, device="cpu"),
                 T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")):
        ssm = tree["stages"][0]["b0"]["ssm"]
        assert {k: ssm[k].dtype for k in ("a_log", "d_skip", "dt_bias")} == \
            dict.fromkeys(("a_log", "d_skip", "dt_bias"), torch.float32)
        assert ssm["w_in"].dtype == ssm["conv_w"].dtype == torch.bfloat16


def test_block_prefill_and_decode_match_reference():
    jcfg, cfg, jp, tp = _block()
    d_inner, heads, p, n, g, conv_dim = port_ssm._dims(cfg)
    b, s = 2, 13
    x = (np.random.default_rng(5).standard_normal((b, s + 3, cfg.d_model)) * 0.5
         ).astype(np.float32)
    jcache = {"ssm": jnp.zeros((b, heads, p, n)),
              "conv": jnp.zeros((b, cfg.ssm_conv_kernel - 1, conv_dim))}
    tcache = {k: torch.zeros(v.shape) for k, v in jcache.items()}
    jo, jcache = jax_ssm.ssm_prefill(jp, jnp.asarray(x[:, :s]), jcfg, cache=jcache)
    to, _ = port_ssm.ssm_prefill(tp, torch.from_numpy(x[:, :s]), cfg, cache=tcache)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **BLOCK_TOL)
    for key in ("ssm", "conv"):
        np.testing.assert_allclose(tcache[key].numpy(), np.asarray(jcache[key]), **BLOCK_TOL)
    for t in range(s, s + 3):                               # decode: O(1) state steps
        jo, jcache = jax_ssm.ssm_decode(jp, jnp.asarray(x[:, t:t + 1]), jcache, jcfg)
        to, _ = port_ssm.ssm_decode(tp, torch.from_numpy(x[:, t:t + 1]), tcache, cfg)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **BLOCK_TOL)
        for key in ("ssm", "conv"):
            np.testing.assert_allclose(tcache[key].numpy(), np.asarray(jcache[key]),
                                       **BLOCK_TOL)
    # prefill with the plain switch is the same function on the CPU
    again = {k: torch.zeros(v.shape) for k, v in tcache.items()}
    to2, _ = port_ssm.ssm_prefill(tp, torch.from_numpy(x[:, :s]), cfg, cache=again,
                                  plain=True)
    np.testing.assert_allclose(to2.numpy(), np.asarray(
        jax_ssm.ssm_prefill(jp, jnp.asarray(x[:, :s]), jcfg)[0]), **BLOCK_TOL)


def test_bucket_padding_reaches_the_state_as_in_the_reference():
    """A 20-token prompt prefilled alone and inside a 32-token row padded
    with token 0 (the pool's bucket): the last-token logits agree, but the
    padded row's states hold the pads. Both paths equal the reference's."""
    arch = "mamba2-4b"
    jcfg, cfg = jax_reduced_config(arch), reduced_config(arch)
    jp = R.init_params(jcfg, jax.random.PRNGKey(0))
    tp = T.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    prompt = np.random.default_rng(6).integers(1, cfg.vocab_size, 20).astype(np.int32)
    states = {}
    for width in (20, 32):
        toks = np.zeros((1, width), np.int32)
        toks[0, :20] = prompt
        ln = np.array([20], np.int32)
        jl, jc, _ = R.prefill(jp, jcfg, jnp.asarray(toks), R.init_cache(jcfg, 1, 64),
                              prompt_lengths=jnp.asarray(ln))
        tl, tc, _ = T.prefill(tp, cfg, torch.from_numpy(toks),
                              T.init_cache(cfg, 1, 64, device="cpu"),
                              prompt_lengths=torch.from_numpy(ln))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **BLOCK_TOL)
        for key in ("ssm", "conv"):
            np.testing.assert_allclose(tc["stages"][0]["b0"][key].numpy(),
                                       np.asarray(jc["stages"][0]["b0"][key]), **BLOCK_TOL)
        states[width] = (tl, tc["stages"][0]["b0"]["ssm"])
    np.testing.assert_allclose(states[32][0].numpy(), states[20][0].numpy(), **BLOCK_TOL)
    assert (states[32][1] - states[20][1]).abs().max().item() > 1e-3
