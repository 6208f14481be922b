"""The port's Gated DeltaNet pieces against the JAX package, on the CPU.

* The plain ``gdn_scan_ref`` and the ``gdn_scan`` / ``gdn_prefill``
  wrappers (which take the plain version on a CPU tensor, padding to the
  kernel's chunk with beta = 0, alpha = 1 rows first) against the Pallas
  ``gdn_prefill`` (interpret mode, as ``tests/test_kernels.py`` runs it) and
  the JAX ``gdn_scan_ref``, at the ``TestGDN`` shapes plus lengths that are
  not a chunk multiple; fp32 at the GDN tolerance 2e-4.
* The ``gdn`` block's prefill (with its state) and decode steps against
  ``repro.models.gdn`` on reduced gdn-4b, weights from
  ``repro.models.init_params`` through numpy, at 1e-4 (the same sequential
  recurrence on both sides; XLA and PyTorch sum in other orders).
* The reference's bucket padding reaches the GDN state too, and the port
  reproduces it.
* ``gdn_chunked_ref``, the chunked (WY / UT-transform) form that the CUDA
  kernel evaluates, against ``gdn_scan_ref`` and the Pallas kernel at the GDN
  tolerance: chunks 16, 32 and 64, lengths that are not a chunk multiple,
  strong decay, beta = 1, K = 16 and 128.
Whole-model steps and engine replays of gdn-4b are in
``tests/test_torch_model.py`` and ``tests/test_torch_serving.py``; the CUDA
kernel itself runs only on a card (``tests/test_torch_gpu.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as R
from repro.configs import reduced_config as jax_reduced_config
from repro.kernels import gdn_prefill as jax_gdn_prefill
from repro.kernels import gdn_scan_ref as jax_gdn_scan_ref
from repro.models import gdn as jax_gdn
import repro_torch.models as T
from repro_torch.configs import reduced_config
from repro_torch.kernels import gdn_chunked_ref, gdn_prefill, gdn_scan, gdn_scan_ref
from repro_torch.kernels.gdn.gdn import CHUNK
from repro_torch.models import gdn as port_gdn

TOL = dict(rtol=2e-4, atol=2e-4)
BLOCK_TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(seed, b, s, h, k):
    """Unit-norm q and k, as the model's L2 norm makes them (the delta rule
    is contractive only for beta |k|^2 <= 2)."""
    rng = np.random.default_rng(seed)
    unit = lambda a: (a / np.linalg.norm(a, axis=-1, keepdims=True)).astype(np.float32)
    q = unit(rng.standard_normal((b, s, h, k)))
    kk = unit(rng.standard_normal((b, s, h, k)))
    v = (rng.standard_normal((b, s, h, k)) * 0.5).astype(np.float32)
    beta = (1 / (1 + np.exp(-rng.standard_normal((b, s, h))))).astype(np.float32)
    alpha = (1 / (1 + np.exp(-rng.standard_normal((b, s, h)) - 2))).astype(np.float32)
    return q, kk, v, beta, alpha


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("b,s,h,k,q", [
    (1, 16, 2, 16, 8),              # the TestGDN shapes
    (2, 64, 4, 32, 32),
    (1, 50, 3, 16, 16),
    (2, 45, 2, 32, 16),             # not a chunk multiple of either
])
def test_plain_scan_matches_pallas_and_oracle(b, s, h, k, q):
    arrays = _inputs(s + h, b, s, h, k)
    jargs = [jnp.asarray(a) for a in arrays]
    y_pl, fs_pl = jax_gdn_prefill(*jargs, q_chunk=q)
    y_or, fs_or = jax_gdn_scan_ref(*jargs)
    y, fs = gdn_scan_ref(*_t(*arrays))
    before = gdn_scan.launches
    y_w, fs_w = gdn_prefill(*_t(*arrays))                 # pads to CHUNK, slices back
    assert gdn_scan.launches == before                    # CPU: no kernel launch
    for got_y, got_fs in ((y, fs), (y_w, fs_w)):
        assert tuple(got_y.shape) == (b, s, h, k) and tuple(got_fs.shape) == (b, h, k, k)
        np.testing.assert_allclose(got_y.numpy(), np.asarray(y_or), **TOL)
        np.testing.assert_allclose(got_fs.numpy(), np.asarray(fs_or), **TOL)
        np.testing.assert_allclose(got_y.numpy(), np.asarray(y_pl), **TOL)
        np.testing.assert_allclose(got_fs.numpy(), np.asarray(fs_pl), **TOL)


@pytest.mark.parametrize("b,s,h,k,chunk,gates", [
    (1, 64, 2, 16, 16, "default"),
    (2, 64, 2, 16, 32, "default"),
    (1, 128, 2, 16, 64, "default"),
    (2, 45, 2, 16, 16, "default"),          # not a chunk multiple: padded
    (1, 100, 2, 32, 32, "default"),         # ... of 32 or 64 either
    (1, 96, 2, 16, 32, "strong_decay"),     # alpha near 0.05
    (1, 80, 2, 16, 64, "beta_one"),         # beta = 1
    (1, 96, 2, 128, 32, "default"),         # gdn-4b's head dim
    (1, 70, 1, 128, 64, "strong_decay"),
])
def test_chunked_form_matches_scan_and_pallas(b, s, h, k, chunk, gates):
    q, kk, v, beta, alpha = _inputs(7 * s + k + chunk, b, s, h, k)
    if gates == "strong_decay":
        alpha = np.random.default_rng(s).uniform(0.04, 0.06, alpha.shape).astype(np.float32)
    elif gates == "beta_one":
        beta = np.ones_like(beta)
    arrays = (q, kk, v, beta, alpha)
    y, fs = gdn_chunked_ref(*_t(*arrays), chunk)
    y_or, fs_or = jax_gdn_scan_ref(*(jnp.asarray(a) for a in arrays))
    y_pl, fs_pl = jax_gdn_prefill(*(jnp.asarray(a) for a in arrays), q_chunk=16)
    y_pt, fs_pt = gdn_scan_ref(*_t(*arrays))
    assert tuple(y.shape) == (b, s, h, k) and tuple(fs.shape) == (b, h, k, k)
    for want_y, want_fs in ((y_or, fs_or), (y_pl, fs_pl), (y_pt, fs_pt)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
        np.testing.assert_allclose(fs.numpy(), np.asarray(want_fs), **TOL)


def test_padding_rows_are_noops():
    q, k, v, beta, alpha = _t(*_inputs(3, 1, 20, 2, 16))
    y, fs = gdn_scan_ref(q, k, v, beta, alpha)
    pad = lambda t, value=0.0: torch.cat(
        [t, torch.full((1, CHUNK - 20) + t.shape[2:], value)], dim=1)
    yp, fsp = gdn_scan(pad(q), pad(k), pad(v), pad(beta), pad(alpha, 1.0))
    torch.testing.assert_close(yp[:, :20], y, rtol=0, atol=0)
    torch.testing.assert_close(fsp, fs, rtol=0, atol=0)


def test_state_stores_values_at_orthonormal_keys():
    """alpha = beta = 1 with basis-vector keys: row i of the final state is
    v_i (delta-rule associative memory), as ``TestGDN`` checks the Pallas
    kernel."""
    kd = 8
    eye = torch.eye(kd)[None, :, None, :]
    v = torch.from_numpy(np.random.default_rng(0).standard_normal((1, kd, 1, kd))
                         .astype(np.float32))
    ones = torch.ones((1, kd, 1))
    _, fs = gdn_prefill(eye, eye, v, ones, ones)
    torch.testing.assert_close(fs[0, 0], v[0, :, 0], rtol=1e-5, atol=1e-5)


def test_wrapper_contract():
    q, k, v, beta, alpha = _t(*_inputs(4, 1, CHUNK, 2, 16))
    with pytest.raises(ValueError, match="multiple"):
        gdn_scan(q[:, :20], k[:, :20], v[:, :20], beta[:, :20], alpha[:, :20])
    with pytest.raises(TypeError):
        gdn_scan(q, k.bfloat16(), v, beta, alpha)
    with pytest.raises(TypeError):
        gdn_scan(q, k, v, beta.bfloat16(), alpha)
    with pytest.raises(ValueError):
        gdn_scan(q, k, v[..., :8], beta, alpha)
    y, fs = gdn_scan(q.bfloat16(), k.bfloat16(), v.bfloat16(), beta, alpha)
    assert y.dtype == torch.bfloat16 and fs.dtype == torch.float32


def test_block_prefill_and_decode_match_reference():
    arch = "gdn-4b"
    jcfg, cfg = jax_reduced_config(arch), reduced_config(arch)
    jp = jax.tree.map(lambda a: a[0], R.init_params(jcfg, jax.random.PRNGKey(0))
                      ["stages"][0]["b0"]["gdn"])
    tp = T.params_from_numpy({"stages": [{"b0": {"gdn": jax.tree.map(np.asarray, jp)}}]},
                             cfg, device="cpu")["stages"][0]["b0"]["gdn"]
    h, kd = cfg.gdn_heads, cfg.gdn_head_dim
    b, s = 2, 13
    x = (np.random.default_rng(5).standard_normal((b, s + 3, cfg.d_model)) * 0.5
         ).astype(np.float32)
    jcache = {"gdn": jnp.zeros((b, h, kd, kd))}
    tcache = {"gdn": torch.zeros((b, h, kd, kd))}
    jo, jcache = jax_gdn.gdn_prefill(jp, jnp.asarray(x[:, :s]), jcfg, cache=jcache)
    to, _ = port_gdn.gdn_prefill(tp, torch.from_numpy(x[:, :s]), cfg, cache=tcache)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **BLOCK_TOL)
    np.testing.assert_allclose(tcache["gdn"].numpy(), np.asarray(jcache["gdn"]), **BLOCK_TOL)
    for t in range(s, s + 3):
        jo, jcache = jax_gdn.gdn_decode(jp, jnp.asarray(x[:, t:t + 1]), jcache, jcfg)
        to, _ = port_gdn.gdn_decode(tp, torch.from_numpy(x[:, t:t + 1]), tcache, cfg)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **BLOCK_TOL)
        np.testing.assert_allclose(tcache["gdn"].numpy(), np.asarray(jcache["gdn"]),
                                   **BLOCK_TOL)
    to2, _ = port_gdn.gdn_prefill(tp, torch.from_numpy(x[:, :s]), cfg, plain=True)
    np.testing.assert_allclose(to2.numpy(), np.asarray(
        jax_gdn.gdn_prefill(jp, jnp.asarray(x[:, :s]), jcfg)[0]), **BLOCK_TOL)


def test_bucket_padding_reaches_the_state_as_in_the_reference():
    """A 20-token prompt prefilled alone and inside a 32-token row padded
    with token 0: equal last-token logits, a state that holds the pads,
    both as the reference computes them."""
    arch = "gdn-4b"
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
        np.testing.assert_allclose(tc["stages"][0]["b0"]["gdn"].numpy(),
                                   np.asarray(jc["stages"][0]["b0"]["gdn"]), **BLOCK_TOL)
        states[width] = (tl, tc["stages"][0]["b0"]["gdn"])
    np.testing.assert_allclose(states[32][0].numpy(), states[20][0].numpy(), **BLOCK_TOL)
    assert (states[32][1] - states[20][1]).abs().max().item() > 1e-3
