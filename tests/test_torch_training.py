"""The port's training path against ``repro.training`` on the CPU, in fp32.

Weights come from ``repro.models.init_params`` through numpy
(``params_from_numpy``); batches from one ``PackedLMStream`` seed feed both
sides. Tolerances, each stated where it is used:
- the chunked cross-entropy: loss rtol 1e-6, grads rtol 1e-4 / atol 1e-6
  (with a mask and ``final_softcap``);
- ``wsd_schedule`` over steps 0-40: atol 1e-7;
- int8 compression: the codes and scales equal, and the error feedback
  conserving the sum (dequantised + new error == grad + old error);
- AdamW after 3 updates on the same grads, bf16 and fp32 leaves: rtol 1e-5;
- ``forward``'s hidden states: atol 1e-5 (llama-3.2-vision-11b: 1e-4, see
  ``FORWARD_ATOL``), the cross-attention gates set to 0.7 on both sides (a
  zero gate, the init, would hide a broken block);
- ``jax.grad`` against the port's backward, per leaf: rtol 1e-4 / atol 1e-6;
- 3 train steps, microbatches 1 and 2, compression on and off: params
  rtol 1e-4 / atol 1e-6, metrics within 1e-5; with compression on, an
  element whose scaled grad sits within rounding of a code boundary may
  take the neighbouring int8 code on one side (the grads agree to ~1e-7,
  the codes are a step function of them), so there at most 0.1 % of a
  leaf's elements may differ by up to one code's worth of update
  (``_assert_trees_close_but_flips``), and the carried error is held as
  the grads are, relative to its leaf's largest grad;
- ``prefill`` / ``decode_step`` of the ``cross_attn`` and embedding-input
  configs: logits rtol = atol = 1e-4 (``tests/test_torch_zoo.py``'s);
- ``run_training(device="cpu")`` against the reference's driver: first and
  last loss within 1e-5;
- checkpoints: a round trip, garbage collection and the incomplete step
  ignored, as ``tests/test_training.py`` checks the reference.
"""
import dataclasses
import json
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as R
import repro.training as JT
from repro.configs import reduced_config as jax_reduced_config
from repro.launch.train import run_training as jax_run_training
from repro.training import compression as jcomp
import repro_torch.models as TM
import repro_torch.training as TT
from repro_torch.configs import reduced_config
from repro_torch.launch.train import main as train_main
from repro_torch.launch.train import run_training
from repro_torch.training import compression as tcomp
from repro_torch.training import tree as T
from repro_torch.training.train import value_and_grad

GATE = 0.7
FORWARD_ARCHS = ["gemma-2b", "minicpm-2b", "minitron-4b-mla", "deepseek-v2-lite-16b",
                 "mamba2-780m", "gdn-4b", "zamba2-1.2b", "gemma2-9b",
                 "llama-3.2-vision-11b", "musicgen-large"]
# llama-3.2-vision-11b with its gates at 0.7 amplifies fp32 rounding: on the
# reference's weights both packages sit 2.2e-5 / 3.0e-5 from a float64
# evaluation of the port on the same weights (1.2e-6 with the gates at 0),
# so the two fp32 results are held to each other at 1e-4
FORWARD_ATOL = {"llama-3.2-vision-11b": 1e-4}
GRAD_ARCHS = ["gemma-2b", "deepseek-v2-lite-16b", "llama-3.2-vision-11b", "mamba2-780m", "gdn-4b",
              "zamba2-1.2b"]
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _weights(arch, seed=0):
    """(jax cfg, jax params, port cfg, port params) of a reduced arch, the
    cross-attention gates at GATE."""
    jcfg, cfg = jax_reduced_config(arch), reduced_config(arch)
    jp = R.init_params(jcfg, jax.random.PRNGKey(seed))
    jp = jax.tree_util.tree_map_with_path(
        lambda kp, a: jnp.full_like(a, GATE) if "'gate'" in jax.tree_util.keystr(kp) else a, jp)
    return jcfg, jp, cfg, TM.params_from_numpy(_np(jp), cfg, device="cpu")


def _batch(cfg, seq_len=16, batch_size=2, seed=0):
    """One PackedLMStream batch: (numpy dict, jax dict, torch dict)."""
    b = TT.PackedLMStream(cfg, TT.DataConfig(seq_len=seq_len, batch_size=batch_size,
                                              seed=seed)).next_batch()
    return b, {k: jnp.asarray(v) for k, v in b.items()}, {k: torch.from_numpy(v)
                                                          for k, v in b.items()}


def _pairs(jtree, ttree, path=""):
    """(path, jax leaf, port leaf) over the port tree's structure."""
    if isinstance(ttree, dict):
        for k, v in ttree.items():
            yield from _pairs(jtree[k], v, f"{path}/{k}")
    elif isinstance(ttree, (list, tuple)):
        for i, v in enumerate(ttree):
            yield from _pairs(jtree[i], v, f"{path}/{i}")
    else:
        yield path, np.asarray(jtree, np.float32), ttree.detach().float().numpy()


def _assert_trees_close(jtree, ttree, **tol):
    n = 0
    for path, a, b in _pairs(jtree, ttree):
        np.testing.assert_allclose(b, a, err_msg=path, **tol)
        n += 1
    assert n > 0


def _assert_trees_close_but_flips(jtree, ttree, flip, share=1e-3, **tol):
    """As ``_assert_trees_close``, but up to ``share`` of a leaf's elements
    (at least one) may miss ``tol`` by at most ``flip(jax leaf)``."""
    for path, a, b in _pairs(jtree, ttree):
        bad = ~np.isclose(b, a, **tol)
        assert bad.sum() <= max(1, share * a.size), (path, int(bad.sum()))
        assert np.all(np.abs(b - a)[bad] <= flip(a)), path


# ------------------------------------------------------------------ exports
def test_exports_match_reference():
    assert TT.__all__ == JT.__all__
    assert callable(TM.forward)
    assert callable(tcomp.compressed_psum)     # the int8 exchange over a group


# --------------------------------------------------------------------- loss
@pytest.mark.parametrize("masked,softcap,s,chunk", [
    (False, 0.0, 13, 4), (True, 0.0, 13, 4), (True, 30.0, 16, 16), (False, 5.0, 9, 512),
])
def test_chunked_xent_value_and_grad_match_reference(masked, softcap, s, chunk):
    rng = np.random.default_rng(s)
    b, d, v = 2, 16, 50
    h = rng.standard_normal((b, s, d)).astype(np.float32)
    table = rng.standard_normal((v, d)).astype(np.float32)
    labels = rng.integers(0, v, (b, s)).astype(np.int32)
    mask = (rng.random((b, s)) > 0.3).astype(np.float32) if masked else None

    def jloss(h_, t_):
        return JT.chunked_softmax_xent(h_, t_, jnp.asarray(labels), chunk=chunk,
                                       final_softcap=softcap,
                                       mask=None if mask is None else jnp.asarray(mask))

    jl, (jgh, jgt) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(table))
    th = torch.from_numpy(h).requires_grad_()
    tt = torch.from_numpy(table).requires_grad_()
    tl = TT.chunked_softmax_xent(th, tt, torch.from_numpy(labels), chunk=chunk,
                                 final_softcap=softcap,
                                 mask=None if mask is None else torch.from_numpy(mask))
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jgh), **GRAD_TOL)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(jgt), **GRAD_TOL)


# ---------------------------------------------------------------- optimizer
@pytest.mark.parametrize("args", [(3e-4, 2, 12, 6), (1e-3, 0, 5, 10, 0.25), (3e-4, 4, 0, 0)])
def test_wsd_schedule_matches_reference(args):
    js, ts = JT.wsd_schedule(*args), TT.wsd_schedule(*args)
    for step in range(41):
        np.testing.assert_allclose(ts(torch.tensor(step, dtype=torch.int32)).item(),
                                   float(js(jnp.asarray(step, jnp.int32))), rtol=0, atol=1e-7)
    assert ts(7).dtype == torch.float32


def _opt_tree(dtype, rng):
    return {"w": rng.standard_normal((4, 8)).astype(np.float32),
            "stack": {"scale": rng.standard_normal((3, 8)).astype(np.float32),
                      "gate": rng.standard_normal((3,)).astype(np.float32)},
            "b": [rng.standard_normal((8,)).astype(np.float32)]}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_three_updates_match_reference(dtype):
    """Decay on ndim >= 2 only (the stacked (n, d) scale is decayed, the
    stacked (n,) gate and the 1-D bias are not), fp32 moments at both
    param dtypes, the lr from the schedule at the step before its
    increment."""
    rng = np.random.default_rng(0)
    p0, grads = _opt_tree(dtype, rng), [_opt_tree(dtype, rng) for _ in range(3)]
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    jopt, topt = JT.AdamW(), TT.AdamW()
    jsched, tsched = JT.wsd_schedule(1e-2, 1, 1, 1), TT.wsd_schedule(1e-2, 1, 1, 1)
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(jd), p0)
    tp = T.map(lambda a: torch.from_numpy(a.copy()).to(td), p0)
    js, ts = jopt.init(jp), topt.init(tp)
    assert all(m.dtype == torch.float32 for m in T.leaves(ts.mu) + T.leaves(ts.nu))
    for i, g in enumerate(grads):
        jg = jax.tree.map(lambda a: jnp.asarray(a).astype(jd), g)
        tg = T.map(lambda a: torch.from_numpy(a.copy()).to(td), g)
        jp, js = jopt.update(jg, js, jp, jsched(jnp.asarray(i, jnp.int32)))
        tp, ts = topt.update(tg, ts, tp, tsched(torch.tensor(i, dtype=torch.int32)))
        assert all(t.dtype == td for t in T.leaves(tp))
    assert int(ts.count) == int(js.count) == 3
    _assert_trees_close(jp, tp, rtol=1e-5, atol=0)
    _assert_trees_close(js.mu, ts.mu, rtol=1e-5, atol=1e-12)
    _assert_trees_close(js.nu, ts.nu, rtol=1e-5, atol=1e-12)


def test_clip_by_global_norm_matches_reference():
    rng = np.random.default_rng(1)
    tree = _opt_tree("float32", rng)
    for max_norm in (0.5, 1e3):
        jc, jn = JT.clip_by_global_norm(jax.tree.map(jnp.asarray, tree), max_norm)
        tc, tn = TT.clip_by_global_norm(T.map(torch.from_numpy, tree), max_norm)
        np.testing.assert_allclose(tn.item(), float(jn), rtol=1e-6)
        _assert_trees_close(jc, tc, rtol=1e-6, atol=1e-7)


# -------------------------------------------------------------- compression
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int8_codes_equal_and_feedback_conserves_the_sum(seed):
    rng = np.random.default_rng(seed)
    # half-integer multiples of the scale exercise round-half-to-even
    x = rng.standard_normal((64, 33)).astype(np.float32)
    x[0, :5] = np.array([0.5, 1.5, 2.5, -0.5, -2.5], np.float32) * (np.abs(x).max() / 127.0)
    jq, jscale = jcomp.quantize_int8(jnp.asarray(x))
    tq, tscale = tcomp.quantize_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert tscale.item() == float(jscale)

    grads = {"a": x, "b": [rng.standard_normal((7,)).astype(np.float32)]}
    err = {"a": rng.standard_normal((64, 33)).astype(np.float32) * 1e-3,
           "b": [np.zeros((7,), np.float32)]}
    jg, je = jcomp.compress_with_feedback(jax.tree.map(jnp.asarray, grads),
                                          jax.tree.map(jnp.asarray, err))
    tg, te = tcomp.compress_with_feedback(T.map(torch.from_numpy, grads),
                                          T.map(torch.from_numpy, err))
    _assert_trees_close(jg, tg, rtol=0, atol=0)
    _assert_trees_close(je, te, rtol=0, atol=0)
    for (_, g, e), (_, d, n) in zip(_pairs(grads, T.map(torch.from_numpy, err)),
                                    _pairs(_np(jg), te)):
        np.testing.assert_allclose(d + n, g + e, rtol=0, atol=1e-6)
    zeros = tcomp.init_error_buffer(T.map(torch.from_numpy, grads))
    assert all(z.dtype == torch.float32 and not z.any() for z in T.leaves(zeros))


# ------------------------------------------------------------------ forward
@pytest.mark.parametrize("arch", FORWARD_ARCHS)
def test_forward_hidden_matches_reference(arch):
    jcfg, jp, cfg, tp = _weights(arch)
    _, jb, tb = _batch(cfg)
    jh = R.forward(jp, jcfg, jb["inputs"], enc_states=jb.get("enc_states"), remat=False)
    th = TM.forward(tp, cfg, tb["inputs"], enc_states=tb.get("enc_states"), remat=True)
    assert tuple(th.shape) == (2, 16, cfg.d_model)
    np.testing.assert_allclose(th.detach().numpy(), np.asarray(jh), rtol=0,
                               atol=FORWARD_ATOL.get(arch, 1e-5))


def test_cross_attention_gate_is_live():
    """With the gates at 0.7 the vision model's hidden states differ from
    the same weights with the gates at 0 (the init), so the parity above
    tests the cross-attention block."""
    jcfg, jp, cfg, tp = _weights("llama-3.2-vision-11b")
    _, _, tb = _batch(cfg)
    closed = T.map(lambda a: a, tp)
    for st in closed["stages"]:
        for blk in st.values():
            if "xattn" in blk:
                blk["xattn"] = dict(blk["xattn"], gate=torch.zeros_like(blk["xattn"]["gate"]))
    h_open = TM.forward(tp, cfg, tb["inputs"], enc_states=tb["enc_states"])
    h_closed = TM.forward(closed, cfg, tb["inputs"], enc_states=tb["enc_states"])
    assert (h_open - h_closed).abs().max().item() > 0.1
    assert tp["stages"][0]["b4"]["xattn"]["gate"].shape == (2,)


# ---------------------------------------------------------------- backward
@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_grads_match_jax_grad_per_leaf(arch):
    """``jax.value_and_grad`` of the reference's loss against the port's
    ``value_and_grad`` (autograd through remat and the loss chunks), leaf
    by leaf, with every leaf's gradient nonzero on both sides."""
    jcfg, jp, cfg, tp = _weights(arch)
    _, jb, tb = _batch(cfg, seq_len=24)

    def jloss(params):
        h = R.forward(params, jcfg, jb["inputs"], enc_states=jb.get("enc_states"), remat=True)
        return JT.chunked_softmax_xent(h, params["embed"]["table"], jb["labels"], chunk=8,
                                       final_softcap=jcfg.final_softcap)

    jl, jg = jax.value_and_grad(jloss)(jp)
    tl, tg = value_and_grad(tp, cfg, tb, remat=True, loss_chunk=8)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6)
    _assert_trees_close(jg, tg, **GRAD_TOL)
    assert all(bool(g.abs().max() > 0) for g in T.leaves(tg))


# --------------------------------------------------------------- train step
@pytest.mark.parametrize("microbatches,compression", [(1, False), (2, False), (1, True),
                                                      (2, True)])
def test_three_train_steps_match_reference(microbatches, compression):
    jcfg, jp, cfg, tp = _weights("gemma-2b")
    sched = (3e-3, 1, 1, 1)
    kw = dict(microbatches=microbatches, compression=compression, loss_chunk=8)
    jstep = jax.jit(JT.make_train_step(jcfg, JT.AdamW(), JT.wsd_schedule(*sched), **kw))
    tstep = TT.make_train_step(cfg, TT.AdamW(), TT.wsd_schedule(*sched), **kw)
    js = JT.init_train_state(jcfg, jp, JT.AdamW(), compression=compression)
    ts = TT.init_train_state(cfg, tp, TT.AdamW(), compression=compression)
    stream = TT.PackedLMStream(cfg, TT.DataConfig(seq_len=16, batch_size=4, seed=3))
    for _ in range(3):
        b = stream.next_batch()
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        ts, tm = tstep(ts, {k: torch.from_numpy(v) for k, v in b.items()})
        for key in ("loss", "grad_norm", "lr", "step"):
            np.testing.assert_allclose(tm[key].item(), float(jm[key]), rtol=1e-5, atol=1e-5,
                                       err_msg=key)
    assert int(ts.step) == 3 and int(ts.opt_state.count) == 3
    if compression:
        # a flipped code moves the Adam step of one element by at most ~2 lr
        # a step (3 steps), and its carried error by one scale (2 x its max)
        _assert_trees_close_but_flips(js.params, ts.params, lambda a: 6 * sched[0],
                                      rtol=1e-4, atol=1e-6)
        # the carried error (grad + error - its code) carries the grad's own
        # rounding: held at atol 1e-6 + 1e-4 x the leaf's largest grad, which
        # is 127 codes, at most 254 x the largest error (half a code)
        for path, a, b in _pairs(js.error_buf, ts.error_buf):
            half_code = np.abs(a).max()
            bad = ~np.isclose(b, a, rtol=0, atol=1e-6 + 1e-4 * 254 * half_code)
            assert bad.sum() <= max(1, 1e-3 * a.size), (path, int(bad.sum()))
            assert np.all(np.abs(b - a)[bad] <= 2.01 * half_code), path
    else:
        _assert_trees_close(js.params, ts.params, rtol=1e-4, atol=1e-6)
        assert ts.error_buf is None


def test_eval_step_matches_reference():
    jcfg, jp, cfg, tp = _weights("musicgen-large")
    _, jb, tb = _batch(cfg)
    jl = JT.make_eval_step(jcfg, loss_chunk=8)(jp, jb)
    tl = TT.make_eval_step(cfg, loss_chunk=8)(tp, tb)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)


# ------------------------------------------- cross_attn / embedding serving
@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "musicgen-large"])
@pytest.mark.parametrize("paged", [False, True])
def test_prefill_and_decode_steps_match_reference(arch, paged):
    """The vision model's encoder k/v encoded at prefill and read back by
    each decode step (slot indexed in the paged layout too); musicgen's
    prompt and decode inputs are embedding rows."""
    jcfg, jp, cfg, tp = _weights(arch)
    b, s, n_dec, bs, max_len = 2, 10, 3, 4, 16
    rng = np.random.default_rng(5)
    if cfg.input_is_embeddings:
        seq = rng.standard_normal((b, s + n_dec, cfg.d_model)).astype(np.float32)
        step_in = lambda t: seq[:, s + t:s + t + 1]
    else:
        seq = rng.integers(1, cfg.vocab_size, (b, s + n_dec)).astype(np.int32)
        step_in = lambda t: seq[:, s + t]
    enc = (rng.standard_normal((b, cfg.n_media_tokens, cfg.d_model)).astype(np.float32)
           if cfg.n_media_tokens else None)
    jenc = None if enc is None else jnp.asarray(enc)
    tenc = None if enc is None else torch.from_numpy(enc)
    if paged:
        nb = max_len // bs
        n_pages = 1 + b * nb
        tables = (1 + np.arange(b * nb, dtype=np.int32)).reshape(b, nb)
        jc, tc = R.init_paged_cache(jcfg, b, n_pages, bs), TM.init_paged_cache(
            cfg, b, n_pages, bs, device="cpu")
        assert TM.paged_layout(cfg) == R.paged_layout(jcfg)
    else:
        jc, tc = R.init_cache(jcfg, b, max_len), TM.init_cache(cfg, b, max_len, device="cpu")
    shapes = lambda tree: jax.tree.map(lambda a: tuple(a.shape), tree)
    assert shapes(tc) == shapes(_np(jc))
    # the prefill writes the dense layout; a paged cache takes its rows page by page
    dense_j = R.init_cache(jcfg, b, max_len)
    jl, dense_j, jlen = R.prefill(jp, jcfg, jnp.asarray(seq[:, :s]), dense_j, enc_states=jenc)
    dense_t = TM.init_cache(cfg, b, max_len, device="cpu")
    tl, dense_t, tlen = TM.prefill(tp, cfg, torch.from_numpy(seq[:, :s]), dense_t,
                                   enc_states=tenc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    _assert_trees_close(dense_j, dense_t, rtol=1e-4, atol=1e-4)
    if paged:
        layout = R.paged_layout(jcfg)
        jc = jax.tree.map(
            lambda pc, dc, is_paged: pc.at[:, tables.reshape(-1)].set(
                dc.reshape((dc.shape[0], b * nb, bs) + dc.shape[3:])) if is_paged else dc,
            jc, dense_j, layout)
        tc = TM.cache_from_numpy(_np(jc), device="cpu")
        active = np.ones((b,), bool)
    else:
        jc, tc = dense_j, dense_t
    for t in range(n_dec):
        x = step_in(t)
        if paged:
            jl, jc, jlen = R.decode_step_paged(jp, jcfg, jnp.asarray(x), jc, jlen,
                                               jnp.asarray(active), jnp.asarray(tables))
            tl, tc, tlen = TM.decode_step_paged(tp, cfg, torch.from_numpy(x), tc, tlen,
                                                torch.from_numpy(active),
                                                torch.from_numpy(tables))
        else:
            jl, jc, jlen = R.decode_step(jp, jcfg, jnp.asarray(x), jc, jlen)
            tl, tc, tlen = TM.decode_step(tp, cfg, torch.from_numpy(x), tc, tlen)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
        assert np.array_equal(tl.numpy().argmax(-1), np.asarray(jl).argmax(-1))
    assert tlen.tolist() == np.asarray(jlen).tolist() == [s + n_dec] * b


# ----------------------------------------------------------------- launcher
def test_run_training_matches_reference_driver():
    kw = dict(arch="gemma-2b", steps=8, batch_size=4, seq_len=32, log_every=100)
    ref = jax_run_training(**kw)
    jcfg = jax_reduced_config("gemma-2b")
    params = TM.params_from_numpy(_np(R.init_params(jcfg, jax.random.PRNGKey(0))),
                                  reduced_config("gemma-2b"), device="cpu")
    out = run_training(**kw, device="cpu", params=params)
    assert out["steps"] == ref["steps"] == 8
    np.testing.assert_allclose(out["first_loss"], ref["first_loss"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(out["last_loss"], ref["last_loss"], rtol=0, atol=1e-5)
    assert out["last_loss"] < out["first_loss"]
    assert set(ref) < set(out) and out["peak_mem_gb"] is None and out["step_ms"] > 0
    assert len(out["losses"]) == 8 and out["straggler_events"] == 0


def test_run_training_resumes_from_its_checkpoint_and_refuses_a_mesh(capsys):
    with tempfile.TemporaryDirectory() as d:
        kw = dict(arch="gemma-2b", batch_size=2, seq_len=16, device="cpu",
                  checkpoint_dir=d, checkpoint_every=2, log_every=100)
        first = run_training(steps=4, **kw)
        assert TT.list_steps(d) == [2, 4] and first["steps"] == 4
        resumed = run_training(steps=6, **kw)
        assert "resumed from step 4" in capsys.readouterr().out
        assert resumed["steps"] == 2 and TT.latest_step(d) == 6
    with pytest.raises(ValueError, match="one card"):
        run_training(arch="gemma-2b", steps=1, device="cpu", use_mesh=True)
    train_main(["--arch", "gemma-2b", "--device", "cpu", "--steps", "2", "--seq-len", "16",
                "--batch-size", "2", "--compression"])
    assert "[train] done" in capsys.readouterr().out


def test_run_training_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_training(arch="gemma-2b", steps=1)


# --------------------------------------------------------------- checkpoint
def test_checkpoint_roundtrip_and_gc():
    cfg = reduced_config("zamba2-1.2b")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    state = TT.init_train_state(cfg, params, TT.AdamW(), compression=True)
    with tempfile.TemporaryDirectory() as d:
        for s in (1, 2, 3, 4, 5):
            TT.save_checkpoint(d, s, state, keep=3)
        steps = sorted(int(x.split("_")[1]) for x in os.listdir(d))
        assert steps == [3, 4, 5]
        with open(os.path.join(d, "step_000000005", "manifest.json")) as f:
            manifest = json.load(f)
        assert manifest["step"] == 5 and len(manifest["leaves"]) == len(T.leaves(state))
        like = T.map(lambda t: torch.empty_like(t, device="meta"), state)
        restored = TT.restore_checkpoint(d, 5, like)
        assert type(restored) is TT.TrainState and restored.opt_state.count.dtype == torch.int32
        for a, b in zip(T.leaves(state), T.leaves(restored)):
            assert a.dtype == b.dtype and b.device.type == "cpu"
            assert torch.equal(a, b)
        with pytest.raises(ValueError, match="leaves"):
            TT.restore_checkpoint(d, 5, {"p": params["final_norm"]["scale"]})


def test_checkpoint_bf16_leaves_and_async_save():
    """bf16 leaves go through their uint16 bit pattern, bit for bit; the
    async save snapshots on the caller's thread, so later in-place updates
    do not reach the files."""
    cfg = dataclasses.replace(reduced_config("gemma-2b"), param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    params = TM.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    want = T.map(lambda t: t.clone(), params)
    with tempfile.TemporaryDirectory() as d:
        th = TT.save_checkpoint_async(d, 3, params)
        for t in T.leaves(params):
            t.add_(1.0)
        th.join()
        with open(os.path.join(d, "step_000000003", "manifest.json")) as f:
            assert {l["dtype"] for l in json.load(f)["leaves"]} == {"bfloat16"}
        restored = TT.restore_checkpoint(d, 3, want)
        for a, b in zip(T.leaves(want), T.leaves(restored)):
            assert b.dtype == torch.bfloat16 and torch.equal(a, b)
        as_fp32 = TT.restore_checkpoint(d, 3, T.map(lambda t: t.float(), want))
        assert all(t.dtype == torch.float32 for t in T.leaves(as_fp32))


def test_incomplete_checkpoint_ignored():
    cfg = reduced_config("gemma-2b")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with tempfile.TemporaryDirectory() as d:
        TT.save_checkpoint(d, 7, {"p": params["final_norm"]["scale"]})
        os.makedirs(os.path.join(d, "step_000000009"))
        os.makedirs(os.path.join(d, "step_000000011.tmp"))
        assert TT.latest_step(d) == 7 and TT.list_steps(d) == [7]
    assert TT.latest_step(os.path.join(tempfile.gettempdir(), "no-such-dir-xyz")) is None
