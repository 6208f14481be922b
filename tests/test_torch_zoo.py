"""gemma2-9b, deepseek-v2-lite-16b and zamba2-1.2b in the port, against
``repro.models`` on their reduced configs, in fp32.

The three architectures bring the last features the served path needed:
the logit softcap and the sliding window inside the decode kernels
(reduced gemma2-9b: window 8, attention softcap 50, final softcap 30, so a
12-token prompt crosses the window), the ``mla_moe`` block and its routed
MoE MLP with the reference's capacity dispatch (reduced deepseek-v2-lite:
8 experts, top 2, one shared expert, a dense first block), and the
``shared_attn`` block (reduced zamba2-1.2b: one unstacked shared block run
at every such slot over its own k/v cache, beside slot-indexed Mamba2
state, so its paged cache mixes the two). Weights come from
``repro.models.init_params`` through numpy (``params_from_numpy``); logits
and caches at rtol = atol = 1e-4 (summation order only: both sides do the
same fp32 arithmetic), greedy tokens equal. Also the plain decode-attention
versions with softcap and window against the reference's decode math, the
MoE MLP alone (capacity drops included), the naive MLA path
(``absorb=False``) and the ``ssm_groups > 1`` refusal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as R
from repro.configs import reduced_config as jax_reduced_config
from repro.models import attention as jattn
from repro.models import mla as jmla
from repro.models import moe as jmoe
from repro.serving import ServingEngine as JEngine
from repro.training import make_prompts
import repro_torch.models as T
from repro_torch.configs import reduced_config
from repro_torch.kernels.decode_attn import decode_attention_ref, paged_decode_attention_ref
from repro_torch.models import mla as tmla
from repro_torch.models import moe as tmoe
from repro_torch.serving import ServingEngine as TEngine

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["gemma2-9b", "deepseek-v2-lite-16b", "zamba2-1.2b"]
N_STEPS = 4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(jax cfg, jax params, port cfg, port params) of one reduced arch,
    built once per module."""
    arch = request.param
    jcfg, cfg = jax_reduced_config(arch), reduced_config(arch)
    jp = R.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jp, cfg, T.params_from_numpy(_np_tree(jp), cfg, device="cpu")


# ------------------------------------------------ decode attention plain versions
def _decode_attend_reference(q, k, v, valid_len, softcap, window):
    """The reference model's decode attention (``_decode_attend``) on the
    same inputs, through an identity output projection: (B, H * Dv)."""
    b, h, d = q.shape
    kv = k.shape[2]
    jcfg = dataclasses.replace(jax_reduced_config("gemma2-9b"), n_heads=h, n_kv_heads=kv,
                               head_dim=d, attn_softcap=softcap, sliding_window=window)
    wo = jnp.eye(h * d, dtype=jnp.float32).reshape(h, d, h * d)
    out = jattn._decode_attend({"wo": wo}, jnp.asarray(q)[:, None], jnp.asarray(k),
                               jnp.asarray(v), jnp.asarray(valid_len - 1), jcfg,
                               is_global=False, out_dtype=jnp.float32)
    return np.asarray(out)[:, 0]


def _attention_inputs(b=5, h=4, kv=2, d=16, l=32, bs=8, seed=0):
    rng = np.random.default_rng(seed)
    valid = np.array([1, 7, 20, 32, 13], np.int32)[:b]
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((b, l, kv, d)).astype(np.float32) * 2
    v = rng.standard_normal((b, l, kv, d)).astype(np.float32)
    nb = l // bs
    tables = (1 + rng.permutation(b * nb)).reshape(b, nb).astype(np.int32)
    pages_k = np.zeros((1 + b * nb, bs, kv, d), np.float32)
    pages_v = np.zeros_like(pages_k)
    pages_k[tables.reshape(-1)] = k.reshape(b * nb, bs, kv, d)
    pages_v[tables.reshape(-1)] = v.reshape(b * nb, bs, kv, d)
    return q, k, v, valid, pages_k, pages_v, tables


@pytest.mark.parametrize("softcap", [0.0, 50.0])
@pytest.mark.parametrize("window", [0, 5, 13], ids=["no-window", "window-lt-L",
                                                   "window-across-pages"])
@pytest.mark.parametrize("paged", [False, True])
def test_plain_decode_attention_softcap_window_matches_reference(paged, window, softcap):
    """Window 5 keeps fewer keys than every long request holds; window 13
    starts inside a page of 8 (valid_len 20: keys 7..19, across pages 0-2),
    and valid_len 7 < 13 keeps all its keys."""
    q, k, v, valid, pages_k, pages_v, tables = _attention_inputs()
    want = _decode_attend_reference(q, k, v, valid, softcap, window)
    t = torch.from_numpy
    scale = 1.0 / np.sqrt(q.shape[-1])
    if paged:
        got = paged_decode_attention_ref(t(q), t(pages_k), t(pages_v), t(tables), t(valid),
                                         scale, softcap=softcap, window=window)
    else:
        got = decode_attention_ref(t(q), t(k), t(v), t(valid), scale, softcap=softcap,
                                   window=window)
    np.testing.assert_allclose(got.reshape(len(valid), -1).numpy(), want, **TOL)


def test_window_changes_only_requests_longer_than_it():
    """The window is not a no-op: with window 5 the long requests' outputs
    move, and a request of valid_len <= 5 keeps its unwindowed output."""
    q, k, v, valid, *_ = _attention_inputs()
    t = torch.from_numpy
    full = decode_attention_ref(t(q), t(k), t(v), t(valid), 0.25)
    win = decode_attention_ref(t(q), t(k), t(v), t(valid), 0.25, window=5)
    short = torch.from_numpy(valid <= 5)
    torch.testing.assert_close(win[short], full[short])
    assert bool(((win - full).abs().amax(dim=(1, 2)) > 1e-3)[~short].all())


# ------------------------------------------------------------------- models
def _paged_from_dense(cache, lengths, bs, nb, layout):
    """Each request's dense rows copied into shuffled pages (per-token
    leaves; slot-indexed state leaves as they are) -> (paged cache, table)."""
    b = len(lengths)
    pages = np.random.default_rng(1).permutation(np.arange(1, 1 + b * nb)).reshape(b, nb)
    pages = torch.from_numpy(pages.astype(np.int32))
    out = {"stages": []}
    for st, sl in zip(cache["stages"], layout["stages"]):
        out["stages"].append({})
        for name, leaves in st.items():
            out["stages"][-1][name] = {}
            for key, t in leaves.items():
                if not sl[name][key]:
                    out["stages"][-1][name][key] = t.clone()
                    continue
                n = t.shape[0]
                rest = tuple(t.shape[3:])
                paged = torch.zeros((n, 1 + b * nb, bs) + rest, dtype=t.dtype)
                paged[:, pages.reshape(-1).long()] = t.reshape((n, b * nb, bs) + rest)
                out["stages"][-1][name][key] = paged
    return out, pages


def _assert_caches_close(tc, jc):
    want = jax.tree.leaves(_np_tree(jc))
    got = list(_leaves(tc))
    assert len(got) == len(want)
    for t, j in zip(got, want):
        np.testing.assert_allclose(t.float().numpy(), j, **TOL)


def _leaves(tree):
    """The leaves of a port tree in the order ``jax.tree.leaves`` visits the
    same tree (dict keys sorted)."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key])
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def test_prefill_and_decode_match_reference(model):
    """Prefill, then N dense and N paged decode steps (one slot inactive in
    the paged ones, routed to the null page), logits and every cache leaf
    against the reference's ``prefill`` / ``decode_step`` /
    ``decode_step_paged``; greedy tokens equal."""
    jcfg, jp, cfg, tp = model
    rng = np.random.default_rng(0)
    b, l_max, bs = 3, 64, 8
    prompts = rng.integers(1, cfg.vocab_size, (b, 12)).astype(np.int32)
    lengths = np.array([12, 7, 9], np.int32)
    jl, jc, _ = R.prefill(jp, jcfg, jnp.asarray(prompts), R.init_cache(jcfg, b, l_max),
                          prompt_lengths=jnp.asarray(lengths))
    tl, tc, _ = T.prefill(tp, cfg, torch.from_numpy(prompts),
                          T.init_cache(cfg, b, l_max, device="cpu"),
                          prompt_lengths=torch.from_numpy(lengths))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_caches_close(tc, jc)

    pc, tables = _paged_from_dense(tc, lengths, bs, l_max // bs, T.paged_layout(cfg))
    jpc = jax.tree.map(lambda t: jnp.asarray(t.numpy()), pc)
    active = np.array([True, False, True])
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    ln = lengths.copy()
    for _ in range(N_STEPS):
        jl, jc, _ = R.decode_step(jp, jcfg, jnp.asarray(tok), jc, jnp.asarray(ln))
        tl, tc, _ = T.decode_step(tp, cfg, torch.from_numpy(tok), tc, torch.from_numpy(ln))
        jpl, jpc, _ = R.decode_step_paged(jp, jcfg, jnp.asarray(tok), jpc, jnp.asarray(ln),
                                          jnp.asarray(active), jnp.asarray(tables.numpy()))
        pl, pc, _ = T.decode_step_paged(tp, cfg, torch.from_numpy(tok), pc,
                                        torch.from_numpy(ln), torch.from_numpy(active), tables)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        np.testing.assert_allclose(pl.numpy()[active], np.asarray(jpl)[active], **TOL)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        assert np.array_equal(tok, torch.argmax(tl, -1).numpy())
        ln = ln + 1
    _assert_caches_close(tc, jc)
    live = tables[torch.from_numpy(active)].reshape(-1).long()
    layout = T.paged_layout(cfg)
    for si, st in enumerate(pc["stages"]):
        for name, leaves in st.items():
            for key, t in leaves.items():
                j = np.asarray(jpc["stages"][si][name][key])
                if layout["stages"][si][name][key]:
                    t, j = t[:, live], j[:, live.numpy()]
                np.testing.assert_allclose(t.float().numpy(), j, **TOL)


def _replay(engine_cls, cfg, params, prompts, paged, **kw):
    engine = engine_cls(cfg, params, max_batch=3, max_seq_len=64, paged=paged,
                        kv_block_size=8, **kw)
    reqs = [engine.submit(p, max_new_tokens=10) for p in prompts]
    engine.run_to_completion()
    return [r.output for r in reqs], engine.stats.decode_steps


@pytest.mark.parametrize("paged", [False, True])
def test_engine_streams_match_reference(model, paged):
    """Greedy ``ServingEngine`` streams (prompts of 4-40 tokens, so some
    cross the reduced window, padded to the pool's buckets) equal the
    reference engine's, dense and paged."""
    jcfg, jp, cfg, tp = model
    prompts = make_prompts(jcfg, 4, 4, 40, seed=0)
    want = _replay(JEngine, jcfg, jp, prompts, paged)
    got = _replay(TEngine, cfg, tp, prompts, paged, device="cpu")
    assert got == want


# -------------------------------------------------------------------- MoE
def _moe_params(bias=0.0):
    jcfg, cfg = jax_reduced_config("deepseek-v2-lite-16b"), reduced_config("deepseek-v2-lite-16b")
    jp = jmoe.init_moe(jax.random.PRNGKey(3), jcfg, jnp.float32)
    jp["router"] = jp["router"].at[:, 0].add(bias)
    tp = T.params_from_numpy({"moe": _np_tree(jp)}, cfg, device="cpu")["moe"]
    return jcfg, cfg, jp, tp


@pytest.mark.parametrize("bias,tokens", [(0.0, (1, 3)), (0.0, (2, 24)), (0.1, (2, 24))],
                         ids=["decode-batch", "prefill", "capacity-drops"])
def test_moe_mlp_matches_reference(bias, tokens):
    """Output and aux loss at 1e-4. At 48 tokens the capacity is 15 (top
    2 of 8 experts, factor 1.25), and the reference drops what an expert
    gets past it. ``capacity-drops`` skews the router to expert 0 (its
    column + 0.1, inputs shifted by + 0.5), so that more than twice its
    capacity chooses it, while every token's second choice stays clear of
    its third (no near-tie for rounding to flip)."""
    jcfg, cfg, jp, tp = _moe_params(bias)
    x = np.random.default_rng(4).standard_normal(tokens + (cfg.d_model,)).astype(np.float32)
    x += 5 * bias
    jout, jaux = jmoe.moe_mlp(jp, jnp.asarray(x), jcfg)
    xt = torch.from_numpy(x)
    out = tmoe.moe_mlp(tp, xt, cfg)
    gates, _, topi = tmoe.route(tp, xt.reshape(-1, cfg.d_model), cfg)
    aux = tmoe.load_balance_loss(gates, topi)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(aux.item(), float(jaux), **TOL)
    n = tokens[0] * tokens[1]
    gates = jax.nn.softmax(jnp.asarray(x).reshape(n, -1) @ jp["router"], axis=-1)
    chosen = np.asarray(jax.lax.top_k(gates, cfg.moe_top_k)[1]).reshape(-1)
    most = np.bincount(chosen, minlength=cfg.n_routed_experts).max()
    if bias:
        assert most > 2 * tmoe._capacity(cfg, n)


# ---------------------------------------------------------------- naive MLA
def _mla_block(arch):
    jcfg, cfg = jax_reduced_config(arch), reduced_config(arch)
    if arch == "minitron-4b-mla":
        jcfg = dataclasses.replace(jcfg, q_lora_rank=24)
        cfg = dataclasses.replace(cfg, q_lora_rank=24)
    jp = jax.tree.map(lambda a: a[0], R.init_params(jcfg, jax.random.PRNGKey(1))
                      ["stages"][0]["b0"]["mla"])
    tp = T.params_from_numpy(_np_tree(jp), cfg, device="cpu")
    return jcfg, cfg, jp, tp


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "minitron-4b-mla"])
def test_naive_mla_matches_reference_and_absorbed(arch):
    """``absorb=False`` against ``repro.models.mla`` ``absorb=False``:
    prefill, then a dense and a paged decode step over the prefilled latent
    cache; and against the port's absorbed path (plain kernel versions) on
    the same inputs, all at 1e-4."""
    jcfg, cfg, jp, tp = _mla_block(arch)
    b, s, l_max, bs = 2, 10, 16, 4
    rng = np.random.default_rng(5)
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    jout, jcache = jmla.mla_prefill(jp, jnp.asarray(x), jcfg, absorb=False,
                                    cache={"ckv": jnp.zeros((b, l_max, cfg.kv_lora_rank)),
                                           "kr": jnp.zeros((b, l_max, cfg.qk_rope_head_dim))})
    cache = {"ckv": torch.zeros(b, l_max, cfg.kv_lora_rank),
             "kr": torch.zeros(b, l_max, cfg.qk_rope_head_dim)}
    out, cache = tmla.mla_prefill(tp, torch.from_numpy(x), cfg, cache=cache, absorb=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    absorbed, _ = tmla.mla_prefill(tp, torch.from_numpy(x), cfg)
    torch.testing.assert_close(out, absorbed, **TOL)
    for key in cache:
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(jcache[key]), **TOL)

    xd = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    lengths = np.array([s, s - 3], np.int32)
    jout, _ = jmla.mla_decode(jp, jnp.asarray(xd), jcache, jnp.asarray(lengths), jcfg,
                              absorb=False)
    clone = lambda c: {k: t.clone() for k, t in c.items()}
    ln = torch.from_numpy(lengths)
    naive, _ = tmla.mla_decode(tp, torch.from_numpy(xd), clone(cache), ln, cfg, absorb=False)
    absorbed, _ = tmla.mla_decode(tp, torch.from_numpy(xd), clone(cache), ln, cfg, plain=True)
    np.testing.assert_allclose(naive.numpy(), np.asarray(jout), **TOL)
    torch.testing.assert_close(naive, absorbed, **TOL)

    nb = l_max // bs
    tables = torch.arange(1, 1 + b * nb, dtype=torch.int32).flip(0).reshape(b, nb)
    pages = {k: torch.zeros((1 + b * nb, bs) + tuple(t.shape[2:])) for k, t in cache.items()}
    for k, t in cache.items():
        pages[k][tables.reshape(-1).long()] = t.reshape((b * nb, bs) + tuple(t.shape[2:]))
    active = torch.ones(b, dtype=torch.bool)
    paged, _ = tmla.mla_decode_paged(tp, torch.from_numpy(xd), pages, tables, ln, active, cfg,
                                     absorb=False)
    np.testing.assert_allclose(paged.numpy(), np.asarray(jout), **TOL)


# --------------------------------------------------------- params and kinds
def test_params_from_numpy_keeps_router_fp32_and_carries_shared_block():
    for arch, check in (("deepseek-v2-lite-16b", "router"), ("zamba2-1.2b", "shared_block")):
        jcfg = dataclasses.replace(jax_reduced_config(arch), param_dtype="bfloat16")
        cfg = dataclasses.replace(reduced_config(arch), param_dtype="bfloat16")
        jp = R.init_params(jcfg, jax.random.PRNGKey(0))
        tp = T.params_from_numpy(_np_tree(jp), cfg, device="cpu")
        shapes = lambda tree: jax.tree.map(lambda a: tuple(a.shape), tree)
        assert shapes(tp) == shapes(_np_tree(jp))
        if check == "router":
            moe = tp["stages"][1]["b0"]["moe"]
            assert moe["router"].dtype == torch.float32
            assert moe["w_gate"].dtype == torch.bfloat16
            np.testing.assert_array_equal(
                moe["router"].numpy(), np.asarray(jp["stages"][1]["b0"]["moe"]["router"]))
            ti = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
            assert ti["stages"][1]["b0"]["moe"]["router"].dtype == torch.float32
        else:
            assert set(tp["shared_block"]) == {"norm1", "attn", "norm2", "mlp"}
            assert tp["stages"][0]["b5"] == {}
            np.testing.assert_array_equal(
                tp["shared_block"]["attn"]["wq"].float().numpy(),
                np.asarray(jp["shared_block"]["attn"]["wq"].astype(jnp.float32)))


@pytest.mark.parametrize("arch", ARCHS)
def test_params_and_cache_layout_match_reference(arch):
    """Shapes of ``init_params`` / ``init_cache`` / ``init_paged_cache`` and
    ``paged_layout`` as the reference's: ``mla_moe`` keeps the latent
    leaves, ``shared_attn`` paged k/v beside slot-indexed Mamba2 state."""
    jcfg, cfg = jax_reduced_config(arch), reduced_config(arch)
    shapes = lambda tree: jax.tree.map(lambda a: tuple(a.shape), tree)
    tp = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert shapes(tp) == shapes(R.abstract_params(jcfg))
    assert shapes(T.init_cache(cfg, 2, 32, device="cpu")) == shapes(R.abstract_cache(jcfg, 2, 32))
    assert shapes(T.init_paged_cache(cfg, 2, 9, 8, device="cpu")) == \
        shapes(R.init_paged_cache(jcfg, 2, 9, 8))
    assert T.paged_layout(cfg) == R.paged_layout(jcfg)


@pytest.mark.parametrize("arch,change,match", [
    ("llama-3.2-vision-11b", {}, "cross_attn"),
    ("musicgen-large", {}, "embedding inputs"),
    ("zamba2-1.2b", {"ssm_groups": 2}, "ssm_groups=2"),
])
def test_unported_kinds_still_raise(arch, change, match):
    """``cross_attn``, embedding inputs and ``ssm_groups > 1`` are ported
    now, with the reference's param and cache shapes; zamba2-1.2b with two
    B/C groups also prefills and decodes as ``repro.models`` does (fp32
    1e-4, greedy tokens equal)."""
    cfg = dataclasses.replace(reduced_config(arch), **change)
    if match == "ssm_groups=2":
        jcfg = dataclasses.replace(jax_reduced_config(arch), **change)
        shapes = lambda tree: jax.tree.map(lambda a: tuple(a.shape), tree)
        jp = R.init_params(jcfg, jax.random.PRNGKey(0))
        tp = T.params_from_numpy(_np_tree(jp), cfg, device="cpu")
        assert shapes(tp) == shapes(R.abstract_params(jcfg))
        assert shapes(T.init_cache(cfg, 2, 32, device="cpu")) == \
            shapes(R.abstract_cache(jcfg, 2, 32))
        toks = np.random.default_rng(3).integers(1, cfg.vocab_size, (2, 12)).astype(np.int32)
        jl, jc, jlen = R.prefill(jp, jcfg, jnp.asarray(toks), R.init_cache(jcfg, 2, 32))
        tl, tc, tlen = T.prefill(tp, cfg, torch.from_numpy(toks),
                                 T.init_cache(cfg, 2, 32, device="cpu"))
        for _ in range(3):
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
            jtok = jnp.argmax(jl, -1).astype(jnp.int32)
            ttok = torch.argmax(tl, -1).to(torch.int32)
            np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
            jl, jc, jlen = R.decode_step(jp, jcfg, jtok, jc, jlen)
            tl, tc, tlen = T.decode_step(tp, cfg, ttok, tc, tlen)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
        return
    if match in ("cross_attn", "embedding inputs"):
        jcfg = jax_reduced_config(arch)
        shapes = lambda tree: jax.tree.map(lambda a: tuple(a.shape), tree)
        tp = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        assert shapes(tp) == shapes(R.abstract_params(jcfg))
        assert shapes(T.init_cache(cfg, 1, 8, device="cpu")) == \
            shapes(R.abstract_cache(jcfg, 1, 8))
        assert shapes(T.params_from_numpy(_np_tree(R.init_params(jcfg, jax.random.PRNGKey(0))),
                                          cfg, device="cpu")) == shapes(tp)
        return
    for fn in (lambda: T.init_params(cfg, torch.Generator(), device="cpu"),
               lambda: T.init_cache(cfg, 1, 8, device="cpu"),
               lambda: T.params_from_numpy({}, cfg, device="cpu")):
        with pytest.raises(NotImplementedError, match=match):
            fn()
