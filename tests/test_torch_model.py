"""The port's model against ``repro.models`` on reduced configs.

Weights come from ``repro.models.init_params`` and cross through numpy
(``params_from_numpy``). The same numpy prompts go through both packages:
prefill logits, then N dense and N paged decode steps, all in fp32. The
tolerance 1e-4 (atol and rtol) covers summation order only: both sides do
the same fp32 arithmetic, but XLA and PyTorch block their matmuls and
reductions differently on the CPU (observed differences are ~1e-6).
Greedy tokens must be equal, and the port's paged path must give its dense
path's logits. ``minitron-4b`` runs GQA with a squared-ReLU MLP and an
untied table; ``minitron-4b-mla`` runs the absorbed MLA block (latent cache
``{"ckv", "kr"}``), also with a low-rank query (``q_lora_rank``);
``nemotron-4-15b`` runs GQA (G 6 at full width) with a squared-ReLU MLP;
``mamba2-4b`` and ``gdn-4b`` run the recurrent blocks, whose O(1) state
(``{"ssm", "conv"}``, ``{"gdn"}``) stays slot indexed in the paged cache
(the JAX ``ssd_chunked`` against the port's sequential plain scan, the same
math in another order: still within 1e-4).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as R
from repro.configs import reduced_config as jax_reduced_config
import repro_torch.models as T
from repro_torch.configs import reduced_config
from repro_torch.models.config import ModelConfig

TOL = dict(rtol=1e-4, atol=1e-4)
N_STEPS = 4
# "<arch>+q_lora": the reduced config with a low-rank query projection
Q_LORA = 24


def _configs(arch):
    base, _, variant = arch.partition("+")
    jcfg, cfg = jax_reduced_config(base), reduced_config(base)
    if variant == "q_lora":
        jcfg = dataclasses.replace(jcfg, q_lora_rank=Q_LORA)
        cfg = dataclasses.replace(cfg, q_lora_rank=Q_LORA)
    return jcfg, cfg


def _cache_keys(cfg):
    """The cache leaf names of the first block: ("k", "v"), ("ckv", "kr"),
    ("ssm", "conv") or ("gdn",)."""
    return tuple(T.paged_layout(cfg)["stages"][0]["b0"])


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _setup(arch, b=3, l_max=64):
    jcfg, cfg = _configs(arch)
    jp = R.init_params(jcfg, jax.random.PRNGKey(0))
    tp = T.params_from_numpy(_np_tree(jp), cfg, device="cpu")
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, cfg.vocab_size, (b, 12)).astype(np.int32)
    lengths = np.array([12, 7, 9], np.int32)[:b]
    return jcfg, cfg, jp, tp, prompts, lengths


def _paged_from_dense(cache, lengths, bs, nb, layout):
    """Copy each request's dense rows into shuffled pages (per-token leaves;
    the slot-indexed state leaves are copied as they are); returns the paged
    cache and the block table (unused entries on null page 0)."""
    b = len(lengths)
    rng = np.random.default_rng(1)
    pages = rng.permutation(np.arange(1, 1 + b * nb)).reshape(b, nb).astype(np.int32)
    out = {"stages": []}
    for st, sl in zip(cache["stages"], layout["stages"]):
        blk = {}
        for name, kv in st.items():
            blk[name] = {}
            for key, t in kv.items():
                if not sl[name][key]:
                    blk[name][key] = t.clone()
                    continue
                n_units = t.shape[0]
                paged = torch.zeros((n_units, 1 + b * nb, bs) + tuple(t.shape[3:]), dtype=t.dtype)
                rows = t.reshape(n_units, b, nb, bs, *t.shape[3:])
                paged[:, torch.from_numpy(pages.reshape(-1)).long()] = rows.reshape(
                    n_units, b * nb, bs, *t.shape[3:])
                blk[name][key] = paged
        out["stages"].append(blk)
    return out, torch.from_numpy(pages)


# bf16 at the repo's bf16 tolerance (tests/test_kernels.py): the blocked
# form rounds p to bf16 per 512-key block, the naive form once over all keys
BUCKET_TOL = {"float32": TOL, "bfloat16": dict(rtol=2e-2, atol=2e-2)}


@pytest.mark.parametrize("arch,dtype", [
    pytest.param("gemma-2b", "float32", id="gemma-2b"),
    pytest.param("minitron-4b-mla", "float32", id="minitron-4b-mla"),
    pytest.param("gemma-2b", "bfloat16", id="gemma-2b-bf16"),
    pytest.param("minitron-4b-mla", "bfloat16", id="minitron-4b-mla-bf16"),
])
def test_prefill_at_bucket_1024_matches_reference_flash_branch(arch, dtype):
    """A 700-token prompt padded with token 0 to the pool's 1024 bucket, as
    the pool pads it: the reference prefill attends by its blocked
    ``flash_attention`` (S >= FLASH_SEQ_THRESHOLD, 512-key blocks), the
    port by its naive form. fp32: last-token logits and the cache rows at
    1e-4. bf16 (params and compute): last-token logits at 2e-2, argmax
    equal."""
    from repro.models.flash import FLASH_SEQ_THRESHOLD
    from repro_torch.serving.pool import _bucket

    jcfg, cfg = _configs(arch)
    jcfg = dataclasses.replace(jcfg, param_dtype=dtype, compute_dtype=dtype)
    cfg = dataclasses.replace(cfg, param_dtype=dtype, compute_dtype=dtype)
    tol = BUCKET_TOL[dtype]
    jp = R.init_params(jcfg, jax.random.PRNGKey(0))
    tp = T.params_from_numpy(_np_tree(jp), cfg, device="cpu")
    n = 700
    s = _bucket(n)
    assert s == FLASH_SEQ_THRESHOLD
    tokens = np.zeros((1, s), np.int32)
    tokens[0, :n] = np.random.default_rng(3).integers(1, cfg.vocab_size, n)
    lengths = np.array([n], np.int32)
    jl, jc, _ = R.prefill(jp, jcfg, jnp.asarray(tokens), R.init_cache(jcfg, 1, s),
                          prompt_lengths=jnp.asarray(lengths))
    tl, tc, _ = T.prefill(tp, cfg, torch.from_numpy(tokens), T.init_cache(cfg, 1, s, device="cpu"),
                          prompt_lengths=torch.from_numpy(lengths))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
    assert np.array_equal(tl.argmax(-1).numpy(), np.asarray(jl).argmax(-1))
    if dtype == "bfloat16":
        return              # the second unit's rows carry the first's rounding
    for key in _cache_keys(cfg):
        np.testing.assert_allclose(tc["stages"][0]["b0"][key][:, :, :n].numpy(),
                                   np.asarray(jc["stages"][0]["b0"][key])[:, :, :n], **TOL)


@pytest.mark.parametrize("arch", ["gemma-2b", "qwen3-4b", "minitron-4b", "minitron-4b-mla",
                                  "minitron-4b-mla+q_lora", "mamba2-4b", "gdn-4b",
                                  "nemotron-4-15b"])
def test_prefill_and_decode_match_reference(arch):
    jcfg, cfg, jp, tp, prompts, lengths = _setup(arch)
    keys = _cache_keys(cfg)
    b, l_max, bs = len(lengths), 64, 8
    jl, jc, _ = R.prefill(jp, jcfg, jnp.asarray(prompts), R.init_cache(jcfg, b, l_max),
                          prompt_lengths=jnp.asarray(lengths))
    tl, tc, _ = T.prefill(tp, cfg, torch.from_numpy(prompts),
                          T.init_cache(cfg, b, l_max, device="cpu"),
                          prompt_lengths=torch.from_numpy(lengths))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tc["stages"][0]["b0"][keys[0]].numpy(),
                               np.asarray(jc["stages"][0]["b0"][keys[0]]), **TOL)

    pc, tables = _paged_from_dense(tc, lengths, bs, l_max // bs, T.paged_layout(cfg))
    active = torch.ones(b, dtype=torch.bool)
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    assert np.array_equal(tok, torch.argmax(tl, -1).numpy())
    ln = lengths.copy()
    for _ in range(N_STEPS):
        jl, jc, _ = R.decode_step(jp, jcfg, jnp.asarray(tok), jc, jnp.asarray(ln))
        tl, tc, _ = T.decode_step(tp, cfg, torch.from_numpy(tok), tc, torch.from_numpy(ln))
        pl, pc, _ = T.decode_step_paged(tp, cfg, torch.from_numpy(tok), pc,
                                        torch.from_numpy(ln), active, tables)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        torch.testing.assert_close(pl, tl, rtol=1e-6, atol=1e-6)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        assert np.array_equal(tok, torch.argmax(tl, -1).numpy())
        assert np.array_equal(tok, torch.argmax(pl, -1).numpy())
        ln = ln + 1
    np.testing.assert_allclose(tc["stages"][0]["b0"][keys[-1]].numpy(),
                               np.asarray(jc["stages"][0]["b0"][keys[-1]]), **TOL)


def test_paged_decode_matches_reference_paged_step():
    """The reference's own ``decode_step_paged`` on the same paged cache,
    with one inactive slot routed to the null page."""
    _check_reference_paged_step("gemma-2b")


def test_mla_paged_decode_matches_reference_paged_step():
    """The same for absorbed MLA: the latent pages ``ckv`` and ``kr``."""
    _check_reference_paged_step("minitron-4b-mla")


def _check_reference_paged_step(arch):
    jcfg, cfg, jp, tp, prompts, lengths = _setup(arch)
    first = _cache_keys(cfg)[0]
    b, l_max, bs = len(lengths), 64, 8
    tl, tc, _ = T.prefill(tp, cfg, torch.from_numpy(prompts),
                          T.init_cache(cfg, b, l_max, device="cpu"),
                          prompt_lengths=torch.from_numpy(lengths))
    pc, tables = _paged_from_dense(tc, lengths, bs, l_max // bs, T.paged_layout(cfg))
    jpc = jax.tree.map(lambda t: jnp.asarray(t.numpy()), pc)
    active = np.array([True, False, True])
    tok = torch.argmax(tl, -1).to(torch.int32).numpy()
    jl, jpc, _ = R.decode_step_paged(jp, jcfg, jnp.asarray(tok), jpc, jnp.asarray(lengths),
                                     jnp.asarray(active), jnp.asarray(tables.numpy()))
    pl, pc, _ = T.decode_step_paged(tp, cfg, torch.from_numpy(tok), pc,
                                    torch.from_numpy(lengths), torch.from_numpy(active), tables)
    np.testing.assert_allclose(pl.numpy()[active], np.asarray(jl)[active], **TOL)
    live = tables[active].reshape(-1).long()
    np.testing.assert_allclose(pc["stages"][0]["b0"][first][:, live].numpy(),
                               np.asarray(jpc["stages"][0]["b0"][first])[:, live.numpy()],
                               **TOL)


@pytest.mark.parametrize("arch", ["mamba2-4b", "gdn-4b"])
def test_recurrent_params_and_cache_layout_match_reference(arch):
    """State leaves (n_units, B, ...) in both layouts, never paged."""
    _check_layout(arch)
    _, cfg = _configs(arch)
    layout = T.paged_layout(cfg)["stages"][0]["b0"]
    assert not any(layout.values())
    paged = T.init_paged_cache(cfg, 3, 9, 8, device="cpu")["stages"][0]["b0"]
    assert all(t.shape[:2] == (cfg.stages[0].n_units, 3) for t in paged.values())


def _check_layout(arch):
    """Params, cache and paged-cache shapes and ``paged_layout`` as JAX's."""
    jcfg, cfg = _configs(arch)
    jp = R.abstract_params(jcfg)
    tp = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    shapes = lambda tree: jax.tree.map(lambda a: tuple(a.shape), tree)
    assert shapes(tp) == shapes(jp)
    jc = R.abstract_cache(jcfg, 2, 32)
    assert shapes(T.init_cache(cfg, 2, 32, device="cpu")) == shapes(jc)
    jpc = R.init_paged_cache(jcfg, 2, 9, 8)
    assert shapes(T.init_paged_cache(cfg, 2, 9, 8, device="cpu")) == shapes(jpc)
    assert T.paged_layout(cfg) == R.paged_layout(jcfg)


@pytest.mark.parametrize("arch", ["minitron-4b-mla", "minitron-4b-mla+q_lora"])
def test_mla_params_and_cache_layout_match_reference(arch):
    _check_layout(arch)
    # init scales: w_dkv ~ N(0, 1/d), w_uk ~ N(0, 1/rank) (reduced d 64, rank 32)
    _, cfg = _configs(arch)
    mla = T.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")["stages"][0]["b0"]
    assert set(mla) == {"norm1", "mla", "norm2", "mlp"}
    assert abs(mla["mla"]["w_dkv"].std().item() * 8.0 - 1.0) < 0.1
    assert abs(mla["mla"]["w_uk"].std().item() * np.sqrt(32) - 1.0) < 0.1


def test_params_and_cache_layout_match_reference():
    cfg = reduced_config("gemma-2b")
    _check_layout("gemma-2b")
    # init scales: wq ~ N(0, 1/d), embedding ~ N(0, 0.02^2)
    full = T.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    assert abs(full["stages"][0]["b0"]["attn"]["wq"].std().item() * 8.0 - 1.0) < 0.1
    assert abs(full["embed"]["table"].std().item() / 0.02 - 1.0) < 0.1


def test_cache_bridge_roundtrips_bf16():
    jcfg = dataclasses.replace(jax_reduced_config("gemma-2b"), compute_dtype="bfloat16")
    jc = jax.tree.map(lambda a: a + 1.5, R.init_cache(jcfg, 1, 4))
    tc = T.cache_from_numpy(_np_tree(jc), device="cpu")
    assert tc["stages"][0]["b0"]["k"].dtype == torch.bfloat16
    assert tuple(tc["stages"][0]["b0"]["k"].shape) == tuple(jc["stages"][0]["b0"]["k"].shape)
    assert bool((tc["stages"][0]["b0"]["v"] == 1.5).all())


@pytest.mark.parametrize("arch,what", [("gemma2-9b", "ported"), ("zamba2-1.2b", "ported"),
                                       ("deepseek-v2-lite-16b", "ported"),
                                       ("minitron-4b-mla", "ported"),
                                       ("mamba2-780m", "ported"), ("gdn-4b", "ported"),
                                       ("llama-3.2-vision-11b", "cross_attn"),
                                       ("musicgen-large", "embedding inputs")])
def test_unsupported_features_raise(arch, what):
    """Every feature of these configs is ported: the softcap and the
    sliding window (gemma2-9b), shared_attn (zamba2), mla_moe
    (deepseek-v2-lite), mla (absorbed), ssm, gdn, and now cross_attn blocks
    (decoding over the encoder k/v a prefill cached) and embedding inputs
    (a decode step takes a (B, 1, d) row). A decode step from an empty
    cache gives finite logits."""
    cfg = reduced_config(arch)
    tp = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    cache = T.init_cache(cfg, 1, 16, device="cpu")
    token = (torch.ones(1, 1, cfg.d_model) if what == "embedding inputs"
             else torch.zeros(1, dtype=torch.int32))
    if what == "cross_attn":
        _, cache, _ = T.prefill(tp, cfg, torch.ones(1, 1, dtype=torch.int32), cache,
                                enc_states=torch.ones(1, cfg.n_media_tokens, cfg.d_model))
    logits, _, _ = T.decode_step(tp, cfg, token, cache, torch.zeros(1, dtype=torch.int32))
    assert tuple(logits.shape) == (1, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())


def test_cuda_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg = reduced_config("gemma-2b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.init_cache(cfg, 1, 8)
    assert isinstance(cfg, ModelConfig)
