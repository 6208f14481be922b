"""The causal prefill-attention kernel (``repro_torch.kernels.prefill_attn``).

On the CPU: the plain twin ``prefill_attention_ref`` against the JAX
package's blocked attention ``repro.models.flash.flash_attention`` over the
same numpy inputs (bf16 and fp32; G 1, 3 and 8 and MQA; D 64, 128 and 256;
softcap, window and both; S off the 64-key tile, B 2); the dispatch rule of
``models.attention.attention_prefill``; the wrapper's meta branch (the dry
run's count, no launch); ``cost.causal_pairs`` against a count by hand.
On a card (marked ``gpu``): the kernel against the twin at minitron-4b's
2048 and 4096 buckets and gemma2-9b's softcap-and-window shape, and one
full-width minitron-4b prefill launching it once a layer.

JAX is imported inside the test that compares with it, so the ``gpu`` tests
run on a machine without JAX:

    PYTHONPATH=src python -m pytest -m gpu --noconftest tests/test_torch_prefill_attn.py
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import cost, prefill_attention, prefill_attention_ref
from repro_torch.launch.cost import CostCounter
from repro_torch.models import attention as attn

# (dtype, B, S, H, KV, D, softcap, window, q scale): G = H / KV; the capped
# cases scale q up so that scores reach the cap
CASES = [
    ("float32", 1, 150, 2, 2, 64, 0.0, 0, 1.0),        # G 1
    ("bfloat16", 1, 150, 2, 2, 64, 0.0, 0, 1.0),
    ("float32", 2, 96, 6, 2, 128, 0.0, 0, 1.0),        # G 3 (minitron-4b), B 2
    ("bfloat16", 2, 96, 6, 2, 128, 0.0, 0, 1.0),
    ("float32", 1, 130, 16, 2, 64, 0.0, 0, 1.0),       # G 8
    ("bfloat16", 1, 130, 16, 2, 64, 0.0, 0, 1.0),
    ("float32", 1, 70, 4, 1, 256, 0.0, 0, 1.0),        # MQA, D 256
    ("bfloat16", 1, 70, 4, 1, 256, 0.0, 0, 1.0),
    ("float32", 1, 200, 4, 2, 64, 50.0, 0, 8.0),       # softcap
    ("bfloat16", 1, 200, 4, 2, 256, 50.0, 0, 8.0),
    ("float32", 1, 200, 4, 2, 64, 0.0, 100, 1.0),      # window
    ("bfloat16", 1, 200, 4, 2, 128, 0.0, 100, 1.0),
    ("float32", 2, 600, 4, 2, 64, 50.0, 100, 8.0),     # both, two of the reference's blocks
    ("bfloat16", 2, 600, 4, 2, 64, 50.0, 100, 8.0),
]
# fp32: two summation orders. bf16: both round the output to bf16 (an ulp
# is 2^-7 of it), and the reference also rounds each 512-key block's P.V
# to bf16 before adding it (its einsum's output type), where the twin sums
# in fp32.
TOL = {"float32": dict(atol=2e-5, rtol=2e-5), "bfloat16": dict(atol=2e-2, rtol=2e-2)}


def _inputs(b, s, h, kv, d, qmul, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32) * qmul
    k = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("dtype,b,s,h,kv,d,softcap,window,qmul", CASES)
def test_twin_matches_the_reference_flash_attention(dtype, b, s, h, kv, d, softcap, window,
                                                    qmul):
    import jax.numpy as jnp

    from repro.models.flash import flash_attention

    q, k, v = _inputs(b, s, h, kv, d, qmul)
    scale = 1.0 / math.sqrt(d)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = flash_attention(*(jnp.asarray(t, dtype=jdt) for t in (q, k, v)), scale, True,
                           window, softcap)
    tdt = getattr(torch, dtype)
    got = prefill_attention_ref(*(torch.from_numpy(t).to(tdt) for t in (q, k, v)), scale,
                                softcap=softcap, window=window)
    assert got.dtype == tdt and got.shape == (b, s, h, d)
    torch.testing.assert_close(got.float(), torch.from_numpy(
        np.array(want.astype(jnp.float32))), **TOL[dtype])
    # the wrapper's CPU branch is the twin
    torch.testing.assert_close(prefill_attention(
        *(torch.from_numpy(t).to(tdt) for t in (q, k, v)), scale=scale, softcap=softcap,
        window=window), got, atol=0, rtol=0)


def _meta(b, s, h, kv, dk, dv, dtype=torch.bfloat16, grad=False, device="meta"):
    mk = lambda *shape: torch.empty(shape, dtype=dtype, device=device, requires_grad=grad)
    return mk(b, s, h, dk), mk(b, s, kv, dk), mk(b, s, kv, dv)


# (what, (q, k, v) maker, grad enabled, takes the kernel)
ROUTES = [
    ("bf16 on the card's stand-in, G 3, D 128", lambda: _meta(1, 64, 24, 8, 128, 128), True,
     True),
    ("D 64, G 1", lambda: _meta(1, 64, 8, 8, 64, 64), True, True),
    ("D 256, MQA", lambda: _meta(1, 64, 8, 1, 256, 256), True, True),
    ("needs grad, grad enabled", lambda: _meta(1, 64, 24, 8, 128, 128, grad=True), True,
     False),
    ("needs grad, under no_grad", lambda: _meta(1, 64, 24, 8, 128, 128, grad=True), False,
     True),
    ("MLA's asymmetric dims 576 / 512", lambda: _meta(1, 64, 16, 1, 576, 512), True, False),
    ("Dk != Dv", lambda: _meta(1, 64, 8, 8, 128, 64), True, False),
    ("D 96: no instantiation", lambda: _meta(1, 64, 8, 8, 96, 96), True, False),
    ("fp32", lambda: _meta(1, 64, 24, 8, 128, 128, dtype=torch.float32), True, False),
    ("bf16 on the CPU", lambda: _meta(1, 64, 24, 8, 128, 128, device="cpu"), True, False),
]


@pytest.mark.parametrize("what,make,grad,takes", ROUTES, ids=[r[0] for r in ROUTES])
def test_dispatch_rule(what, make, grad, takes):
    q, k, v = make()
    with torch.set_grad_enabled(grad):
        assert attn.prefill_kernel_takes(q, k, v) is takes


def test_plain_flag_and_the_cpu_keep_the_plain_code(monkeypatch):
    """On the CPU ``attention_prefill`` never calls the wrapper, and with
    ``plain=True`` not even where the rule would take the kernel."""
    calls = []
    monkeypatch.setattr(attn, "prefill_attention", lambda *a, **k: calls.append(1))
    q, k, v = (torch.randn(1, 20, h, 64).bfloat16() for h in (6, 2, 2))
    with torch.no_grad():
        attn.attention_prefill(q, k, v, scale=0.125)
        monkeypatch.setattr(attn, "prefill_kernel_takes", lambda *t: True)
        attn.attention_prefill(q, k, v, scale=0.125, plain=True)
        assert calls == []
        attn.attention_prefill(q, k, v, scale=0.125)
    assert calls == [1]


@pytest.mark.parametrize("s,window", [(64, 0), (333, 0), (4096, 0), (4500, 4096), (300, 100)])
def test_meta_branch_counts_the_kernel_and_launches_nothing(s, window):
    b, h, kv, d = 2, 24, 8, 128
    before = prefill_attention.launches
    with torch.no_grad(), CostCounter() as counter:
        out = attn.attention_prefill(*_meta(b, s, h, kv, d, d), scale=0.1, window=window)
    assert prefill_attention.launches == before
    assert out.device.type == "meta" and out.shape == (b, s, h, d) \
        and out.dtype == torch.bfloat16
    want = cost.prefill_attention(b, s, s, h, kv, d, d, 2, window)
    assert counter.kernels == {"prefill_attention": {"calls": 1, "bytes": want.bytes,
                                                     "ops": want.ops}}
    assert want.ops == 2 * b * h * 2 * d * cost.causal_pairs(s, s, window)


@pytest.mark.parametrize("s,l,window", [(1, 1, 0), (7, 7, 0), (7, 7, 3), (9, 5, 0), (9, 5, 2),
                                        (5, 9, 0), (5, 9, 7), (64, 64, 64), (100, 100, 1)])
def test_causal_pairs_counts_each_attended_pair(s, l, window):
    by_hand = sum(1 for i in range(s) for j in range(l)
                  if j <= i and (window == 0 or i - j < window))
    assert cost.causal_pairs(s, l, window) == by_hand


def test_minitron_4096_bucket_is_bound_by_operations():
    c = cost.prefill_attention(1, 4096, 4096, 24, 8, 128, 128, 2)
    assert c.ops == 2 * 24 * 256 * 4096 * 4097 // 2 and c.dtype == "bfloat16"
    ms, by = cost.bound_ms(c)
    assert by == "operations" and ms == pytest.approx(0.10425, rel=1e-4)


# ------------------------------------------------------------------ on a card
def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _cuda_inputs(b, s, h, kv, d, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device="cuda").bfloat16()
                 for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d)))


# minitron-4b's 2048 and 4096 buckets; gemma2-9b's local layers (softcap
# 50, window 4096) over a prompt past the window; gemma-2b (MQA, D 256);
# minicpm-2b (G 1, D 64); a batched admission (B 3) off the tile
GPU_CASES = [(1, 2048, 24, 8, 128, 0.0, 0), (1, 4096, 24, 8, 128, 0.0, 0),
             (1, 4500, 16, 8, 256, 50.0, 4096), (1, 1024, 8, 1, 256, 0.0, 0),
             (1, 1024, 36, 36, 64, 0.0, 0), (3, 333, 24, 8, 128, 0.0, 0)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,kv,d,softcap,window", GPU_CASES)
def test_kernel_matches_the_twin_on_the_card(b, s, h, kv, d, softcap, window):
    """bf16 on both sides: the kernel's running max rounds P a little
    differently from the twin's whole-row max, and both round the output
    to bf16 (an ulp of an output near 1 is 2^-7)."""
    _need_card()
    q, k, v = _cuda_inputs(b, s, h, kv, d)
    before = prefill_attention.launches
    with torch.inference_mode():
        got = prefill_attention(q, k, v, scale=1 / math.sqrt(d), softcap=softcap,
                                window=window)
        torch.cuda.synchronize()
        want = prefill_attention_ref(q, k, v, 1 / math.sqrt(d), softcap=softcap,
                                     window=window)
    assert prefill_attention.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take():
    _need_card()
    q, k, v = _cuda_inputs(1, 64, 24, 8, 128)
    with pytest.raises(TypeError):
        prefill_attention(q.float(), k, v, scale=0.1)
    with pytest.raises(ValueError):                      # D 96: no instantiation
        prefill_attention(*(t[..., :96].contiguous() for t in (q, k, v)), scale=0.1)
    with pytest.raises(ValueError):                      # not contiguous
        prefill_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, scale=0.1)
    with pytest.raises(ValueError):                      # 24 heads over 7 KV heads
        prefill_attention(q, k[:, :, :7].contiguous(), v[:, :, :7].contiguous(), scale=0.1)


@pytest.mark.gpu
def test_one_minitron_prefill_launches_the_kernel_once_a_layer():
    """A full-width bf16 minitron-4b prefill of a 2048-token prompt launches
    the kernel once for each of its 32 layers; with ``plain=True`` none,
    and the two paths' last logits agree."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_cache, init_params, prefill

    _need_card()
    cfg = get_config("minitron-4b")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    toks = torch.randint(1, cfg.vocab_size, (1, 2048), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(1))
    out = {}
    with torch.inference_mode():
        for plain in (False, True):
            before = prefill_attention.launches
            out[plain] = prefill(params, cfg, toks, init_cache(cfg, 1, 2048, device="cuda"),
                                 plain=plain)[0].float()
            torch.cuda.synchronize()
            assert prefill_attention.launches - before == (0 if plain else 32)
    # the logits of 32 bf16 layers, each path rounding P its own way
    # (chip_smoke.py's LOGIT_ATOL_BF16 for minitron-4b)
    assert (out[False] - out[True]).abs().max().item() <= 0.3
