"""Plain decode-attention versions of the port against the Pallas kernels.

The same numpy inputs go through ``repro.kernels.decode_attention`` /
``paged_decode_attention`` (interpret mode on the CPU, as
``tests/test_kernels.py`` runs them), their ``ref.py`` oracles, and the
port's wrappers, which take the plain PyTorch version on a CPU tensor.
fp32 throughout, at the kernel tolerance 5e-5. The CUDA kernels themselves
run only on a card: see ``tests/test_torch_gpu.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import (
    decode_attention as jax_decode_attention,
    decode_attention_ref as jax_decode_attention_ref,
    paged_decode_attention as jax_paged_decode_attention,
    paged_decode_attention_ref as jax_paged_decode_attention_ref,
)
from repro_torch.kernels import decode_attention, paged_decode_attention
from repro_torch.kernels.decode_attn.decode_attn import (
    MIN_SPLIT_KEYS,
    TC_MIN_SPLIT_KEYS,
    TC_TILE,
    plan,
    split_plan,
    tc_split_plan,
)
from repro_torch.kernels.decode_attn.ref import (
    decode_attention_ref,
    paged_decode_attention_ref,
)

TOL = dict(rtol=5e-5, atol=5e-5)


def _dense_inputs(seed, b, h, kv, dk, dv, l):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, dk)).astype(np.float32)
    k = rng.standard_normal((b, l, kv, dk)).astype(np.float32)
    v = rng.standard_normal((b, l, kv, dv)).astype(np.float32)
    vl = rng.integers(1, l + 1, (b,)).astype(np.int32)
    vl[0] = 1
    vl[-1] = l
    return q, k, v, vl


def _paged_inputs(seed, b, h, kv, dk, dv, bs, nb):
    """Distinct live pages per request, shuffled; null page 0 past the
    valid blocks (as ``tests/test_kernels.py::_random_tables``)."""
    rng = np.random.default_rng(seed)
    n_pages = 1 + b * nb
    q = rng.standard_normal((b, h, dk)).astype(np.float32)
    kp = rng.standard_normal((n_pages, bs, kv, dk)).astype(np.float32)
    vp = rng.standard_normal((n_pages, bs, kv, dv)).astype(np.float32)
    valid_blocks = rng.integers(1, nb + 1, (b,))
    perm = rng.permutation(np.arange(1, n_pages))
    tables = np.zeros((b, nb), np.int32)
    used = 0
    for i, n in enumerate(valid_blocks):
        tables[i, :n] = perm[used:used + n]
        used += n
    vl = np.array([(n - 1) * bs + 1 + rng.integers(0, bs) for n in valid_blocks], np.int32)
    return q, kp, vp, tables, vl


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("b,h,kv,dk,dv,l,blk", [
    (1, 4, 1, 16, 16, 64, 32),      # MQA
    (2, 8, 2, 32, 16, 128, 64),     # GQA, asymmetric dv
    (3, 6, 6, 16, 16, 96, 32),      # MHA
    (2, 4, 2, 64, 64, 256, 256),    # single block
    (2, 8, 1, 256, 256, 128, 64),   # gemma-2b heads: G=8, D=256
])
def test_plain_dense_matches_pallas_and_oracle(b, h, kv, dk, dv, l, blk):
    q, k, v, vl = _dense_inputs(b * 1000 + h, b, h, kv, dk, dv, l)
    scale = 1.0 / np.sqrt(dk)
    before = decode_attention.launches
    got = decode_attention(*_t(q, k, v, vl), scale=scale).numpy()
    assert decode_attention.launches == before           # CPU: no kernel launch
    pallas = np.asarray(jax_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(vl),
        scale=scale, block_k=blk))
    oracle = np.asarray(jax_decode_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(vl), scale))
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, oracle, **TOL)
    np.testing.assert_allclose(
        decode_attention_ref(*_t(q, k, v, vl), scale).numpy(), oracle, **TOL)


@pytest.mark.parametrize("b,h,kv,dk,dv,bs,nb", [
    (1, 4, 1, 16, 16, 8, 4),        # MQA
    (2, 8, 2, 32, 16, 16, 3),       # GQA, asymmetric dv
    (3, 6, 6, 16, 16, 8, 4),        # MHA
    (2, 8, 1, 256, 256, 16, 4),     # gemma-2b heads: G=8, D=256
])
def test_plain_paged_matches_pallas_and_oracle(b, h, kv, dk, dv, bs, nb):
    q, kp, vp, tables, vl = _paged_inputs(b * 100 + h, b, h, kv, dk, dv, bs, nb)
    scale = 1.0 / np.sqrt(dk)
    before = paged_decode_attention.launches
    got = paged_decode_attention(*_t(q, kp, vp, tables, vl), scale=scale).numpy()
    assert paged_decode_attention.launches == before
    args = [jnp.asarray(a) for a in (q, kp, vp, tables, vl)]
    pallas = np.asarray(jax_paged_decode_attention(*args, scale=scale))
    oracle = np.asarray(jax_paged_decode_attention_ref(*args, scale))
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, oracle, **TOL)
    np.testing.assert_allclose(
        paged_decode_attention_ref(*_t(q, kp, vp, tables, vl), scale).numpy(), oracle, **TOL)


def test_plain_paged_equals_plain_dense_on_gathered_pages():
    q, kp, vp, tables, vl = _paged_inputs(7, 3, 8, 2, 32, 32, 8, 5)
    qt, kpt, vpt, tt, vlt = _t(q, kp, vp, tables, vl)
    k = kpt[tt.long()].reshape(3, 40, 2, 32)
    v = vpt[tt.long()].reshape(3, 40, 2, 32)
    torch.testing.assert_close(paged_decode_attention(qt, kpt, vpt, tt, vlt, scale=0.2),
                               decode_attention(qt, k, v, vlt, scale=0.2))


@pytest.mark.parametrize("bkv,extent", [(8, 1024), (1, 64), (3, 96), (64, 4096), (8, 17)])
def test_split_plan_covers_every_key(bkv, extent):
    n_split, split_len = split_plan(bkv, extent)
    assert n_split * split_len >= extent > (n_split - 1) * split_len
    assert n_split == 1 or split_len >= MIN_SPLIT_KEYS


@pytest.mark.parametrize("bkv,extent", [(8, 1024), (1, 64), (3, 96), (64, 4096), (8, 17),
                                        (1, 32768), (10, 1000)])
def test_tc_split_plan_covers_every_key_once(bkv, extent):
    """The bf16 tensor-core kernel's plan: whole 64-key tiles, every key in exactly
    one split, no split shorter than TC_MIN_SPLIT_KEYS unless it is the only one."""
    n_split, split_len = tc_split_plan(bkv, extent)
    assert split_len % TC_TILE == 0
    assert n_split * split_len >= extent > (n_split - 1) * split_len
    assert n_split == 1 or split_len >= TC_MIN_SPLIT_KEYS


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,kv,l,bs", [(8, 1, 1024, 16), (10, 2, 1024, 8), (3, 6, 96, 32),
                                       (4, 8, 500, 32), (1, 1, 32768, 16)])
def test_plan_picks_the_design_of_the_dtype(dtype, paged, b, kv, l, bs):
    """The wrapper's choice for each (dtype, layout): bf16, dense or paged,
    runs tc_split_kernel in splits of whole TC_TILE-key tiles (the kernel
    refuses any other); fp32 the first design. Every key lies in exactly
    one split."""
    extent = -(-l // bs) * bs if paged else l            # as the wrappers pass it
    got = plan(dtype, b * kv, extent)
    if dtype == torch.bfloat16:
        assert got.kernel == "tc_split_kernel"
        assert (got.n_split, got.split_len) == tc_split_plan(b * kv, extent)
        assert got.split_len % TC_TILE == 0
    else:
        assert got.kernel == "split_kernel"
        assert (got.n_split, got.split_len) == split_plan(b * kv, extent)
    assert got.n_split * got.split_len >= extent > (got.n_split - 1) * got.split_len
