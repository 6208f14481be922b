"""Plain MLA latent-decode versions of the port against the Pallas kernels.

The same numpy inputs go through ``repro.kernels.mla_latent_decode`` /
``mla_paged_latent_decode`` (interpret mode on the CPU, as
``tests/test_kernels.py`` runs them), their ``ref.py`` oracles, and the
port's wrappers, which take the plain PyTorch version on a CPU tensor.
fp32 throughout, at the kernel tolerance 5e-5; the fused decode (absorb
``w_uk`` -> kernel -> absorb ``w_uv`` -> ``w_o``) at 1e-4, since its three
extra products sum in another order in XLA and PyTorch. The CUDA kernels
themselves run only on a card: see ``tests/test_torch_gpu.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import (
    mla_fused_decode as jax_mla_fused_decode,
    mla_latent_decode as jax_mla_latent_decode,
    mla_latent_decode_ref as jax_mla_latent_decode_ref,
    mla_paged_fused_decode as jax_mla_paged_fused_decode,
    mla_paged_latent_decode as jax_mla_paged_latent_decode,
    mla_paged_latent_decode_ref as jax_mla_paged_latent_decode_ref,
)
from repro_torch.kernels import (
    mla_fused_decode,
    mla_latent_decode,
    mla_paged_fused_decode,
    mla_paged_latent_decode,
)
from repro_torch.kernels.mla_decode.mla_decode import (
    HEAD_GROUPS,
    TC_HEAD_GROUPS,
    TC_MIN_SPLIT_KEYS,
    TC_STEP,
    TILE_KEYS,
    head_group,
    plan,
    split_plan,
    tc_split_plan,
)
from repro_torch.kernels.mla_decode.ref import (
    mla_latent_decode_ref,
    mla_paged_latent_decode_ref,
)

TOL = dict(rtol=5e-5, atol=5e-5)
FUSED_TOL = dict(rtol=1e-4, atol=1e-4)


def _dense_inputs(seed, b, h, rank, rope, l):
    rng = np.random.default_rng(seed)
    q_lat = rng.standard_normal((b, h, rank)).astype(np.float32)
    q_rope = rng.standard_normal((b, h, rope)).astype(np.float32)
    ckv = rng.standard_normal((b, l, rank)).astype(np.float32)
    kr = rng.standard_normal((b, l, rope)).astype(np.float32)
    vl = rng.integers(1, l + 1, (b,)).astype(np.int32)
    vl[0] = 1
    vl[-1] = l
    return q_lat, q_rope, ckv, kr, vl


def _paged_inputs(seed, b, h, rank, rope, bs, nb):
    """Distinct live pages per request, shuffled; null page 0 past the
    valid blocks (as ``tests/test_kernels.py::_random_tables``)."""
    rng = np.random.default_rng(seed)
    n_pages = 1 + b * nb
    q_lat = rng.standard_normal((b, h, rank)).astype(np.float32)
    q_rope = rng.standard_normal((b, h, rope)).astype(np.float32)
    ckv = rng.standard_normal((n_pages, bs, rank)).astype(np.float32)
    kr = rng.standard_normal((n_pages, bs, rope)).astype(np.float32)
    valid_blocks = rng.integers(1, nb + 1, (b,))
    valid_blocks[0] = 1
    valid_blocks[-1] = nb
    perm = rng.permutation(np.arange(1, n_pages))
    tables = np.zeros((b, nb), np.int32)
    used = 0
    for i, n in enumerate(valid_blocks):
        tables[i, :n] = perm[used:used + n]
        used += n
    vl = np.array([(n - 1) * bs + 1 + rng.integers(0, bs) for n in valid_blocks], np.int32)
    vl[0] = 1
    vl[-1] = nb * bs
    return q_lat, q_rope, ckv, kr, tables, vl


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("b,h,rank,rope,l,blk", [
    (2, 4, 32, 8, 64, 32),          # reduced minitron-4b-mla latent
    (3, 6, 16, 8, 96, 32),          # odd head count
    (2, 24, 64, 16, 128, 64),       # minitron-4b-mla heads
    (1, 16, 32, 8, 256, 256),       # single block
])
def test_plain_dense_matches_pallas_and_oracle(b, h, rank, rope, l, blk):
    q_lat, q_rope, ckv, kr, vl = _dense_inputs(b * 1000 + h, b, h, rank, rope, l)
    scale = 1.0 / np.sqrt(rank + rope)
    before = mla_latent_decode.launches
    got = mla_latent_decode(*_t(q_lat, q_rope, ckv, kr, vl), scale=scale).numpy()
    assert mla_latent_decode.launches == before           # CPU: no kernel launch
    args = [jnp.asarray(a) for a in (q_lat, q_rope, ckv, kr, vl)]
    pallas = np.asarray(jax_mla_latent_decode(*args, scale=scale, block_l=blk))
    oracle = np.asarray(jax_mla_latent_decode_ref(*args, scale))
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, oracle, **TOL)
    np.testing.assert_allclose(
        mla_latent_decode_ref(*_t(q_lat, q_rope, ckv, kr, vl), scale).numpy(), oracle, **TOL)


@pytest.mark.parametrize("b,h,rank,rope,bs,nb", [
    (2, 4, 32, 8, 8, 4),            # reduced minitron-4b-mla latent
    (3, 6, 16, 8, 8, 5),
    (2, 24, 64, 16, 16, 3),         # minitron-4b-mla heads
])
def test_plain_paged_matches_pallas_and_oracle(b, h, rank, rope, bs, nb):
    q_lat, q_rope, ckv, kr, tables, vl = _paged_inputs(b * 100 + h, b, h, rank, rope, bs, nb)
    scale = 1.0 / np.sqrt(rank + rope)
    before = mla_paged_latent_decode.launches
    got = mla_paged_latent_decode(*_t(q_lat, q_rope, ckv, kr, tables, vl), scale=scale).numpy()
    assert mla_paged_latent_decode.launches == before
    args = [jnp.asarray(a) for a in (q_lat, q_rope, ckv, kr, tables, vl)]
    pallas = np.asarray(jax_mla_paged_latent_decode(*args, scale=scale))
    oracle = np.asarray(jax_mla_paged_latent_decode_ref(*args, scale))
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, oracle, **TOL)
    np.testing.assert_allclose(
        mla_paged_latent_decode_ref(*_t(q_lat, q_rope, ckv, kr, tables, vl), scale).numpy(),
        oracle, **TOL)


def test_plain_paged_equals_plain_dense_on_gathered_pages():
    q_lat, q_rope, ckv, kr, tables, vl = _paged_inputs(7, 3, 8, 32, 8, 8, 5)
    ql, qr, cp, kp, tt, vlt = _t(q_lat, q_rope, ckv, kr, tables, vl)
    ckv_d = cp[tt.long()].reshape(3, 40, 32)
    kr_d = kp[tt.long()].reshape(3, 40, 8)
    torch.testing.assert_close(mla_paged_latent_decode(ql, qr, cp, kp, tt, vlt, scale=0.2),
                               mla_latent_decode(ql, qr, ckv_d, kr_d, vlt, scale=0.2))


@pytest.mark.parametrize("paged", [False, True])
def test_fused_decode_matches_reference(paged):
    """absorb(w_uk) -> latent kernel -> absorb(w_uv) -> w_o, dense and paged,
    against the JAX ``mla_fused_decode`` / ``mla_paged_fused_decode``."""
    b, h, rank, rope, nope, vdim, d = 3, 4, 32, 8, 16, 16, 64
    rng = np.random.default_rng(11)
    w_uk = (rng.standard_normal((rank, h, nope)) / np.sqrt(rank)).astype(np.float32)
    w_uv = (rng.standard_normal((rank, h, vdim)) / np.sqrt(rank)).astype(np.float32)
    w_o = (rng.standard_normal((h, vdim, d)) / np.sqrt(h * vdim)).astype(np.float32)
    q_nope = rng.standard_normal((b, h, nope)).astype(np.float32)
    scale = 1.0 / np.sqrt(nope + rope)
    if paged:
        _, q_rope, ckv, kr, tables, vl = _paged_inputs(12, b, h, rank, rope, 8, 6)
        cache = (ckv, kr, tables)
        jfn, tfn = jax_mla_paged_fused_decode, mla_paged_fused_decode
    else:
        _, q_rope, ckv, kr, vl = _dense_inputs(12, b, h, rank, rope, 40)  # L not a block multiple
        cache = (ckv, kr)
        jfn, tfn = jax_mla_fused_decode, mla_fused_decode
    arrays = (w_uk, w_uv, w_o, q_nope, q_rope) + cache + (vl,)
    want = np.asarray(jfn(*[jnp.asarray(a) for a in arrays], scale=scale))
    got = tfn(*_t(*arrays), scale=scale)
    assert tuple(got.shape) == (b, d)
    np.testing.assert_allclose(got.numpy(), want, **FUSED_TOL)
    torch.testing.assert_close(tfn(*_t(*arrays), scale=scale, plain=True), got)


@pytest.mark.parametrize("h,want", [(24, 8), (16, 16), (128, 16), (4, 4), (1, 4), (12, 4)])
def test_head_group_pads_heads_least(h, want):
    hg = head_group(h)
    assert hg == want and hg in HEAD_GROUPS


@pytest.mark.parametrize("h,want", [(24, 24), (16, 16), (128, 16), (4, 8), (1, 8), (48, 24)])
def test_tc_head_group_pads_heads_least(h, want):
    """The bf16 tensor-core kernel's head groups: one, two or three n8
    tiles of heads; minitron-4b-mla's 24 heads are one unpadded group."""
    hg = head_group(h, TC_HEAD_GROUPS)
    assert hg == want and hg in TC_HEAD_GROUPS


@pytest.mark.parametrize("ctas,extent", [(24, 1024), (8, 64), (64, 4096), (8, 17), (256, 1024)])
def test_split_plan_covers_every_key_in_whole_tiles(ctas, extent):
    n_split, split_len = split_plan(ctas, extent)
    assert n_split * split_len >= extent > (n_split - 1) * split_len
    assert split_len % TILE_KEYS == 0


@pytest.mark.parametrize("ctas,extent", [(8, 1024), (8, 128), (32, 256), (8, 17), (64, 1024)])
def test_tc_split_plan_covers_every_key_in_whole_steps(ctas, extent):
    n_split, split_len = tc_split_plan(ctas, extent)
    assert n_split * split_len >= extent > (n_split - 1) * split_len
    assert split_len % TC_STEP == 0
    assert split_len >= min(TC_MIN_SPLIT_KEYS, -(-extent // TC_STEP) * TC_STEP)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,l,bs", [(8, 24, 1024, 16), (8, 4, 128, 16), (4, 128, 256, 16),
                                      (10, 16, 1000, 8), (1, 24, 32768, 32)])
def test_plan_picks_the_design_of_the_dtype(dtype, paged, b, h, l, bs):
    """The wrapper's choice for each (dtype, layout): bf16, dense or paged,
    runs the tensor-core kernel in splits of whole TC_STEP-key steps over
    TC_HEAD_GROUPS; fp32 the first design in whole TILE_KEYS-key tiles over
    HEAD_GROUPS. Every key lies in exactly one split."""
    extent = -(-l // bs) * bs if paged else l            # as the wrappers pass it
    got = plan(dtype, b, h, extent)
    if dtype == torch.bfloat16:
        assert got.kernel == "mla_tc_split_kernel"
        assert got.head_group == head_group(h, TC_HEAD_GROUPS)
        assert (got.n_split, got.split_len) == tc_split_plan(b * -(-h // got.head_group), extent)
        assert got.split_len % TC_STEP == 0
    else:
        assert got.kernel == "mla_split_kernel"
        assert got.head_group == head_group(h)
        assert (got.n_split, got.split_len) == split_plan(b * -(-h // got.head_group), extent)
        assert got.split_len % TILE_KEYS == 0
    assert got.n_split * got.split_len >= extent > (got.n_split - 1) * got.split_len
