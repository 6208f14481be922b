"""The port's threefry keys and draws against ``jax.random``, bit for bit.

``repro_torch.serving.prng`` gives the serving pools the reference's
sampling bits without JAX: ``PRNGKey``, ``split`` (on the host) and
``uniform`` / ``random_bits`` (torch integer ops). Here they are held to
this box's ``jax.random`` (partitionable threefry, the default) over
several seeds, shapes and split chains, and the pool's sampling is held to
the reference's ``_sample`` on the same logits and key.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving.pool import Pool as JPool
from repro_torch.serving import prng
from repro_torch.serving.pool import Pool

SEEDS = (0, 1, 7, 42, 2**31 - 1, -1, 123456789)
SHAPES = ((), (1,), (5,), (3, 7), (2, 3, 4), (8, 2561))


def test_the_layout_is_the_partitionable_one():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_equals_jax(seed):
    np.testing.assert_array_equal(prng.PRNGKey(seed), np.asarray(jax.random.PRNGKey(seed)))


def test_prng_key_refuses_a_seed_past_32_bits():
    with pytest.raises(OverflowError):
        prng.PRNGKey(1 << 32)


@pytest.mark.parametrize("num", [1, 2, 3, 8])
@pytest.mark.parametrize("seed", SEEDS[:4])
def test_split_chains_equal_jax(seed, num):
    """Ten splits in a chain, each time taking one of the new keys on."""
    key, jkey = prng.PRNGKey(seed), jax.random.PRNGKey(seed)
    for i in range(10):
        got, want = prng.split(key, num), np.asarray(jax.random.split(jkey, num))
        assert got.dtype == np.uint32 and got.shape == (num, 2)
        np.testing.assert_array_equal(got, want)
        key, jkey = got[i % num], want[i % num]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_and_bits_equal_jax(seed, shape):
    key = prng.split(prng.PRNGKey(seed))[1]
    jkey = jax.random.split(jax.random.PRNGKey(seed))[1]
    u = prng.uniform(key, shape).numpy()
    want = np.asarray(jax.random.uniform(jkey, shape))
    assert u.dtype == np.float32 and u.shape == want.shape
    np.testing.assert_array_equal(u.view(np.uint32), want.view(np.uint32))
    bits = prng.random_bits(key, shape).numpy()
    np.testing.assert_array_equal(bits.astype(np.uint32), np.asarray(jax.random.bits(jkey, shape)))
    assert bits.min(initial=0) >= 0 and bits.max(initial=0) < 2**32


def test_the_pool_key_chain_is_the_reference_chain():
    """A pool's key after a decode split and a prefill split is the
    reference's ``PRNGKey(rng_seed)`` split twice."""
    key = prng.PRNGKey(3)
    jkey = jax.random.PRNGKey(3)
    for _ in range(2):
        key, sub = prng.split(key)
        jkey, jsub = jax.random.split(jkey)
        np.testing.assert_array_equal(sub, np.asarray(jsub))
    np.testing.assert_array_equal(key, np.asarray(jkey))


@pytest.mark.parametrize("temps", [(0.0, 0.7, 0.0, 1.3), (0.7, 0.7, 0.7, 0.7), (0.0,) * 4])
def test_sample_equals_the_reference(temps):
    """``Pool._sample`` on (4, 512) logits and a key: the reference's
    tokens (Gumbel-max at each slot's temperature, argmax at 0)."""
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((4, 512)).astype(np.float32) * 3
    temp = np.asarray(temps, np.float32)
    for seed in range(5):
        key = prng.split(prng.PRNGKey(seed))[1]
        jkey = jax.random.split(jax.random.PRNGKey(seed))[1]
        want = np.asarray(JPool._sample(jnp.asarray(logits), jkey, jnp.asarray(temp)))
        pool = Pool.__new__(Pool)
        pool.device = torch.device("cpu")
        lg = torch.from_numpy(logits)
        got = pool._sample(lg, torch.argmax(lg, -1).to(torch.int32), temp, key)
        np.testing.assert_array_equal(got.numpy(), want)


def test_a_greedy_step_draws_nothing(monkeypatch):
    """The all-greedy batch never reaches the draw (no device work)."""
    def boom(*a, **k):
        raise AssertionError("drew bits for a greedy step")

    monkeypatch.setattr(prng, "uniform", boom)
    pool = Pool.__new__(Pool)
    pool.device = torch.device("cpu")
    lg = torch.randn(2, 16)
    greedy = torch.argmax(lg, -1).to(torch.int32)
    assert pool._sample(lg, greedy, np.zeros(2, np.float32), prng.PRNGKey(0)) is greedy
