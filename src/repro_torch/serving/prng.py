"""Threefry-2x32 keys and uniform draws with ``jax.random``'s bits.

The serving pools sample at temperature > 0 with the reference's
Gumbel-max over ``jax.random.uniform(key, logits.shape)``. This module
computes the same bits without JAX, so that a sampled replay gives the
reference's tokens:

* ``PRNGKey(seed)``: the raw key ``[0, seed mod 2^32]`` (a 32-bit seed; the
  high word is 0, as JAX makes it with 64-bit types off);
* ``split(key, num)``: ``num`` new keys, on the host (numpy, no device work);
* ``random_bits`` / ``uniform(key, shape, device=...)``: the draw, in torch
  integer ops on any device (int64 masked to 32 bits: the same bits on the
  CPU and on a card).

The layout is JAX's *partitionable* threefry (``jax_threefry_partitionable
= True``, the default since JAX 0.5): element ``i`` of a draw of ``shape``
(row-major) hashes the 64-bit counter ``i`` as the pair (hi, lo) =
``(i >> 32, i & 0xffffffff)`` under the key, and its 32 bits are the XOR of
the two output words; ``split`` hashes counters ``0 .. num - 1`` the same
way and takes the two words as the new key. ``uniform`` in fp32 puts the
top 23 bits under the exponent of 1.0 and subtracts 1: ``[0, 1)``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["PRNGKey", "split", "random_bits", "uniform", "threefry2x32"]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def PRNGKey(seed: int) -> np.ndarray:
    """The raw threefry key of a 32-bit integer seed: uint32 ``[0, seed]``."""
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 32):
        raise OverflowError(f"seed {seed} does not fit in 32 bits")
    return np.array([0, seed & _MASK], dtype=np.uint32)


def threefry2x32(k1: int, k2: int, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of the counter pairs (x0, x1)
    under the key (k1, k2), on Python integers or int64 torch tensors of
    values below 2^32 (every add and shift masked back to 32 bits). -> the
    two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)

    def rotl(v, r):
        return ((v << r) & _MASK) | (v >> (32 - r))

    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def _key_words(key) -> Tuple[int, int]:
    k = np.asarray(key, dtype=np.uint32).reshape(2)
    return int(k[0]), int(k[1])


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)`` on the host, in Python integers (a
    split of 2 keys costs tens of microseconds, no device work): uint32
    ``(num, 2)``."""
    k1, k2 = _key_words(key)
    return np.array([threefry2x32(k1, k2, i >> 32, i & _MASK) for i in range(num)],
                    dtype=np.uint32).reshape(num, 2)


def random_bits(key, shape: Sequence[int], *, device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (32-bit) as an int64 tensor of values
    in ``[0, 2^32)`` on ``device``."""
    k1, k2 = _key_words(key)
    n = int(np.prod(shape, dtype=np.int64))
    count = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(k1, k2, count >> 32, count & _MASK)
    return (b0 ^ b1).reshape(tuple(shape))


def uniform(key, shape: Sequence[int], *, device: Optional[torch.device] = None
            ) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` (fp32, ``[0, 1)``) on ``device``,
    bit for bit."""
    bits = random_bits(key, shape, device=device)
    one = (bits >> 9) | 0x3F800000
    return one.to(torch.int32).view(torch.float32) - 1.0
