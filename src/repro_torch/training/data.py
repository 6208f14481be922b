"""Synthetic prompts for the serving engine (``make_prompts`` copied from
``repro.training.data``)."""
from __future__ import annotations

import numpy as np

from repro_torch.models.config import ModelConfig


def make_prompts(cfg: ModelConfig, n: int, min_len: int, max_len: int, seed: int = 0):
    """Variable-length prompts for the serving engine/examples."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        ln = int(rng.integers(min_len, max_len + 1))
        out.append((rng.integers(1, cfg.vocab_size, size=ln)).astype(np.int32))
    return out
