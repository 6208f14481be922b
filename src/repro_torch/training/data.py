"""Synthetic data pipeline: deterministic document stream + sequence packing.

Offline-friendly stand-in for a real corpus with the properties that matter
to the system layers: deterministic per-(seed, shard) sampling so every data-
parallel host draws disjoint streams, document packing into fixed seq_len
rows with EOS separators, and modality synthesis for the stubbed frontends
(embeddings for [audio], encoder states for [vlm]).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.models.config import ModelConfig

EOS = 0


@dataclasses.dataclass
class DataConfig:
    seq_len: int
    batch_size: int              # per-call batch (global or per-shard)
    seed: int = 0
    shard: int = 0               # this host's shard index
    num_shards: int = 1
    mean_doc_len: int = 512


class PackedLMStream:
    """Packs synthetic documents into (batch, seq_len) token rows."""

    def __init__(self, cfg: ModelConfig, data: DataConfig):
        self.cfg = cfg
        self.data = data
        self.rng = np.random.default_rng(
            np.random.SeedSequence([data.seed, data.shard, 0xD0C5])
        )
        self._buffer = np.empty((0,), dtype=np.int32)

    def _sample_doc(self) -> np.ndarray:
        n = max(2, int(self.rng.exponential(self.data.mean_doc_len)))
        # skewed zipf-ish marginal, clipped to vocab
        toks = self.rng.zipf(1.3, size=n) % (self.cfg.vocab_size - 1) + 1
        return np.concatenate([toks.astype(np.int32), [EOS]])

    def _fill(self, need: int):
        chunks = [self._buffer]
        have = self._buffer.size
        while have < need:
            d = self._sample_doc()
            chunks.append(d)
            have += d.size
        self._buffer = np.concatenate(chunks)

    def next_batch(self) -> Dict[str, np.ndarray]:
        b, s = self.data.batch_size, self.data.seq_len
        need = b * (s + 1)
        self._fill(need)
        flat = self._buffer[:need]
        self._buffer = self._buffer[need:]
        rows = flat.reshape(b, s + 1)
        batch: Dict[str, np.ndarray] = {
            "labels": rows[:, 1:].astype(np.int32),
        }
        if self.cfg.input_is_embeddings:
            # stub frontend: deterministic embedding per token id
            emb_rng = np.random.default_rng(self.data.seed + 7)
            table = emb_rng.standard_normal((self.cfg.vocab_size, self.cfg.d_model)).astype(np.float32)
            batch["inputs"] = table[rows[:, :-1]]
        else:
            batch["inputs"] = rows[:, :-1].astype(np.int32)
        if self.cfg.n_media_tokens:
            med_rng = np.random.default_rng([self.data.seed, self.data.shard, 0x11A6E])
            batch["enc_states"] = med_rng.standard_normal(
                (b, self.cfg.n_media_tokens, self.cfg.d_model)
            ).astype(np.float32)
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()


def make_prompts(cfg: ModelConfig, n: int, min_len: int, max_len: int, seed: int = 0):
    """Variable-length prompts for the serving engine/examples."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        ln = int(rng.integers(min_len, max_len + 1))
        out.append((rng.integers(1, cfg.vocab_size, size=ln)).astype(np.int32))
    return out
