"""The one traffic generator: a workload file's parameters and a seed ->
the requests a run sends.

Sizes (prompt and output lengths, the first wave's remaining outputs, the
gaps between arrivals) are drawn from the mix's own ``sizes_seed``, so that
every run seed serves the same sizes in the same order and at the same
times: the amount of work is fixed by the mix. The run seed draws the
prompts' token ids (and, in the harness, the weights), so it changes every
token served but not the work. Two kinds:

* ``closed``: ``clients`` callers, each sending its next request when its
  last one finishes. The first wave starts part-way through its outputs:
  its remaining outputs are drawn uniformly from [1, output], so
  completions are staggered before the window opens.
* ``open``: Poisson arrivals at ``rate`` a second, each request due at its
  scheduled time whatever the system does.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class Item:
    prompt: np.ndarray          # (L,) int32 token ids
    max_new_tokens: int
    due_s: float = 0.0          # open loop: seconds after the window opens


def _lengths(spec: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` lengths drawn from ``spec``: ``lognormal`` (median, sigma) or
    ``uniform`` (min, max, both included), clipped to [min, max]."""
    if spec["dist"] == "lognormal":
        x = rng.lognormal(np.log(spec["median"]), spec["sigma"], n)
        return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)
    if spec["dist"] == "uniform":
        return rng.integers(spec["min"], spec["max"] + 1, n)
    raise ValueError(f"unknown length distribution {spec['dist']!r}")


class Traffic:
    """The requests of one run, drawn from ``mix`` (a workload file's
    ``traffic``) and ``seed``; token ids lie in [1, vocab)."""

    def __init__(self, mix: dict, seed: int, vocab: int, horizon_s: float = 0.0):
        self.mix = mix
        self.kind = mix["kind"]
        # one stream a field, so that the i-th request's sizes do not hang
        # on how many requests the run's horizon draws
        stream = lambda k: np.random.default_rng([mix["sizes_seed"], k])
        seed %= 2 ** 64
        self._ids = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 2])
        self.vocab = vocab
        if self.kind == "closed":
            n = mix["requests"]
            self._prompts = _lengths(mix["prompt"], n, stream(0))
            self._outputs = _lengths(mix["output"], n, stream(1))
            c = mix["clients"]
            wave_p = _lengths(mix["prompt"], c, stream(2))
            wave_o = _lengths(mix["output"], c, stream(3))
            rem = stream(4)
            wave_r = np.array([rem.integers(1, o + 1) for o in wave_o])
            self.first_wave = [self._item(int(p), int(r)) for p, r in zip(wave_p, wave_r)]
            self._next = 0
        elif self.kind == "open":
            rate = mix["rate"]
            gaps = stream(5).exponential(1.0 / rate, int(rate * horizon_s * 2) + 64)
            due = np.cumsum(gaps) - gaps[0]
            due = due[due < horizon_s]
            n = len(due)
            prompts = _lengths(mix["prompt"], n, stream(6))
            outputs = _lengths(mix["output"], n, stream(7))
            self.first_wave = []
            self.arrivals = [dataclasses.replace(self._item(int(p), int(o)), due_s=float(t))
                             for t, p, o in zip(due, prompts, outputs)]
        else:
            raise ValueError(f"unknown traffic kind {self.kind!r}")

    def _item(self, prompt_len: int, out_len: int) -> Item:
        return Item(self._ids.integers(1, self.vocab, prompt_len, dtype=np.int32), out_len)

    def next_closed(self) -> Optional[Item]:
        """The next request a closed-loop client sends (None when the
        drawn pool is spent)."""
        if self._next == len(self._prompts):
            return None
        j, self._next = self._next, self._next + 1
        return self._item(int(self._prompts[j]), int(self._outputs[j]))

    def prompt_buckets(self, max_seq_len: int) -> List[int]:
        """The power-of-2 prefill buckets this mix's prompts fall into (the
        pool pads a prompt to the next power of 2, at least 32)."""
        lo = max(self.mix["prompt"]["min"], 1)
        hi = self.mix["prompt"]["max"]
        out, b = [], 32
        while b < lo:
            b *= 2
        out.append(b)
        while b < hi:
            b *= 2
            out.append(min(b, max_seq_len))
        return sorted(set(out))
