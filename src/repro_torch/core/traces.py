"""Seeded arrival-trace generation for trace-driven serving.

A trace is a list of ``TracedRequest``s — (arrival time, prompt tokens,
decode budget) — that ``Cluster.run_trace`` releases into the waiting
queue as the serving clock crosses each arrival timestamp. Everything is
drawn from one ``numpy`` Generator, so a (cfg, spec, seed) triple always
produces the byte-identical trace: the determinism the virtual-time
replay's reproducibility contract rests on.

Arrival processes (the TokenPowerBench-style grid):

* ``poisson``  — homogeneous Poisson: i.i.d. exponential inter-arrivals.
* ``onoff``    — bursty ON/OFF: Poisson at an elevated rate inside ON
  windows, silence in OFF windows; mean rate matches ``rate_rps``. The
  burst shape is what exposes idle-floor energy between bursts.
* ``diurnal``  — non-homogeneous Poisson via thinning against a sinusoidal
  rate profile (a day compressed to ``period_s``); mean rate ``rate_rps``.

Length profiles (prompt length x decode budget):

* ``short_chat``   — short prompts, short answers (interactive chat).
* ``long_context`` — prompts near the context cap, few new tokens
  (retrieval / summarisation).
* ``mixed``        — ``mix_long`` fraction long-context, rest short-chat.

Every ``TracedRequest`` carries a **length-bucket tag** (``short``/``long``;
``mixed`` = unknown, for requests built outside the generator): the profile
the generator actually drew for it. Fleet routers key arch-affinity off
this trace-borne tag instead of re-thresholding prompt lengths ad hoc.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.models.config import ModelConfig

ARRIVALS = ("poisson", "onoff", "diurnal")
LENGTHS = ("short_chat", "long_context", "mixed")
# length-bucket tags: the profile a request was drawn from ("mixed" =
# unknown provenance — e.g. hand-built requests — routers fall back on it)
BUCKETS = ("short", "long", "mixed")


@dataclasses.dataclass(frozen=True)
class TracedRequest:
    """One trace entry: when it arrives and what it asks for.

    ``conv``/``parent``/``turn`` tie tree-shaped workloads together
    (conversation id, index of the parent entry in the trace list, depth in
    the tree); flat traces leave the defaults (-1, -1, 0)."""

    arrival_s: float
    prompt: np.ndarray                  # (L,) int32 token ids
    max_new_tokens: int
    temperature: float = 0.0
    bucket: str = "mixed"               # length-bucket tag, see BUCKETS
    conv: int = -1                      # conversation/tree id (-1: flat)
    parent: int = -1                    # trace index of the parent (-1: root)
    turn: int = 0                       # depth in the tree (root = 0)

    @property
    def prompt_len(self) -> int:
        return int(len(self.prompt))


# ------------------------------------------------------------ arrival times
def poisson_arrivals(n: int, rate_rps: float, rng: np.random.Generator) -> np.ndarray:
    if rate_rps <= 0:
        raise ValueError("rate_rps must be > 0")
    return np.cumsum(rng.exponential(1.0 / rate_rps, size=n))


def onoff_arrivals(
    n: int,
    rate_rps: float,
    rng: np.random.Generator,
    *,
    on_s: float = 4.0,
    off_s: float = 8.0,
) -> np.ndarray:
    """Markov-modulated bursts: all arrivals land inside ON windows at rate
    ``rate_rps * (on+off)/on`` so the long-run mean stays ``rate_rps``."""
    if rate_rps <= 0 or on_s <= 0 or off_s < 0:
        raise ValueError("rates and window lengths must be positive")
    rate_on = rate_rps * (on_s + off_s) / on_s
    period = on_s + off_s
    out = np.empty(n)
    t = 0.0
    for i in range(n):
        t += rng.exponential(1.0 / rate_on)
        # fold any spill past the ON window into the next period's ON window
        while (t % period) >= on_s:
            t = (t // period + 1.0) * period + (t % period - on_s)
        out[i] = t
    return out


def diurnal_arrivals(
    n: int,
    rate_rps: float,
    rng: np.random.Generator,
    *,
    period_s: float = 120.0,
    depth: float = 0.8,
) -> np.ndarray:
    """Thinning against rate(t) = rate_rps * (1 + depth*sin(2*pi*t/T))."""
    if not 0.0 <= depth < 1.0:
        raise ValueError("depth must be in [0, 1)")
    lam_max = rate_rps * (1.0 + depth)
    out = np.empty(n)
    t = 0.0
    i = 0
    while i < n:
        t += rng.exponential(1.0 / lam_max)
        lam_t = rate_rps * (1.0 + depth * np.sin(2.0 * np.pi * t / period_s))
        if rng.uniform() * lam_max <= lam_t:
            out[i] = t
            i += 1
    return out


_ARRIVAL_FNS: Dict[str, Callable] = {
    "poisson": poisson_arrivals,
    "onoff": onoff_arrivals,
    "diurnal": diurnal_arrivals,
}


# ---------------------------------------------------------- length profiles
def _sample_lengths(
    kind: str,
    rng: np.random.Generator,
    *,
    max_total_len: int,
    mix_long: float,
) -> Tuple[int, int, str]:
    """One (prompt_len, max_new_tokens, bucket) draw; always fits
    max_total_len. The bucket is the profile actually drawn — for "mixed"
    the per-request resolution, so routers see trace data, not thresholds.
    The draw sequence is unchanged from the pre-bucket generator: seeded
    traces stay byte-identical for every existing profile."""
    if kind == "mixed":
        kind = "long_context" if rng.uniform() < mix_long else "short_chat"
    if kind == "short_chat":
        prompt = int(rng.integers(8, min(33, max(10, max_total_len // 3))))
        new = int(rng.integers(8, 25))
    elif kind == "long_context":
        lo = max(16, int(max_total_len * 0.5))
        hi = max(lo + 1, int(max_total_len * 0.85))
        prompt = int(rng.integers(lo, hi))
        new = int(rng.integers(4, 13))
    else:
        raise ValueError(f"unknown length profile {kind!r}; have {LENGTHS}")
    new = max(1, min(new, max_total_len - prompt))
    return prompt, new, ("long" if kind == "long_context" else "short")


def generate_trace(
    cfg: ModelConfig,
    n: int,
    *,
    arrival: str = "poisson",
    lengths: str = "short_chat",
    rate_rps: float = 2.0,
    seed: int = 0,
    max_total_len: int = 128,
    mix_long: float = 0.3,
    temperature: float = 0.0,
    arrival_kwargs: Optional[dict] = None,
) -> List[TracedRequest]:
    """The seeded trace: ``n`` requests, arrival process x length profile.

    ``max_total_len`` caps prompt+decode per request so every entry is
    servable on a pool with that ``max_seq_len``. Prompt token ids avoid
    the config's EOS id so greedy replays never stop early by accident of
    the prompt distribution.
    """
    if arrival not in _ARRIVAL_FNS:
        raise ValueError(f"unknown arrival process {arrival!r}; have {ARRIVALS}")
    if lengths not in LENGTHS:
        raise ValueError(f"unknown length profile {lengths!r}; have {LENGTHS}")
    rng = np.random.default_rng(seed)
    times = _ARRIVAL_FNS[arrival](n, rate_rps, rng, **(arrival_kwargs or {}))
    out: List[TracedRequest] = []
    for i in range(n):
        prompt_len, new, bucket = _sample_lengths(
            lengths, rng, max_total_len=max_total_len, mix_long=mix_long)
        prompt = rng.integers(1, cfg.vocab_size, size=prompt_len).astype(np.int32)
        if cfg.eos_token_id != 0:
            prompt[prompt == cfg.eos_token_id] = 2 if cfg.eos_token_id == 1 else 1
        out.append(TracedRequest(
            arrival_s=float(times[i]),
            prompt=prompt,
            max_new_tokens=new,
            temperature=temperature,
            bucket=bucket,
        ))
    return out


# ------------------------------------------------------- conversation trees
def _tokens(rng: np.random.Generator, n: int, cfg: ModelConfig) -> np.ndarray:
    """``n`` seeded token ids that avoid the config's EOS id (greedy replays
    must never stop early by accident of the prompt distribution)."""
    toks = rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
    if cfg.eos_token_id != 0:
        toks[toks == cfg.eos_token_id] = 2 if cfg.eos_token_id == 1 else 1
    return toks


def _draw(rng: np.random.Generator, lo_hi: Tuple[int, int]) -> int:
    lo, hi = lo_hi
    if not 0 <= lo <= hi:
        raise ValueError(f"need 0 <= lo <= hi, got {lo_hi}")
    return int(rng.integers(lo, hi + 1))


def _sort_tree(out: List[TracedRequest]) -> List[TracedRequest]:
    """Stable-sort a tree trace by arrival and remap ``parent`` indices to
    the sorted positions (parents always arrive strictly first, so every
    remapped parent index precedes its child)."""
    order = sorted(range(len(out)), key=lambda i: (out[i].arrival_s, i))
    remap = {old: new for new, old in enumerate(order)}
    return [dataclasses.replace(
        out[old], parent=remap[out[old].parent] if out[old].parent >= 0 else -1)
        for old in order]


def generate_conversation_trace(
    cfg: ModelConfig,
    conversations: int,
    *,
    turns: int = 4,
    system_len: int = 48,
    user_len: Tuple[int, int] = (8, 24),
    max_new_tokens: Tuple[int, int] = (6, 14),
    think_s: Tuple[float, float] = (2.0, 4.0),
    start_gap_s: float = 1.0,
    seed: int = 0,
    max_total_len: int = 128,
    temperature: float = 0.0,
) -> List[TracedRequest]:
    """Multi-turn chat as a prefix-sharing workload: each conversation is a
    chain of requests whose prompt is the WHOLE prior prompt plus a fresh
    user turn, so turn k's prompt extends turn k-1's byte-for-byte — the
    trunk a shared-prefix cache serves from registered pages. (Assistant
    replies are not folded back into later prompts: the trace is
    model-independent, so reuse is metered on the prompt trunk only.)

    Turn k arrives a drawn ``think_s`` gap after turn k-1 — user think time,
    sized so on the reduced virtual-time replays the parent has finished
    (and donated its pages) before the child lands. A chain stops early
    when the next prompt would not fit ``max_total_len`` with its decode
    budget. Conversations start ``start_gap_s`` apart. One seeded Generator
    drives every draw: (cfg, args, seed) -> byte-identical trace.
    """
    if conversations < 1 or turns < 1:
        raise ValueError("need conversations >= 1 and turns >= 1")
    if system_len < 1:
        raise ValueError("system_len must be >= 1")
    rng = np.random.default_rng(seed)
    out: List[TracedRequest] = []
    for c in range(conversations):
        t = c * start_gap_s
        prompt = _tokens(rng, system_len + _draw(rng, user_len), cfg)
        parent = -1
        for k in range(turns):
            new = _draw(rng, max_new_tokens)
            if len(prompt) + new > max_total_len:
                break
            out.append(TracedRequest(
                arrival_s=float(t), prompt=prompt, max_new_tokens=new,
                temperature=temperature, bucket="short",
                conv=c, parent=parent, turn=k,
            ))
            parent = len(out) - 1
            t += float(rng.uniform(*think_s))
            prompt = np.concatenate([prompt, _tokens(rng, _draw(rng, user_len), cfg)])
    return _sort_tree(out)


def generate_fanout_trace(
    cfg: ModelConfig,
    trunks: int,
    *,
    fanout: int = 4,
    trunk_len: int = 56,
    child_suffix: Tuple[int, int] = (0, 8),
    max_new_tokens: Tuple[int, int] = (6, 14),
    gap_s: Tuple[float, float] = (2.0, 3.0),
    start_gap_s: float = 1.0,
    seed: int = 0,
    max_total_len: int = 128,
    temperature: float = 0.0,
) -> List[TracedRequest]:
    """Agentic fan-out: one trunk request, then ``fanout`` children whose
    prompts all start with the IDENTICAL trunk tokens plus a short drawn
    suffix — ``child_suffix`` may draw 0, the exact-fork case where the
    child's first divergent token is its first *decode* write into the
    trunk's shared tail block (the copy-on-write split path). Children
    arrive a drawn ``gap_s`` after the trunk (it has finished and donated
    its pages by then on the reduced replays); siblings land in drawn-gap
    order. Seeded and byte-deterministic like every generator here."""
    if trunks < 1 or fanout < 1:
        raise ValueError("need trunks >= 1 and fanout >= 1")
    if trunk_len < 1:
        raise ValueError("trunk_len must be >= 1")
    rng = np.random.default_rng(seed)
    out: List[TracedRequest] = []
    for c in range(trunks):
        t0 = c * start_gap_s
        trunk = _tokens(rng, trunk_len, cfg)
        new = _draw(rng, max_new_tokens)
        new = max(1, min(new, max_total_len - trunk_len))
        out.append(TracedRequest(
            arrival_s=float(t0), prompt=trunk, max_new_tokens=new,
            temperature=temperature, bucket="short",
            conv=c, parent=-1, turn=0,
        ))
        root = len(out) - 1
        for _ in range(fanout):
            sfx = _draw(rng, child_suffix)
            prompt = (np.concatenate([trunk, _tokens(rng, sfx, cfg)])
                      if sfx else trunk.copy())
            new = _draw(rng, max_new_tokens)
            new = max(1, min(new, max_total_len - len(prompt)))
            out.append(TracedRequest(
                arrival_s=float(t0 + rng.uniform(*gap_s)),
                prompt=prompt, max_new_tokens=new,
                temperature=temperature, bucket="short",
                conv=c, parent=root, turn=1,
            ))
    return _sort_tree(out)
