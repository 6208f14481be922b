"""The traffic generator: the same seed gives the same requests, every seed
the same set of sizes, and the sizes follow the stated distributions."""
import json
from pathlib import Path

import numpy as np
import pytest

from portbench.traffic import Traffic

WORKLOADS = Path(__file__).resolve().parent / "workloads"


def _mix(cell):
    return json.loads((WORKLOADS / f"{cell}.json").read_text())["traffic"]


def _closed(seed, n=200):
    t = Traffic(_mix("minitron-4b.decode"), seed, 256000)
    return t.first_wave, [t.next_closed() for _ in range(n)]


def test_same_seed_same_requests():
    a_wave, a = _closed(2 ** 31 + 99)
    b_wave, b = _closed(2 ** 31 + 99)
    for x, y in zip(a_wave + a, b_wave + b):
        assert np.array_equal(x.prompt, y.prompt) and x.max_new_tokens == y.max_new_tokens
    o1 = Traffic(_mix("minitron-4b.prefill"), 7, 256000, 40.0).arrivals
    o2 = Traffic(_mix("minitron-4b.prefill"), 7, 256000, 40.0).arrivals
    assert [(r.due_s, r.max_new_tokens) for r in o1] == [(r.due_s, r.max_new_tokens) for r in o2]
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(o1, o2))


def test_seeds_share_the_work_and_differ_in_tokens():
    """Every seed sends the same sizes in the same order at the same times;
    the seed draws the token ids."""
    mix = _mix("minitron-4b.decode")
    a, b = Traffic(mix, 1, 256000), Traffic(mix, 2, 256000)
    n = mix["requests"]
    ra = a.first_wave + [a.next_closed() for _ in range(n)]
    rb = b.first_wave + [b.next_closed() for _ in range(n)]
    sizes = lambda rs: [(len(r.prompt), r.max_new_tokens) for r in rs]
    assert sizes(ra) == sizes(rb)
    assert not any(np.array_equal(x.prompt, y.prompt) for x, y in zip(ra, rb))
    o = _mix("minitron-4b.prefill")
    oa, ob = Traffic(o, 1, 256000, 30.0).arrivals, Traffic(o, 2, 256000, 30.0).arrivals
    assert [(r.due_s, len(r.prompt), r.max_new_tokens) for r in oa] == \
        [(r.due_s, len(r.prompt), r.max_new_tokens) for r in ob]
    assert not any(np.array_equal(x.prompt, y.prompt) for x, y in zip(oa, ob))


def test_closed_loop_distributions():
    mix = _mix("minitron-4b.decode")
    t = Traffic(mix, 5, 256000)
    reqs = [t.next_closed() for _ in range(mix["requests"])]
    assert t.next_closed() is None
    p = np.array([len(r.prompt) for r in reqs])
    o = np.array([r.max_new_tokens for r in reqs])
    assert p.min() >= 128 and p.max() <= 1024
    assert abs(np.median(p) - 384) < 0.1 * 384
    assert o.min() >= 1024 and o.max() <= 3072
    assert abs(o.mean() - 2048) < 0.05 * 2048
    assert len(t.first_wave) == mix["clients"]
    r = np.array([w.max_new_tokens for w in t.first_wave])
    assert r.min() >= 1 and r.max() <= 3072 and r.mean() < 1536
    ids = np.concatenate([r.prompt for r in reqs])
    assert ids.min() >= 1 and ids.max() < 256000


def test_open_loop_distributions():
    mix = _mix("minitron-4b.prefill")
    arr = Traffic(mix, 3, 256000, 600.0).arrivals
    due = np.array([a.due_s for a in arr])
    assert due[0] == 0.0 and np.all(np.diff(due) >= 0) and due[-1] < 600.0
    assert abs(len(arr) / 600.0 - mix["rate"]) < 0.1 * mix["rate"]
    gaps = np.diff(due)
    assert abs(gaps.std() / gaps.mean() - 1.0) < 0.15           # exponential gaps
    p = np.array([len(a.prompt) for a in arr])
    assert p.min() >= 1024 and p.max() <= 4000 and abs(np.median(p) - 2048) < 0.1 * 2048
    o = np.array([a.max_new_tokens for a in arr])
    assert o.min() >= 16 and o.max() <= 64


def test_open_loop_sizes_do_not_hang_on_the_horizon():
    mix = _mix("minitron-4b.prefill")
    short, long = (Traffic(mix, 4, 256000, h).arrivals for h in (30.0, 33.0))
    assert len(short) < len(long)
    assert [(r.due_s, len(r.prompt), r.max_new_tokens) for r in short] == \
        [(r.due_s, len(r.prompt), r.max_new_tokens) for r in long[:len(short)]]


@pytest.mark.parametrize("cell,buckets", [("minitron-4b.decode", [128, 256, 512, 1024]),
                                          ("minitron-4b.prefill", [1024, 2048, 4096])])
def test_prompt_buckets(cell, buckets):
    t = Traffic(_mix(cell), 0, 256000, 5.0)
    assert t.prompt_buckets(4096) == buckets
