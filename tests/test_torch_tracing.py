"""The serving path's tracer (``repro_torch/serving/tracing.py``).

On the CPU, on a reduced minitron-4b, dense and paged: tracing off holds no
tracer and enters no ``record_function`` range, even under the profiler;
tracing on leaves the served tokens and ``PhaseStats`` as they were; spans
nest and carry their request's uid; one ``serve.decode`` span a decode
step; the padding counter; the prefill-attention kernel's launches;
``summary``'s window; the gap labels and the gap accounting on synthetic
device regions; the arrival stamp a caller sets. On a card (marked ``gpu``): device regions timed by CUDA events and
mapped onto the host clock, against events around the graph's replays.

This file imports neither jax nor ``repro``, so it runs on a machine
without JAX:

    PYTHONPATH=src python -m pytest -m gpu --noconftest tests/test_torch_tracing.py
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config, reduced_config
from repro_torch.models import init_params
from repro_torch.models.config import StageSpec
from repro_torch.serving import ServingEngine
from repro_torch.serving.pool import _bucket
from repro_torch.serving.tracing import OUTSIDE, Tracer

CFG = reduced_config("minitron-4b")
LENGTHS = [5, 17, 33, 40, 9, 64]        # buckets 32, 32, 64, 64, 32, 64
MAX_NEW = [6, 4, 8, 5, 7, 3]


@pytest.fixture(scope="module")
def params():
    return init_params(CFG, torch.Generator("cpu").manual_seed(0), device="cpu")


def _serve(params, paged, trace):
    eng = ServingEngine(CFG, params, max_batch=3, max_seq_len=128, paged=paged,
                        kv_block_size=16, device="cpu", trace=trace)
    rng = np.random.default_rng(1)
    reqs = [eng.submit(rng.integers(1, CFG.vocab_size, n), m, eos_token_id=-1)
            for n, m in zip(LENGTHS, MAX_NEW)]
    eng.run_to_completion()
    return eng, reqs


def _spans(tr):
    """(name, start, end, parent index, uid) of each span, in start order."""
    return list(zip(tr.names, tr.starts, tr.ends, tr.parents, tr.uids))


def _stats(eng):
    """``PhaseStats`` and the pool's counters, less the two wall times."""
    s = dataclasses.asdict(eng.stats)
    del s["prefill_s"], s["decode_s"]
    return s, eng.pool.jit_dispatches, eng.pool.traffic.read_bytes, eng.pool.peak_occupancy


class _Counting(torch.profiler.record_function):
    made = 0

    def __init__(self, *a, **k):
        type(self).made += 1
        super().__init__(*a, **k)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_tracing_off_holds_no_tracer_and_enters_no_range(params, paged, monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _Counting)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _Counting)
    _Counting.made = 0
    with profile(activities=[ProfilerActivity.CPU]) as off:
        eng, _ = _serve(params, paged, trace=False)
    assert eng.tracer is None and eng.pool.tracer is None
    assert _Counting.made == 0
    assert not any(e.name.startswith("serve.") for e in off.events())
    # the same run traced: the ranges are there, named as the spans
    with profile(activities=[ProfilerActivity.CPU]) as on:
        eng, _ = _serve(params, paged, trace=True)
    assert _Counting.made == len(eng.tracer.names) > 0
    names = {e.name for e in on.events() if e.name.startswith("serve.")}
    assert names == set(eng.tracer.names)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_tracing_leaves_tokens_and_stats_unchanged(params, paged):
    off, reqs_off = _serve(params, paged, trace=False)
    on, reqs_on = _serve(params, paged, trace=True)
    assert [r.output for r in reqs_on] == [r.output for r in reqs_off]
    assert _stats(on) == _stats(off)
    assert on.tracer.kinds == [] and on.tracer.names         # no device regions on the CPU


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_spans_nest_and_carry_their_request(params, paged):
    eng, reqs = _serve(params, paged, trace=True)
    spans = _spans(eng.tracer)
    parent_of = {"serve.step": None, "serve.admit": "serve.step",
                 "serve.prefill": "serve.admit", "serve.place": "serve.admit",
                 "serve.prefill.issue": "serve.prefill", "serve.prefill.wait": "serve.prefill",
                 "serve.decode": "serve.step", "serve.decode.begin": "serve.decode",
                 "serve.decode.replay": "serve.decode", "serve.decode.finish": "serve.decode"}
    assert {s[0] for s in spans} == set(parent_of)
    for name, a, b, parent, uid in spans:
        assert a <= b
        if parent is None:
            assert parent_of[name] is None
            continue
        pname, pa, pb, _, puid = spans[parent]
        assert pname == parent_of[name] and pa <= a and b <= pb
        if name.startswith(("serve.prefill", "serve.place")):
            assert uid is not None and (pname == "serve.admit" or uid == puid)
        else:
            assert uid is None
    uids = [r.uid for r in reqs]
    for name in ("serve.prefill", "serve.prefill.issue", "serve.prefill.wait", "serve.place"):
        assert sorted(s[4] for s in spans if s[0] == name) == uids
    # every prefill is placed after it and inside the same admission
    for i, s in enumerate(spans):
        if s[0] == "serve.prefill":
            place = next(p for p in spans[i:] if p[0] == "serve.place")
            assert place[4] == s[4] and place[3] == s[3] and place[1] >= s[2]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_one_decode_span_a_step_and_the_counters(params, paged):
    eng, reqs = _serve(params, paged, trace=True)
    tr, stats = eng.tracer, eng.stats
    c = tr.summary(float("-inf"), float("inf"))["counters"]
    assert tr.names.count("serve.decode") == stats.decode_steps \
        == c["decode_steps"]
    assert c["decode_rows"] == stats.decode_tokens
    assert c["graph_captures"] == 0                  # no graph on the CPU
    assert c["prefill_calls"] == stats.prefill_calls == len(reqs)
    assert c["prefill_tokens"] == sum(LENGTHS)
    assert c["prefill_bucket_tokens"] - c["prefill_tokens"] \
        == sum(_bucket(n) - n for n in LENGTHS) == 15 + 27 + 31 + 24 + 23 + 0


@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "kernel"])
def test_prefill_counts_the_attention_kernel_launches(params, monkeypatch, kernel):
    """``prefill_attn_launches``: the prefill-attention kernel's launches
    inside each traced prefill. On the CPU the plain code attends (0); with
    the dispatch rule taking every call, one launch a self-attention layer
    (the wrapper's CPU branch counts none, so a stand-in counts them)."""
    from repro_torch.kernels import prefill_attention, prefill_attention_ref
    from repro_torch.models import attention as attn

    if kernel:
        def counted(q, k, v, *, scale, softcap, window):
            prefill_attention.launches += 1
            return prefill_attention_ref(q, k, v, scale, softcap=softcap, window=window)

        monkeypatch.setattr(attn, "prefill_kernel_takes", lambda *t: True)
        monkeypatch.setattr(attn, "prefill_attention", counted)
    before = prefill_attention.launches
    eng, reqs = _serve(params, True, trace=True)
    c = eng.tracer.summary(float("-inf"), float("inf"))["counters"]
    layers = sum(st.n_units * len(st.unit) for st in CFG.stages)
    assert c["prefill_attn_launches"] == prefill_attention.launches - before \
        == (layers * len(reqs) if kernel else 0)


def test_summary_clips_to_its_window(params):
    eng, _ = _serve(params, True, trace=True)
    tr = eng.tracer
    spans = _spans(tr)
    steps = [s for s in spans if s[0] == "serve.step"]
    t0, t1 = steps[2][1], steps[4][2]
    out = tr.summary(t0, t1)
    assert out["window_s"] == t1 - t0 and out["device"] is None
    assert out["spans"]["serve.step"]["count"] == 3
    assert out["spans"]["serve.step"]["s"] == pytest.approx(sum(s[2] - s[1] for s in steps[2:5]))
    assert out["counters"]["decode_steps"] == 3
    for name, s in out["spans"].items():
        assert s["s"] <= t1 - t0
    admitted = {s[4] for s in spans if s[0] == "serve.prefill" and t0 <= s[1] <= t1}
    assert sorted(p["uid"] for p in out["prefills"]) == sorted(admitted)
    assert all(p["issue_ms"] + p["wait_ms"] <= p["ms"] and p["device_ms"] is None
               for p in out["prefills"])
    before = tr.summary(steps[0][1] - 10.0, steps[0][1] - 5.0)
    assert before["counters"] == {} and before["spans"] == {} and before["prefills"] == []


def _scripted(times):
    it = iter(times)
    return lambda: next(it)


def test_gaps_are_labelled_by_the_innermost_span():
    # step [0, 100] holds decode [10, 60] (replay [20, 50]) and place [70, 80]
    tr = Tracer(_scripted([0.0, 10.0, 20.0, 50.0, 60.0, 70.0, 80.0, 100.0, 200.0, 210.0]),
                "cpu")
    with tr.span("serve.step"):
        with tr.span("serve.decode"):
            with tr.span("serve.decode.replay"):
                pass
        with tr.span("serve.place", 7):
            pass
    assert tr.label(30.0) == "serve.decode.replay"
    assert tr.label(55.0) == "serve.decode"
    assert tr.label(65.0) == "serve.step"
    assert tr.label(75.0) == "serve.place"
    assert tr.label(90.0) == "serve.step"
    with tr.span("serve.step"):                     # a later step, [200, 210]
        pass
    assert tr.label(150.0) == tr.label(-1.0) == OUTSIDE
    # device regions (ms from the first anchor, which sat at host 0 s; the
    # device clock 1 % slow): decode [22, 48], place [74, 78], decode
    # [101, 110], decode [120, 130]
    tr._anchors = [(0.0, 0.0), (1000.0, 1010.0)]      # 1 device ms = 1.01 host ms
    to_dev = lambda t: t / 1.01
    for kind, a, b in [("decode", 22, 48), ("place", 74, 78), ("decode", 101, 110),
                       ("decode", 120, 130)]:
        tr.kinds.append(kind)
        tr.dev_starts.append(to_dev(a))
        tr.dev_ends.append(to_dev(b))
    dev = tr._device_summary(0.0, 125.0)            # the last region clipped to 5 ms
    assert dev["busy_s"] == pytest.approx({"decode": 26 + 9 + 5, "place": 4})
    assert dev["union_s"] == pytest.approx(44.0)
    assert dev["idle_s"] == pytest.approx(81.0)
    assert sum(dev["gaps_by_label"].values()) == pytest.approx(dev["idle_s"])
    assert dev["gaps_by_label"] == pytest.approx({
        "serve.decode": 22.0,          # [0, 22] mid 11
        "serve.step": 26.0 + 23.0,     # [48, 74] mid 61 and [78, 101] mid 89.5: no child
        OUTSIDE: 10.0})                # [110, 120] mid 115
    assert dev["gaps_by_neighbours"] == pytest.approx({
        "edge>decode": 22.0, "decode>place": 26.0, "place>decode": 23.0,
        "decode>decode": 10.0})
    assert dev["step_gaps"] == 1 and dev["step_gap_s"] == pytest.approx(10.0)
    assert dev["regions"] == 4 and dev["host_s_per_device_s"] == pytest.approx(1.01e3)


def test_submit_takes_the_callers_arrival(params):
    eng = ServingEngine(CFG, params, max_batch=2, max_seq_len=128, device="cpu")
    rng = np.random.default_rng(2)
    due = eng.clock() - 0.25                 # sent late, a quarter second after it was due
    late = eng.submit(rng.integers(1, CFG.vocab_size, 12), 3, arrival_s=due)
    t = eng.clock()
    now = eng.submit(rng.integers(1, CFG.vocab_size, 12), 3)
    eng.run_to_completion()
    assert late.ledger.arrival_s == due
    assert late.ledger.queue_s == late.ledger.admitted_s - due >= 0.25
    assert late.ledger.ttft_s == late.ledger.first_token_s - due
    assert t <= now.ledger.arrival_s <= now.ledger.admitted_s


# ------------------------------------------------------------------ the card
def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run with `pytest -m gpu` on the GPU machine")


@pytest.mark.gpu
def test_device_regions_on_the_card(monkeypatch):
    """16 layers at minitron-4b's widths, batch 64, bf16: a step of about
    5 device ms, so that what a step's region holds beyond its graph replay
    (the replay's launch, some µs) stays well inside the 2 % by which the
    summed step regions may differ from events around the replays."""
    _need_card()
    cfg = dataclasses.replace(get_config("minitron-4b"),
                              stages=(StageSpec(unit=("attn",), n_units=16),))
    params = init_params(cfg, torch.Generator("cuda").manual_seed(0), device="cuda")
    rng = np.random.default_rng(0)

    def engine(trace):
        eng = ServingEngine(cfg, params, max_batch=64, max_seq_len=2048, paged=True,
                            device="cuda", trace=trace)
        for n in rng.integers(600, 1200, 64):
            eng.submit(rng.integers(1, cfg.vocab_size, n), 400, eos_token_id=-1)
        return eng

    class _CountingEvent(torch.cuda.Event):
        made = 0

        def __new__(cls, *a, **k):
            _CountingEvent.made += 1
            return super().__new__(cls, *a, **k)

    # tracing off: no event made, no range entered, even under the profiler
    monkeypatch.setattr(torch.cuda, "Event", _CountingEvent)
    monkeypatch.setattr(torch.profiler, "record_function", _Counting)
    _CountingEvent.made = _Counting.made = 0
    off = engine(False)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(4):
            off.step()
    torch.cuda.synchronize()
    assert _CountingEvent.made == 0 and _Counting.made == 0
    del off
    monkeypatch.undo()

    eng = engine(True)
    pool, tr = eng.pool, eng.tracer
    for _ in range(3):                      # admission, the eager step, the capture
        eng.step()
    replays = []
    real = pool._graph.replay

    def timed():
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        real()
        ev[1].record()
        replays.append(ev)

    pool._graph.replay = timed
    torch.cuda.synchronize()
    t0, first = pool.clock(), len(tr.kinds)
    for i in range(40):
        if i % 10 == 5:                     # an admission in the window: finish a row
            pool.slot_req[i].max_new_tokens = len(pool.slot_req[i].output) + 1
            eng.submit(rng.integers(1, cfg.vocab_size, 900), 50, eos_token_id=-1)
        eng.step()
    torch.cuda.synchronize()
    t1 = pool.clock()
    out = tr.summary(t0, t1)
    dev = out["device"]

    assert all(a is not None and b >= a for a, b in zip(tr.dev_starts, tr.dev_ends))
    assert dev["untimed_regions"] == 0
    host = tr.host_times()
    assert np.all(np.diff(host.ravel()) >= 0)                  # monotone, and no overlap
    window = host[first:]
    assert window.min() >= t0 and window.max() <= t1
    assert dev["step_gaps"] > 0 and dev["step_gap_s"] >= 0
    assert all(g >= 0 for g in dev["gaps_by_label"].values())
    assert sum(dev["gaps_by_label"].values()) == pytest.approx(dev["idle_s"], rel=1e-9)
    assert dev["busy_s"]["prefill"] > 0 and dev["busy_s"]["place"] > 0
    assert out["counters"]["decode_steps"] == 40 and out["counters"]["graph_captures"] == 0
    assert all(p["device_ms"] is not None and p["device_ms"] > 0 for p in out["prefills"])
    # every prefill of the window attends through the kernel, once a layer
    assert out["counters"]["prefill_calls"] > 0
    assert out["counters"]["prefill_attn_launches"] == 16 * out["counters"]["prefill_calls"]

    steps = [b - a for k, a, b in zip(tr.kinds[first:], tr.dev_starts[first:],
                                      tr.dev_ends[first:]) if k == "decode"]
    rep = [a.elapsed_time(b) for a, b in replays]
    assert len(steps) == len(rep) == 40
    assert all(s >= r - 1e-3 for s, r in zip(steps, rep))     # a region holds its replay
    assert abs(sum(steps) - sum(rep)) <= 0.02 * sum(rep)
