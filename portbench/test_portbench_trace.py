"""The traced run's readers on the CPU: the profiler's events read into
device operations and harness spans, and the live cache of the window's
replays."""
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from portbench import harness, trace
from portbench.test_portbench_counts import TINY


def test_profile_of_host_work_has_spans_and_no_device_time():
    x = torch.ones(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("pb.outer"):
            with record_function("pb.inner"):
                x @ x
    dev, spans = trace._events(prof)
    assert dev == []
    assert sorted(n for n, _, _ in spans) == ["pb.inner", "pb.outer"]
    assert all(a <= b for _, a, b in spans)
    assert trace.read_profile(prof, 1.0) is None


def test_gaps_are_labelled_by_the_innermost_span():
    spans = sorted([("pb.step", 0.0, 100.0), ("pb.replay", 40.0, 60.0)], key=lambda r: r[1])
    starts = [a for _, a, _ in spans]
    assert trace._label(spans, starts, 50.0) == "pb.replay"
    assert trace._label(spans, starts, 70.0) == "pb.step"
    assert trace._label(spans, starts, 150.0) == "host outside any harness span"


def test_live_cache_of_the_replays():
    # two replays: rows of 3 and 5 cached tokens, then one row of 10
    rec = {"arch": "gqa", "cfg": TINY, "replays": [(1.0, [3, 5]), (1.0, [10]), (1.0, [])]}
    out = harness.live_cache(rec)
    assert out["live_tokens_mean"] == 9.0 and out["live_tokens_peak"] == 10
    assert out["live_context_mean"] == 6.0
    # 32 bytes a token at TINY (test_gqa_step_counts)
    assert out["live_kv_bytes_mean"] == 288.0 and out["live_kv_bytes_peak"] == 320
    assert harness.live_cache({"arch": "gqa", "cfg": TINY}) == {}
