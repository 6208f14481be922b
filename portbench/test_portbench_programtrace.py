"""The readers of the program's trace (``programtrace.py``) on synthetic
records, and a traced turn of a tiny cell on the CPU."""
import json

import pytest

from portbench import harness, programtrace, tinycells
from portbench.programtrace import KEY, READERS, idle_events, prefill_pad_share, step_gap_ms
from portbench.stats import delta


def _summary(**device):
    return {"window_s": 10.0, "device": device or None,
            "counters": {"prefill_calls": 3, "prefill_tokens": 700,
                         "prefill_bucket_tokens": 1000}}


@pytest.mark.parametrize("name", sorted(READERS))
def test_readers_read_nothing_without_the_program_summary(name):
    assert READERS[name]({"window_s": 10.0, "tokens": 5}) is None
    assert READERS[name]({KEY: {"window_s": 10.0, "counters": {}, "device": None}}) is None


def test_readers_on_a_synthetic_summary():
    rec = {KEY: _summary(idle_s=0.5, union_s=9.5, step_gaps=4, step_gap_s=0.002)}
    assert idle_events(rec) == pytest.approx(5.0)
    assert step_gap_ms(rec) == pytest.approx(0.5)
    assert prefill_pad_share(rec) == pytest.approx(30.0)
    # no step followed another: no step gap; the CPU: no device, the counters still read
    assert step_gap_ms({KEY: _summary(idle_s=1.0, step_gaps=0, step_gap_s=0.0)}) is None
    rec = {KEY: _summary()}
    assert idle_events(rec) is None and step_gap_ms(rec) is None
    assert prefill_pad_share(rec) == pytest.approx(30.0)


def test_a_traced_turn_on_the_cpu(tmp_path):
    name = tinycells.write(tmp_path, "tp", tinycells.GQA, "gqa",
                           dict(tinycells.OPEN, rate=40.0))
    res = programtrace.turn(harness.Cell(tmp_path, name), 5, 0.5, True, False, device="cpu")
    rec = res["record"]
    c = rec[KEY]["counters"]
    assert res["correct"] and rec[KEY]["device"] is None
    # the program's counters over the window agree with PhaseStats' deltas
    assert c["decode_steps"] == delta(rec, "decode_steps") > 0
    assert c["prefill_calls"] == delta(rec, "prefill_calls") > 0
    share = prefill_pad_share(rec)
    assert 0 < share < 100
    assert share == pytest.approx((c["prefill_bucket_tokens"] - c["prefill_tokens"])
                                  / c["prefill_bucket_tokens"] * 100)
    out = programtrace.line(res, True)
    json.dumps(out)
    assert out["readings"]["prefill_pad_share.prefill"] == share
    assert out["readings"]["idle_events.decode"] is None
    assert programtrace.turn(harness.Cell(tmp_path, name), 5, 0.2, False, False,
                             device="cpu")["record"].get(KEY) is None
