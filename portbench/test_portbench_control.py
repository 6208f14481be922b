"""The check has to fail what is wrong: the fp8 control put in the
program's place, and a run whose timed path is broken underneath (the
harness drives the rest of the run on the CPU, with no look for a chip).
An open loop fast enough to keep every row busy, every request compared:
each arrives after the fault is in place and is served to its end,
whatever the CPU's speed."""
import time

import pytest
import torch

from portbench import harness, tinycells


MIX = dict(tinycells.OPEN, rate=100.0, output={"dist": "uniform", "min": 20, "max": 40})


def _cell(root):
    return harness.Cell(root, tinycells.write(root, "tc", tinycells.GQA, "gqa", MIX,
                                              sample=1000))


@pytest.mark.parametrize("seed", [21, 22, 23])
def test_control_reads_above_the_limit(tmp_path, seed):
    res = harness.run_cell(_cell(tmp_path), seed, 0.4, False, time.perf_counter(),
                           device="cpu", control=True)
    chk = res["check"]
    assert chk["requests_compared"] == res["attempted"] >= 30
    assert res["correct"] and chk["logit_gap"] < 1e-4
    assert chk["control_gap"] > 10 * chk["limit"]


def _state_unchanged(sess):
    """The decode step writes no new K/V row: the cache is left as it was."""
    from repro_torch.models import attention
    sess.undo.append((attention, "_write_token", attention._write_token))
    attention._write_token = lambda *a, **k: None


def _half_batch(sess):
    """Half of the rows are left out: they take the mean of the others'
    logits."""
    pool = sess.pool
    real = pool._decode_fn

    def fn():
        logits, _ = real()
        h = logits.shape[0] // 2
        logits[h:] = logits[:h].mean(0)
        return logits, torch.argmax(logits, dim=-1).to(torch.int32)

    pool._decode_fn = fn


def _token_altered(sess):
    """Every second step's sampled tokens are changed where the step
    produces them."""
    pool = sess.pool
    real = pool._sample
    steps = [0]

    def sample(*a, **k):
        out = real(*a, **k)
        steps[0] += 1
        return (out + 1) % sess.mc.vocab_size if steps[0] % 2 else out

    pool._sample = sample


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _token_altered])
def test_a_broken_timed_path_is_not_correct(tmp_path, fault):
    undo = []

    def before(sess):
        sess.undo = undo
        fault(sess)

    try:
        res = harness.run_cell(_cell(tmp_path), 31, 0.4, False, time.perf_counter(),
                               device="cpu", before_window=before)
    finally:
        for mod, attr, val in undo:
            setattr(mod, attr, val)
    assert res["check"]["tokens_compared"] > 0
    assert not res["correct"] and res["check"]["logit_gap"] > res["check"]["limit"]
