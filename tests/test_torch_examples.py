"""The port's examples and scripts against the repository's originals.

``characterize_paper`` and ``calibrate`` are analytic: their output equals
the originals' byte for byte. ``quickstart``'s analytic sections (1, the
config; 4, the paper's question) equal the original's; its training and
serving sections run on the CPU. ``serve_decode_pool`` at small flags: the
cap never engages on decode, the lock saves more than 20 %. ``train_wsd``
trains a few steps, checkpoints and resumes. ``smoke_models`` holds every
block kind's prefill + decode against the training forward (2e-4).
"""
import contextlib
import io
import math
import runpy
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.examples import characterize_paper, quickstart, serve_decode_pool, train_wsd
from repro_torch.scripts import calibrate, smoke_models

ROOT = Path(__file__).resolve().parents[1]


def _stdout(fn) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return buf.getvalue()


def _run_original(rel: str, *argv) -> str:
    def run():
        old = sys.argv
        sys.argv = [rel, *argv]
        try:
            runpy.run_path(str(ROOT / rel), run_name="__main__")
        finally:
            sys.argv = old
    return _stdout(run)


@pytest.mark.parametrize("port,original", [
    (characterize_paper.main, "examples/characterize_paper.py"),
    (calibrate.main, "scripts/calibrate.py"),
], ids=["characterize_paper", "calibrate"])
def test_analytic_output_equals_the_original_byte_for_byte(port, original):
    want = _run_original(original)
    assert want.count("\n") > 20
    assert _stdout(port) == want


def _sections(text: str) -> dict:
    out, key = {}, None
    for line in text.splitlines():
        if line.startswith("=== "):
            key = line.split(".")[0].removeprefix("=== ")
        if key is not None:
            out.setdefault(key, []).append(line)
    return out


def test_quickstart_on_the_cpu_and_its_analytic_sections_equal_the_original():
    result = {}
    port = _stdout(lambda: result.update(quickstart.main(["--device", "cpu"])))
    want = _sections(_run_original("examples/quickstart.py"))
    got = _sections(port)
    assert got["1"] == want["1"] and got["4"] == want["4"]
    report = result["report"]
    assert report["steps"] == 20 and math.isfinite(report["last_loss"])
    assert report["last_loss"] < report["first_loss"]
    assert result["completed"] == 6 and result["stats"].decode_tokens > 0


SERVE_FLAGS = ["--requests", "4", "--max-new", "6"]


def test_serve_decode_pool_cap_inert_and_lock_saves():
    res = {}
    text = _stdout(lambda: res.update(serve_decode_pool.main(["--device", "cpu"] + SERVE_FLAGS)))
    assert "conclusion:" in text
    assert all(r["completed"] == 4 for r in res.values())
    assert res["default"]["decode_engaged"] is False
    assert res["cap"]["decode_engaged"] is False
    assert res["cap"]["decode_clock"] == res["default"]["decode_clock"]
    assert res["lock"]["savings_pct"] > 20.0
    assert res["lock"]["decode_clock"] < res["default"]["decode_clock"]


def test_serve_decode_pool_paged_prints_the_originals_lines():
    """``--paged`` meters decode joules by the bytes moved, which at this
    size leaves the lock's saving near 0 in the original too: the modelled
    clocks, joules, bytes and occupancy equal the original's line by line."""
    flags = SERVE_FLAGS + ["--paged"]
    want = _run_original("examples/serve_decode_pool.py", *flags)
    assert _stdout(lambda: serve_decode_pool.main(["--device", "cpu"] + flags)) == want


def test_train_wsd_trains_checkpoints_and_resumes(tmp_path):
    argv = ["--device", "cpu", "--batch-size", "2", "--seq-len", "32",
            "--ckpt-dir", str(tmp_path)]
    first = train_wsd.main(argv + ["--steps", "4"])
    assert len(first["losses"]) == 4 and all(math.isfinite(x) for x in first["losses"])
    assert not first["preempted"] and (tmp_path / "step_000000004").is_dir()
    text = _stdout(lambda: first.update(again=train_wsd.main(argv + ["--steps", "6"])))
    assert "resumed from checkpoint step 4" in text
    assert len(first["again"]["losses"]) == 2


def test_smoke_models_every_block_kind():
    text = _stdout(lambda: smoke_models.main(["--device", "cpu"]))
    assert text.count("[ok]") == len(smoke_models.configs()) == 9
    assert text.rstrip().endswith("all model smokes passed")


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    for main in (quickstart.main, serve_decode_pool.main, train_wsd.main, smoke_models.main):
        with pytest.raises(RuntimeError, match="CUDA"):
            main([])
