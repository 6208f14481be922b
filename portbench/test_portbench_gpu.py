"""Each cell for a few seconds on the card, through the benchmark's own
command (``pytest -m gpu portbench`` on a machine with an H100)."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_card(card, cell):
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed",
                           "2147483659", "--seconds", "4", "--trace", "0"],
                          capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["device"]["platform"] == "gpu" and out["attempted"] > 0
    assert out["check"]["tokens_compared"] > 0
