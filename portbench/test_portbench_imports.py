"""A run's process holds no module of JAX or of the JAX package (top-level
names compared whole: ``repro_torch`` begins with ``repro``), and a run
without the program, or without a card, prints no result."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
ENV = {"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"}

RUN = """
import sys, time
sys.path[:0] = [{root!r}, {src!r}]
from pathlib import Path
from portbench import harness, tinycells
root = Path({tmp!r})
name = tinycells.write(root, "ti", tinycells.GQA, "gqa", tinycells.CLOSED)
res = harness.run_cell(harness.Cell(root, name), 1, 0.3, False, time.perf_counter(), device="cpu")
assert res["check"]["tokens_compared"] > 0
print(sorted({{m.split(".")[0] for m in sys.modules}} & {{"repro_torch", "repro", "jax", "jaxlib", "flax"}}))
print(harness.forbidden_modules())
"""


def test_forbidden_names_compare_whole():
    from portbench import harness

    sys.modules.setdefault("repro_torch_lookalike", sys)
    try:
        assert "repro_torch_lookalike" not in harness.forbidden_modules()
    finally:
        sys.modules.pop("repro_torch_lookalike", None)


def test_a_run_loads_no_jax_and_no_reference_package(tmp_path):
    code = RUN.format(root=str(ROOT), src=str(ROOT / "src"), tmp=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path, env=ENV)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-2] == "['repro_torch']" and lines[-1] == "[]"


def _no_result(proc):
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        try:
            assert "correct" not in json.loads(line)
        except ValueError:
            pass


def test_a_bare_checkout_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                           "minitron-4b.decode", "--seed", "1", "--seconds", "1",
                           "--trace", "0"], capture_output=True, text=True, timeout=300,
                          cwd=tmp_path, env=ENV)
    _no_result(proc)
