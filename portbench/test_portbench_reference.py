"""Each reference at tiny widths against the port's engine on the CPU: the
harness serves a tiny cell and the reference judges the served tokens.
The reference files import nothing of the port."""
import ast
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import harness, tinycells
from portbench.reference import gqa, mamba2
from portbench.weights import make_params

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _run(root, name, seed, **kw):
    cell = harness.Cell(root, name)
    return harness.run_cell(cell, seed, 0.6, False, time.perf_counter(), device="cpu", **kw)


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 17])
@pytest.mark.parametrize("traffic", ["closed", "open"])
def test_gqa_reference_matches_the_served_tokens(tmp_path, seed, traffic):
    mix = tinycells.CLOSED if traffic == "closed" else tinycells.OPEN
    name = tinycells.write(tmp_path, "tg", tinycells.GQA, "gqa", mix)
    res = _run(tmp_path, name, seed)
    assert res["check"]["tokens_compared"] > 0 and res["failed"] == 0
    # fp32 serving: every served token is the reference's first choice
    assert res["check"]["logit_gap"] < 1e-4 and res["correct"]


def test_gqa_reference_bf16(tmp_path):
    """bf16 serving stays within a small gap of the fp32 reference."""
    name = tinycells.write(tmp_path, "tb", tinycells.GQA, "gqa", tinycells.CLOSED,
                           dtype="bfloat16", limit=0.5)
    res = _run(tmp_path, name, 11)
    assert res["check"]["tokens_compared"] > 0 and res["check"]["logit_gap"] < 0.5


def test_mamba2_reference_matches_where_no_prompt_is_padded(tmp_path):
    """Prompts exactly a bucket long: the padded prefill pads nothing, and
    prefill, placement and the recurrent decode agree with the reference."""
    mix = dict(tinycells.CLOSED, prompt={"dist": "uniform", "min": 64, "max": 64})
    name = tinycells.write(tmp_path, "tm", tinycells.MAMBA2, "mamba2", mix)
    res = _run(tmp_path, name, 5)
    assert res["check"]["tokens_compared"] > 0 and res["check"]["logit_gap"] < 1e-4


def test_mamba2_reference_first_token_of_padded_prompts(tmp_path):
    """The prefill's own logits (the first served token) agree on padded
    prompts too: the padding lies after the last prompt position."""
    from repro_torch.models import init_cache, prefill

    name = tinycells.write(tmp_path, "tp", tinycells.MAMBA2, "mamba2", tinycells.CLOSED)
    cell = harness.Cell(tmp_path, name)
    mc = cell.model_config()
    params = make_params(mamba2.param_spec(cell.cfg), 9, "cpu", torch.float32, mamba2.OFFSETS)
    rng = np.random.default_rng(0)
    for n in (37, 50, 64):
        toks = np.zeros((1, 64), np.int64)
        toks[0, :n] = rng.integers(1, 512, n)
        cache = init_cache(mc, 1, 64, device="cpu")
        logits, _, _ = prefill(params, mc, torch.from_numpy(toks), cache,
                               prompt_lengths=torch.tensor([n], dtype=torch.int32))
        h = mamba2.hidden(params, cell.cfg, torch.from_numpy(toks[0, :n]))[-1:]
        ref = next(mamba2.logits_blocks(params, cell.cfg, h))
        assert torch.allclose(logits, ref, atol=1e-4)


@pytest.mark.parametrize("module,port", [(gqa, "minitron-4b"), (mamba2, "mamba2-780m")])
def test_param_spec_is_the_ports_tree(module, port):
    """The leaves the benchmark draws are the leaves the port's model takes."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    cfg = json.loads((HERE / "configs" / f"{port}.json").read_text())["port"]
    meta = init_params(get_config(port), None, device="meta")

    def leaves(tree, path=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, path + (k,))
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                yield from leaves(v, path + (i,))
        else:
            yield path, tuple(tree.shape)

    assert dict(leaves(meta)) == {p: s for p, s, _ in module.param_spec(cfg)}


@pytest.mark.parametrize("name", ["gqa.py", "mamba2.py"])
def test_reference_imports_nothing_of_the_port(name):
    tree = ast.parse((HERE / "reference" / name).read_text())
    mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    mods |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    assert {m.split(".")[0] for m in mods} <= {"__future__", "math", "typing", "torch",
                                                 "portbench"}
    assert all(m.startswith("portbench.reference") for m in mods if m.startswith("portbench"))
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
            f"import portbench.reference.{name[:-3]}; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'repro_torch', 'repro', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
