"""The port's import graph stays free of JAX and of the JAX package.

``repro_torch`` imports torch and never jax, and nothing of ``repro``;
``chip_smoke.py`` neither. Checked two ways: importing every module of the
port in a fresh interpreter leaves ``jax`` and ``repro.*`` out of
``sys.modules``, and an AST scan finds no such import anywhere in the
sources (function-local imports included).
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")
# the wrappers and plain versions of every kernel and the blocks that call
# them: the walk must reach each of them
KERNEL_MODULES = (
    "repro_torch.kernels.decode_attn.decode_attn", "repro_torch.kernels.decode_attn.ref",
    "repro_torch.kernels.mla_decode.mla_decode", "repro_torch.kernels.mla_decode.ref",
    "repro_torch.kernels.ssd.ssd", "repro_torch.kernels.ssd.ref",
    "repro_torch.kernels.gdn.gdn", "repro_torch.kernels.gdn.ref",
    "repro_torch.models.attention", "repro_torch.models.mla",
    "repro_torch.models.ssm", "repro_torch.models.gdn",
)
# the serving stack and its benchmarks: the walk must reach each of them too
SERVING_MODULES = (
    "repro_torch.core.traces", "repro_torch.serving.spec", "repro_torch.serving.router",
    "repro_torch.serving.autoscaler", "repro_torch.serving.prefix",
    "repro_torch.serving.pool", "repro_torch.serving.fleet", "repro_torch.serving.cluster",
    "repro_torch.serving.engine", "repro_torch.serving.events", "repro_torch.serving.prng",
    "repro_torch.serving.tracing",
    "repro_torch.benchmarks.common", "repro_torch.benchmarks.serve_cluster",
    "repro_torch.benchmarks.serve_trace", "repro_torch.benchmarks.serve_prefix",
    "repro_torch.benchmarks.serve_events", "repro_torch.benchmarks.serve_fleet",
    "repro_torch.benchmarks.serve_autoscale", "repro_torch.benchmarks.serve_scale",
)
# the analysis core, the H100 spec and the paper's benchmarks
PAPER_MODULES = (
    "repro_torch.core", "repro_torch.core.pareto", "repro_torch.core.crossover",
    "repro_torch.core.characterize", "repro_torch.core.hypotheses", "repro_torch.hw",
    "repro_torch.hw.roofline", "repro_torch.hw.h100",
    "repro_torch.benchmarks.table1_power_cap", "repro_torch.benchmarks.fig1_roofline",
    "repro_torch.benchmarks.fig2_heatmaps", "repro_torch.benchmarks.fig3_pareto",
    "repro_torch.benchmarks.fig4_request_energy", "repro_torch.benchmarks.hypotheses_bench",
    "repro_torch.benchmarks.policy_bench", "repro_torch.benchmarks.roofline_report",
    "repro_torch.benchmarks.tpu_native", "repro_torch.benchmarks.kernels_micro",
    "repro_torch.benchmarks.run",
)

# training (the optimizer, loss, compression, train step, checkpoints, fault
# handling, data) and its driver
TRAINING_MODULES = (
    "repro_torch.training", "repro_torch.training.optimizer", "repro_torch.training.losses",
    "repro_torch.training.compression", "repro_torch.training.train",
    "repro_torch.training.checkpoint", "repro_torch.training.fault",
    "repro_torch.training.data", "repro_torch.training.tree", "repro_torch.launch.train",
)

# the one-card dry run (meta specs, the mesh, the dispatch counter, the
# kernels' work counts) and the examples and scripts
DRYRUN_MODULES = (
    "repro_torch.launch.specs", "repro_torch.launch.mesh", "repro_torch.launch.cost",
    "repro_torch.launch.dryrun", "repro_torch.kernels.cost",
    "repro_torch.examples.quickstart", "repro_torch.examples.serve_decode_pool",
    "repro_torch.examples.train_wsd", "repro_torch.examples.characterize_paper",
    "repro_torch.scripts.calibrate", "repro_torch.scripts.smoke_models",
)


# the multi-device layer: DTensor helpers, sharding rules, the collective
# schedule's HLO parser (the mesh, cost and dry-run modules are above)
MESH_MODULES = (
    "repro_torch.dtensor", "repro_torch.launch.sharding", "repro_torch.launch.hlo_stats",
)


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        f"missing = sorted(set({KERNEL_MODULES + SERVING_MODULES + PAPER_MODULES + TRAINING_MODULES + DRYRUN_MODULES + MESH_MODULES!r}) "
        "- set(mods))\n"
        "print(len(mods), bad, missing)\n"
        "sys.exit(1 if bad or missing or len(mods) < 20 else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_no_jax_or_repro_import_in_sources():
    bad = []
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in FORBIDDEN:
                    bad.append(f"{path.relative_to(ROOT)}:{node.lineno} {name}")
    assert not bad, bad
