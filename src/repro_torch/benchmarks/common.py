"""Shared benchmark plumbing of the port: the perf-record JSON writer, the
CSV writer, the timer and the model and energy-model fixtures, copied from
the reference's ``benchmarks/common.py`` (that module imports
``repro.core``, which loads JAX), the ``H100_SXM`` energy model, and the
benchmarks' random weights."""
from __future__ import annotations

import csv
import json
import os
import time
from typing import Any, Callable, Dict, Iterable, Optional, Sequence, Tuple

import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.paper_models import PAPER_MODELS
from repro_torch.core.energy import EnergyModel
from repro_torch.device import resolve_device
from repro_torch.hw import H100_SXM, H200_SXM, TPU_V5E
from repro_torch.models import init_params

Row = Tuple[str, float, str]  # (name, us_per_call, derived)

# version of the committed perf-record layout; bump on breaking field changes
BENCH_SCHEMA_VERSION = 1
# field names that vary run-to-run (wall timings) and must never land in the
# committed record — the JSON stays byte-stable unless serving behaviour
# actually changed
VOLATILE_FIELDS = frozenset({"wall_s", "wall_secs", "wall_time_s"})


def results_dir() -> str:
    """Where ``write_csv`` puts its tables: ``$REPRO_BENCH_OUT``, else
    ``results/benchmarks`` under the working directory."""
    return os.environ.get("REPRO_BENCH_OUT", "results/benchmarks")


def deterministic_fields(obj: Any, volatile=VOLATILE_FIELDS) -> Any:
    """Recursively drop volatile (wall-clock) keys from a JSON-able tree."""
    if isinstance(obj, dict):
        return {k: deterministic_fields(v, volatile)
                for k, v in obj.items() if k not in volatile}
    if isinstance(obj, (list, tuple)):
        return [deterministic_fields(v, volatile) for v in obj]
    return obj


def write_bench_json(
    bench: str,
    results: Any,
    *,
    smoke: bool = False,
    trace: Optional[Dict[str, Any]] = None,
    extra: Optional[Dict[str, Any]] = None,
    path: Optional[str] = None,
    volatile=VOLATILE_FIELDS,
) -> str:
    """The shared ``--json`` writer: schema-versioned payload, volatile
    fields filtered, keys sorted — so two identical replays produce
    byte-identical artefacts."""
    payload: Dict[str, Any] = {
        "bench": bench,
        "schema_version": BENCH_SCHEMA_VERSION,
        "smoke": smoke,
        "results": deterministic_fields(results, volatile),
    }
    if trace is not None:
        payload["trace"] = deterministic_fields(trace, volatile)
    if extra:
        payload.update(deterministic_fields(extra, volatile))
    path = path or f"BENCH_{bench}.json"
    with open(path, "w") as f:
        json.dump(payload, f, sort_keys=True, indent=1)
    return path


def timed(fn: Callable, *args, **kw):
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    return out, (time.perf_counter() - t0) * 1e6


def write_csv(name: str, header: Sequence[str], rows: Iterable[Sequence]) -> str:
    out = results_dir()
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, f"{name}.csv")
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        for r in rows:
            w.writerow(r)
    return path


class RecipeViolation(RuntimeError):
    """A recipe's own checks failed; ``violations`` lists each one. A caller
    that catches this, and not ``RuntimeError``, lets every other error (a
    CUDA error among them) through as it is."""

    def __init__(self, violations):
        super().__init__("; ".join(violations))
        self.violations = list(violations)


def check_vocab(trace, archs, *, full_config: bool = False) -> None:
    """Refuse a trace with a prompt id at or past any replica's vocabulary
    (the configs the pools run): on a card such an id is a device-side
    assert in the embedding gather, not an error the replay could report."""
    top = max((int(t.prompt.max()) for t in trace if len(t.prompt)), default=-1)
    for arch in dict.fromkeys(archs):
        vocab = (get_config(arch) if full_config else reduced_config(arch)).vocab_size
        if top >= vocab:
            raise ValueError(f"trace holds prompt id {top}, past {arch}'s vocabulary "
                             f"of {vocab}")


def paper_models():
    return {k: v() for k, v in PAPER_MODELS.items()}


def h200_model() -> EnergyModel:
    return EnergyModel(H200_SXM)


def v5e_model() -> EnergyModel:
    return EnergyModel(TPU_V5E)


def h100_model() -> EnergyModel:
    """The energy model of the card the port runs on (``hw/h100.py``: data
    sheet ceilings, the power surface assumed from the H200)."""
    return EnergyModel(H100_SXM)


def random_params(arch: str, *, full_config: bool = False, device="cuda"):
    """Weights of the config the benchmarks' pools run (``get_config`` with
    ``full_config``, else ``reduced_config``), drawn from a
    ``torch.Generator`` seeded with 0 on ``device``: other values than the
    reference benchmarks' ``jax.random.PRNGKey(0)`` init."""
    dev = resolve_device(device)
    cfg = get_config(arch) if full_config else reduced_config(arch)
    return init_params(cfg, torch.Generator(dev).manual_seed(0), device=dev)
