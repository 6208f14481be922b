"""Tiny cells for the CPU tests: a checkout-shaped directory holding the
workload and configuration files of small GQA and Mamba2 models, in the
layout ``harness.Cell`` reads."""
from __future__ import annotations

import json
from pathlib import Path

GQA = {"name": "tiny-gqa", "family": "dense", "d_model": 64, "vocab_size": 512,
       "stages": [{"unit": ["attn"], "n_units": 2}], "n_heads": 4, "n_kv_heads": 2,
       "head_dim": 16, "d_ff": 128, "mlp_type": "squared_relu", "rope_theta": 10000.0,
       "tie_embeddings": False, "rms_eps": 1e-6}
MAMBA2 = {"name": "tiny-mamba2", "family": "ssm", "d_model": 64, "vocab_size": 512,
          "stages": [{"unit": ["ssm"], "n_units": 2}], "ssm_state": 16, "ssm_heads": 8,
          "ssm_head_dim": 16, "ssm_groups": 1, "ssm_expand": 2, "ssm_conv_kernel": 4,
          "ssm_chunk": 32, "tie_embeddings": True, "rms_eps": 1e-6}
ENGINE = {"paged": True, "kv_block_size": 16, "max_batch": 4, "max_seq_len": 256}
CLOSED = {"kind": "closed", "clients": 4, "requests": 64, "sizes_seed": 1,
          "prompt": {"dist": "lognormal", "median": 40, "sigma": 0.6, "min": 20, "max": 100},
          "output": {"dist": "uniform", "min": 10, "max": 40}}
OPEN = {"kind": "open", "rate": 20.0, "sizes_seed": 2,
        "prompt": {"dist": "lognormal", "median": 80, "sigma": 0.4, "min": 40, "max": 200},
        "output": {"dist": "uniform", "min": 4, "max": 8}}


def write(root: Path, name: str, port: dict, reference: str, traffic: dict,
          dtype: str = "float32", limit: float = 1e-3, sample: int = 3) -> str:
    """Write cell ``name`` (its configuration of the same name) under
    ``root``; returns the cell's name."""
    for sub in ("configs", "workloads"):
        (root / "portbench" / sub).mkdir(parents=True, exist_ok=True)
    cfg = {"name": name, "reference": reference,
           "port": dict(port, name=name, param_dtype=dtype, compute_dtype=dtype)}
    (root / "portbench" / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    work = {"config": name, "engine": ENGINE, "traffic": traffic,
            "sample": {"requests": sample}, "correct": {"max_logit_gap": limit}}
    (root / "portbench" / "workloads" / f"{name}.json").write_text(json.dumps(work))
    return name
