"""Abstract inputs, params, caches and train states for the dry run: tensors
on ``device="meta"``, which carry a shape and a dtype and no storage.

Counterpart of ``repro.launch.specs``, whose ``ShapeDtypeStruct`` trees
these equal leaf by leaf (shape and dtype). The params come from
``init_params`` on meta, where ``layers.normal_init`` draws nothing and
returns the leaf's shape and dtype; the caches from ``init_cache`` on
meta; the train state from ``init_train_state`` over meta params (fp32
moments, an int32 count and step), so each tree is built by the function
that builds the real one.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.shapes import ShapeSpec
from repro_torch.models import init_cache, init_params
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dt
from repro_torch.training.optimizer import AdamW
from repro_torch.training.train import init_train_state

META = torch.device("meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
    """Meta stand-ins for every model input of this cell."""
    b, s = shape.global_batch, shape.seq_len
    cd = dt(cfg.compute_dtype)
    i32 = torch.int32
    out: Dict[str, torch.Tensor] = {}
    if shape.kind in ("train", "prefill"):
        out["inputs"] = (_meta((b, s, cfg.d_model), cd) if cfg.input_is_embeddings
                         else _meta((b, s), i32))
        if shape.kind == "train":
            out["labels"] = _meta((b, s), i32)
        if cfg.n_media_tokens:
            out["enc_states"] = _meta((b, cfg.n_media_tokens, cfg.d_model), cd)
    elif shape.kind == "decode":
        out["token"] = (_meta((b, 1, cfg.d_model), cd) if cfg.input_is_embeddings
                        else _meta((b,), i32))
        out["lengths"] = _meta((b,), i32)
    else:
        raise ValueError(shape.kind)
    return out


def abstract_params(cfg: ModelConfig) -> Dict:
    return init_params(cfg, None, device=META)


def abstract_decode_cache(cfg: ModelConfig, shape: ShapeSpec) -> Dict:
    # decode_32k / long_500k: a cache of seq_len; the step writes token
    # seq_len - 1, "a cache of seq_len with one new token"
    return init_cache(cfg, shape.global_batch, shape.seq_len, device=META)


def abstract_prefill_cache(cfg: ModelConfig, shape: ShapeSpec) -> Dict:
    return init_cache(cfg, shape.global_batch, shape.seq_len, device=META)


def abstract_train_state(cfg: ModelConfig, optimizer: AdamW | None = None):
    return init_train_state(cfg, abstract_params(cfg), optimizer or AdamW())
