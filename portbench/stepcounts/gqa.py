"""A GQA decoder's step (``reference/gqa.py``'s model): the operations and
bytes a decode step over live rows, or a prefill of a prompt, must do,
from the configuration's shapes."""
from __future__ import annotations

from typing import Iterable

from portbench.counts import Cost, n_layers


def layer_params(cfg: dict) -> int:
    """Matmul weights of one attention + MLP layer."""
    d, h, kv, hd, ff = (cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"],
                        cfg["d_ff"])
    mlp = (3 if cfg["mlp_type"] in ("swiglu", "geglu") else 2) * d * ff
    return d * (h + 2 * kv) * hd + h * hd * d + mlp


def weight_bytes(cfg: dict, elem: int = 2) -> int:
    """Every weight streamed once: the layers, their two norms, the final
    norm, and the (tied) embedding table read by the unembedding."""
    d = cfg["d_model"]
    layers = n_layers(cfg) * (layer_params(cfg) + 2 * d)
    return elem * (layers + d + cfg["vocab_size"] * d)


def kv_bytes_per_token(cfg: dict, elem: int = 2) -> int:
    return n_layers(cfg) * 2 * cfg["n_kv_heads"] * cfg["head_dim"] * elem


def decode_step(cfg: dict, lengths: Iterable[int]) -> Cost:
    """A decode step over live rows holding ``lengths`` cached tokens: the
    weights once, each row's cached K/V read once and its new K/V row
    written once; the layers' matmuls, the attention over lengths + 1 keys
    and the unembedding of each row."""
    ls = list(lengths)
    lay, d, h, hd = n_layers(cfg), cfg["d_model"], cfg["n_heads"], cfg["head_dim"]
    tok = kv_bytes_per_token(cfg)
    nbytes = weight_bytes(cfg) + sum(ls) * tok + len(ls) * tok
    ops = sum(2 * lay * layer_params(cfg) + 2 * d * cfg["vocab_size"]
              + lay * 4 * h * hd * (n + 1) for n in ls)
    return Cost(nbytes, ops, "bfloat16")


def prefill(cfg: dict, prompt_len: int) -> Cost:
    """A prefill of ``prompt_len`` true tokens (not its padded bucket): the
    layers' matmuls over every token, causal attention (token i attends
    i + 1 keys) and the unembedding of the last token; the weights read
    once and the prompt's K/V written once."""
    n = prompt_len
    lay, d, h, hd = n_layers(cfg), cfg["d_model"], cfg["n_heads"], cfg["head_dim"]
    ops = (2 * lay * layer_params(cfg) * n + 2 * d * cfg["vocab_size"]
           + lay * 2 * h * hd * n * (n + 1))
    return Cost(weight_bytes(cfg) + n * kv_bytes_per_token(cfg), ops, "bfloat16")
