"""Quick dev smoke: every block kind instantiates, runs train/prefill/decode,
and prefill+decode agrees with running the longer sequence through the
training forward (rtol / atol 2e-4).

Counterpart of ``scripts/smoke_models.py``: the same tiny configs of every
block kind, on ``--device`` (default ``cuda``; ``cpu`` runs the kernels'
plain versions), fp32, weights from a seeded ``torch.Generator``.

Run:  PYTHONPATH=src python -m repro_torch.scripts.smoke_models [--device cpu]
"""
import argparse

import torch

from repro_torch.device import resolve_device
from repro_torch.models import (
    ModelConfig,
    StageSpec,
    decode_step,
    forward,
    init_cache,
    init_params,
    logits,
    prefill,
)


def tiny(kind_units, **kw):
    base = dict(
        name="tiny",
        family="dense",
        d_model=64,
        vocab_size=128,
        stages=tuple(StageSpec(unit=u, n_units=n) for u, n in kind_units),
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        param_dtype="float32",
        compute_dtype="float32",
    )
    base.update(kw)
    return ModelConfig(**base)


def check(cfg, name, device, enc=None):
    gen = torch.Generator(device).manual_seed(0)
    params = init_params(cfg, gen, device=device)
    B, S = 2, 8
    g = torch.Generator(device).manual_seed(1)
    if cfg.input_is_embeddings:
        inputs = torch.randn((B, S, cfg.d_model), generator=g, device=device)
    else:
        inputs = torch.randint(0, cfg.vocab_size, (B, S), generator=g, device=device)
    with torch.no_grad():
        h = forward(params, cfg, inputs, enc_states=enc, remat=False)
        lg = logits(params, cfg, h)
        assert lg.shape == (B, S, cfg.vocab_size), lg.shape
        assert bool(torch.isfinite(lg).all()), f"{name}: non-finite train logits"

        # prefill first S-1 tokens, decode last token, compare to full forward
        cache = init_cache(cfg, B, S + 4, device=device)
        if cfg.input_is_embeddings:
            pre_in, last_in = inputs[:, : S - 1], inputs[:, S - 1: S]
        else:
            pre_in, last_in = inputs[:, : S - 1], inputs[:, S - 1]
        lg_pre, cache, lengths = prefill(params, cfg, pre_in, cache, enc_states=enc)
        torch.testing.assert_close(lg_pre, lg[:, S - 2], rtol=2e-4, atol=2e-4,
                                   msg=lambda m: f"{name}: prefill last-logits mismatch\n{m}")
        lg_dec, cache, lengths = decode_step(params, cfg, last_in, cache, lengths)
        torch.testing.assert_close(lg_dec, lg[:, S - 1], rtol=2e-4, atol=2e-4,
                                   msg=lambda m: f"{name}: decode-step logits mismatch\n{m}")
    print(f"[ok] {name}")


def configs():
    """(name, config, encoder states?) of every block kind's tiny config."""
    return [
        ("gqa", tiny([(("attn",), 3)]), False),
        ("gemma2-style", tiny([(("attn", "attn_global"), 2)], sliding_window=4,
                              attn_softcap=50.0, final_softcap=30.0), False),
        ("mla", tiny([(("mla",), 2)], n_heads=4, kv_lora_rank=32, qk_nope_head_dim=16,
                     qk_rope_head_dim=8, v_head_dim=16), False),
        ("mla+moe", tiny([(("mla",), 1), (("mla_moe",), 2)], kv_lora_rank=32,
                         qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                         n_routed_experts=4, n_shared_experts=1, moe_top_k=2, moe_d_ff=32,
                         moe_capacity_factor=8.0, family="moe"), False),
        ("mamba2", tiny([(("ssm",), 3)], family="ssm", ssm_state=16, ssm_heads=4,
                        ssm_chunk=4), False),
        ("gdn", tiny([(("gdn",), 2)], gdn_heads=2, gdn_head_dim=16), False),
        ("zamba2-style", tiny([(("ssm", "ssm", "shared_attn"), 2)], family="hybrid",
                              ssm_state=16, ssm_heads=4, ssm_chunk=4, n_kv_heads=4), False),
        ("vlm", tiny([(("attn", "cross_attn"), 2)], family="vlm", n_media_tokens=6), True),
        ("audio-embeds", tiny([(("attn",), 2)], family="audio", input_is_embeddings=True),
         False),
    ]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    for name, cfg, with_enc in configs():
        enc = None
        if with_enc:
            enc = torch.randn((2, 6, 64), generator=torch.Generator(device).manual_seed(7),
                              device=device)
        check(cfg, name, device, enc=enc)
    print("all model smokes passed")


if __name__ == "__main__":
    main()
