"""Kernel microbenchmarks: the port's CUDA kernels against their plain
PyTorch versions, plus the fused-vs-eager counterfactual from the energy
model (§6.2/§7.2).

Counterpart of the reference's ``benchmarks/kernels_micro.py`` (Pallas in
interpret mode against pure-jnp oracles): the same four kernels at the same
shapes, fp32 as ``jax.random.normal`` gives, inputs drawn from a seeded
numpy generator, and the same modelled ``derived`` figures (the H200 model,
as in the reference). On ``cuda`` each kernel is held against its plain
version on the same inputs (fp32 5e-5, the scans 2e-4; a kernel outside
its tolerance raises) and both are timed with CUDA events after a warm-up;
a wrapper that refused to launch would raise, and the launch counts are
checked. On ``cpu`` the wrappers run their plain versions (the host clock
times them) and each row says so. The CSV's column ``kernel_us`` is the
reference's ``pallas_interpret_us``.

    python -m repro_torch.benchmarks.kernels_micro [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import kernels as kmod
from repro_torch.configs.paper_models import PAPER_MODELS
from repro_torch.core import Default, decode_workload, prefill_workload, resolve
from repro_torch.device import resolve_device

from repro_torch.benchmarks.common import Row, h200_model, write_csv

WARMUP = 3
ITERS = 20
# launches of each kernel in one run on a card: the comparison call, the
# warm-up and the timed calls
LAUNCHES = 1 + WARMUP + ITERS
DECODE_SHAPE = dict(B=2, H=8, KV=2, D=64, L=512)
MLA_SHAPE = dict(H=16, rank=64, rope=16)
SSD_SHAPE = dict(b=1, s=256, h=8, p=32, n=64)
GDN_SHAPE = dict(b=1, s=128, h=4, d=32)


def _softplus(x):
    return np.logaddexp(0.0, x).astype(np.float32)


def _sigmoid(x):
    return (1.0 / (1.0 + np.exp(-x))).astype(np.float32)


def make_inputs() -> dict:
    """{CSV row: (numpy operands, keyword arguments)} of the four kernels at
    the reference's shapes and distributions, fp32 (valid_len int32), drawn
    from a generator seeded with 0."""
    rng = np.random.default_rng(0)

    def normal(*shape):
        return rng.standard_normal(shape, np.float32)

    B, H, KV, D, L = (DECODE_SHAPE[k] for k in ("B", "H", "KV", "D", "L"))
    vl = np.full((B,), L, np.int32)
    out = {"decode_attn": ((normal(B, H, D), normal(B, L, KV, D), normal(B, L, KV, D), vl),
                           {"scale": 0.125})}
    mh, rank, rope = MLA_SHAPE["H"], MLA_SHAPE["rank"], MLA_SHAPE["rope"]
    out["mla_decode"] = ((normal(B, mh, rank), normal(B, mh, rope), normal(B, L, rank),
                          normal(B, L, rope), vl), {"scale": 0.11})
    b, s, h, p, n = (SSD_SHAPE[k] for k in ("b", "s", "h", "p", "n"))
    a = (-np.exp(np.linspace(-2, 0.5, h))).astype(np.float32)
    out["ssd_prefill"] = ((normal(b, s, h, p) * 0.5, _softplus(normal(b, s, h)), a,
                           normal(b, s, n) * 0.3, normal(b, s, n) * 0.3), {})
    b, s, h, d = (GDN_SHAPE[k] for k in ("b", "s", "h", "d"))
    q, k = normal(b, s, h, d), normal(b, s, h, d)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    k /= np.linalg.norm(k, axis=-1, keepdims=True)
    out["gdn_prefill"] = ((q, k, normal(b, s, h, d) * 0.5, _sigmoid(normal(b, s, h)),
                           _sigmoid(normal(b, s, h) + 2)), {})
    return out


# CSV row -> (row name, the kernel's wrapper as the model calls it, its
# plain version, the counted wrapper that launches the kernel, tolerance:
# tests/test_kernels.py's for fp32 decode and for the scans)
KERNELS = {
    "decode_attn": ("kernel_decode_attn", kmod.decode_attention, kmod.decode_attention_ref,
                    "decode_attention", 5e-5),
    "mla_decode": ("kernel_mla_decode", kmod.mla_latent_decode, kmod.mla_latent_decode_ref,
                   "mla_latent_decode", 5e-5),
    "ssd_prefill": ("kernel_ssd", kmod.ssd_prefill, kmod.ssd_scan_ref, "ssd_scan", 2e-4),
    "gdn_prefill": ("kernel_gdn", kmod.gdn_prefill, kmod.gdn_scan_ref, "gdn_scan", 2e-4),
}


def modelled() -> dict:
    """{CSV row: the reference's modelled ``derived`` figure} (H200 model)."""
    emodel = h200_model()
    mla = PAPER_MODELS["minitron-4b-mla"]()
    eager = resolve(emodel, decode_workload(mla, 1, 1024), Default())
    fused = resolve(emodel, decode_workload(mla, 1, 1024, fused=True), Default())
    gain = 1 - fused.energy_per_token_mj / eager.energy_per_token_mj
    out = {"decode_attn": None, "mla_decode": f"modelled_decode_energy_gain={gain:.1%}"}
    for row, arch in (("ssd_prefill", "mamba2-4b"), ("gdn_prefill", "gdn-4b")):
        cfg = PAPER_MODELS[arch]()
        e_eager = resolve(emodel, prefill_workload(cfg, 1, 4096), Default()).energy_per_token_mj
        e_fused = resolve(emodel, prefill_workload(cfg, 1, 4096, fused=True),
                          Default()).energy_per_token_mj
        out[row] = f"modelled_prefill_mj {e_eager:.1f}->{e_fused:.1f}"
        if row == "gdn_prefill":
            out[row] += f" ({e_eager/e_fused:.1f}x)"
    return out


def _outputs(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def _time_us(fn, args, kwargs, dev) -> float:
    """Microseconds a call: CUDA events around ITERS calls on a card, the
    host clock on the CPU; WARMUP calls first."""
    for _ in range(WARMUP):
        fn(*args, **kwargs)
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        start.record()
        for _ in range(ITERS):
            fn(*args, **kwargs)
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / ITERS * 1e3
    t0 = time.perf_counter()
    for _ in range(ITERS):
        fn(*args, **kwargs)
    return (time.perf_counter() - t0) / ITERS * 1e6


def run(device="cuda") -> list[Row]:
    """Harness contract: (name, us_per_call, derived) rows, one a kernel;
    writes ``kernels_micro.csv``. Raises if a kernel disagrees with its
    plain version beyond its tolerance, or on a card if a wrapper's launch
    count did not rise by ``LAUNCHES``."""
    dev = resolve_device(device)
    ran = "cuda" if dev.type == "cuda" else "plain"
    notes = modelled()
    rows: list[Row] = []
    csv_rows = []
    for name, (arrays, kwargs) in make_inputs().items():
        row, kernel, plain, counted, tol = KERNELS[name]
        counter = getattr(kmod, counted)
        args = tuple(torch.from_numpy(a).to(dev) for a in arrays)
        before = counter.launches
        got = _outputs(kernel(*args, **kwargs))
        want = _outputs(plain(*args, **kwargs))
        err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
        if not err <= tol:
            raise RuntimeError(f"kernels_micro: {name} max_abs_err {err:.3e} > {tol} "
                               f"against its plain version")
        us_k = _time_us(kernel, args, kwargs, dev)
        us_r = _time_us(plain, args, kwargs, dev)
        launches = counter.launches - before
        if dev.type == "cuda" and launches != LAUNCHES:
            raise RuntimeError(f"kernels_micro: {counted} launched {launches} times, "
                               f"expected {LAUNCHES}")
        csv_rows.append([name, us_k, us_r])
        derived = (f"ref_us={us_r:.0f};ran={ran};max_abs_err={err:.1e};tol={tol:g};"
                   f"launches={launches}")
        if notes[name]:
            derived += f";{notes[name]}"
        rows.append((row, us_k, derived))
    write_csv("kernels_micro", ["kernel", "kernel_us", "ref_us"], csv_rows)
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for name, us, derived in run(device=args.device):
        print(f"{name},{us:.1f},{derived}")


if __name__ == "__main__":
    main()
