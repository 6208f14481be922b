"""Total request energy vs output length (paper Fig 4 + §6).

E_request(arch, prompt, n_out) = E_prefill(prompt) + sum_i E_decode(ctx_i)
with ctx growing by one token per step. Decode energies are integrated by
sampling the context axis (trapezoid) — exact enough because E(ctx) is
piecewise-linear in the model.

``crossover_output_length`` finds where one architecture's cumulative
request energy drops below another's — the paper's "recurrent models cross
after ~1,000 output tokens; MLA crosses beyond a batch-dependent context
threshold".
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np

from repro_torch.core.dvfs import ClockLock, Default, Lever, resolve
from repro_torch.core.energy import EnergyModel
from repro_torch.core.workload import decode_workload, prefill_workload
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class RequestEnergy:
    arch: str
    prompt_len: int
    output_len: int
    batch: int
    prefill_j: float
    decode_j: float

    @property
    def total_j(self) -> float:
        return self.prefill_j + self.decode_j

    @property
    def per_token_mj(self) -> float:
        return 1e3 * self.total_j / max(self.prompt_len + self.output_len, 1)


def request_energy(
    model: EnergyModel,
    cfg: ModelConfig,
    *,
    prompt_len: int,
    output_len: int,
    batch: int = 1,
    lever: Optional[Lever] = None,
    fused: bool = False,
    n_samples: int = 16,
) -> RequestEnergy:
    """Energy for a batch of identical requests, reported per request."""
    lever = lever if lever is not None else Default()
    wp = prefill_workload(cfg, batch, prompt_len, fused=fused)
    pf = resolve(model, wp, lever).profile
    prefill_j = pf.energy_j / batch

    # integrate decode energy as context grows prompt_len -> prompt_len+output
    ctxs = np.unique(
        np.linspace(prompt_len, prompt_len + max(output_len - 1, 0), n_samples).astype(int)
    )
    e_at = []
    for ctx in ctxs:
        wd = decode_workload(cfg, batch, int(ctx), fused=fused)
        prof = resolve(model, wd, lever).profile
        e_at.append(prof.energy_j / batch)  # J per generated token per request
    decode_j = float(np.trapezoid(e_at, ctxs)) if len(ctxs) > 1 else float(e_at[0] * output_len)
    if len(ctxs) > 1:
        # trapezoid integrates over ctx span; rescale to token count
        span = ctxs[-1] - ctxs[0]
        decode_j *= output_len / max(span, 1)
    return RequestEnergy(cfg.name, prompt_len, output_len, batch, prefill_j, decode_j)


def energy_curve(
    model: EnergyModel,
    cfg: ModelConfig,
    *,
    prompt_len: int,
    output_lens: List[int],
    batch: int = 1,
    lever: Optional[Lever] = None,
    fused: bool = False,
) -> List[RequestEnergy]:
    return [
        request_energy(
            model, cfg, prompt_len=prompt_len, output_len=o, batch=batch,
            lever=lever, fused=fused,
        )
        for o in output_lens
    ]


def crossover_output_length(
    model: EnergyModel,
    challenger: ModelConfig,
    baseline: ModelConfig,
    *,
    prompt_len: int,
    batch: int,
    max_output: int = 16384,
    lever: Optional[Lever] = None,
    fused: bool = False,
) -> Optional[int]:
    """Smallest output length where challenger's total request energy drops
    below baseline's; None if it never does within ``max_output``."""
    lo, hi = 1, max_output

    def cheaper(n_out: int) -> bool:
        ec = request_energy(model, challenger, prompt_len=prompt_len,
                            output_len=n_out, batch=batch, lever=lever, fused=fused)
        eb = request_energy(model, baseline, prompt_len=prompt_len,
                            output_len=n_out, batch=batch, lever=lever, fused=fused)
        return ec.total_j < eb.total_j

    if not cheaper(hi):
        return None
    if cheaper(lo):
        return lo
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if cheaper(mid):
            hi = mid
        else:
            lo = mid
    return hi
