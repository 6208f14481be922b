"""AdamW with a WSD (warmup-stable-decay) schedule.

Counterpart of ``repro.training.optimizer``, a class of its own rather than
``torch.optim.AdamW``: moments are fp32 whatever the param dtype (torch's
AdamW keeps bf16 moments for bf16 params); the decoupled weight decay is
added to the step before the lr multiply, using the old param; and it
applies to every leaf with ``ndim >= 2``. Both packages stack each stage's
blocks on a leading ``n_units`` axis, so the stacked norm scales
``(n_units, d)`` are decayed, as in the reference; the unstacked
``shared_block`` norms, ``final_norm`` and the stacked cross-attention gates
``(n_units,)`` are not.

``update`` writes the moments and params IN PLACE (the reference returns
new trees) and returns them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.training import tree as T


class AdamWState(NamedTuple):
    mu: Any
    nu: Any
    count: torch.Tensor


@dataclasses.dataclass(frozen=True)
class AdamW:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1

    def init(self, params) -> AdamWState:
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)   # a DTensor's layout too
        device = T.leaves(params)[0].device
        return AdamWState(mu=T.map(zeros, params), nu=T.map(zeros, params),
                          count=torch.zeros((), dtype=torch.int32, device=device))

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params, lr) -> tuple[Any, AdamWState]:
        """``lr`` a float or a 0-dim fp32 tensor; grads in any float dtype."""
        count = state.count + 1
        c32 = count.float()
        b1c = 1.0 - torch.pow(torch.tensor(self.b1, dtype=torch.float32, device=c32.device), c32)
        b2c = 1.0 - torch.pow(torch.tensor(self.b2, dtype=torch.float32, device=c32.device), c32)
        for g, m, v, p in zip(T.leaves(grads), T.leaves(state.mu), T.leaves(state.nu),
                              T.leaves(params)):
            g32 = g.float()
            m.mul_(self.b1).add_(g32, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g32, g32, value=1.0 - self.b2)
            del g32
            step = (m / b1c).div_((v / b2c).sqrt_().add_(self.eps))
            p32 = p.float()                  # p itself when p is fp32
            if p.ndim >= 2:  # decoupled decay on matrices (and stacked vectors) only
                step.add_(p32, alpha=self.weight_decay)
            step.mul_(lr)
            if p32 is p:
                p.sub_(step)
            else:
                p.copy_(p32.sub_(step))
        return params, AdamWState(mu=state.mu, nu=state.nu, count=count)


def wsd_schedule(
    peak_lr: float,
    warmup_steps: int,
    stable_steps: int,
    decay_steps: int,
    min_lr_frac: float = 0.1,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Warmup-Stable-Decay (MiniCPM): linear warmup, a long stable plateau,
    a linear decay tail to ``min_lr_frac`` of the peak. Takes the step (an
    int or an int tensor) and returns the lr as a 0-dim fp32 tensor."""

    def schedule(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * torch.clamp(step / max(warmup_steps, 1), max=1.0)
        decay_t = torch.clamp((step - warmup_steps - stable_steps) / max(decay_steps, 1),
                              0.0, 1.0)
        decay = peak_lr * (1.0 - (1.0 - min_lr_frac) * decay_t)
        return torch.where(step < warmup_steps + stable_steps, warm, decay)

    return schedule


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32."""
    norms = [torch.linalg.vector_norm(l, dtype=torch.float32) for l in T.leaves(tree)]
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_global_norm(tree, max_norm: float):
    """-> (tree scaled by min(1, max_norm / norm), norm); each leaf keeps its
    dtype."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return T.map(lambda l: (l.float() * scale).to(l.dtype), tree), norm
