"""What decides ``correct``: the reference, run once over each sampled
request's prompt and served tokens, reads how far below its own best
logit each served token's logit lies. The widest such gap over the sample
is compared with the cell's limit.

The control puts the reference in the program's place at a lower precision
(``precision="fp8"``): at each position of the same prompts and served
tokens the token the control puts first is read the same way.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch


def sample(finished: Sequence, k: int, seed: int) -> List:
    """The request with the most tokens (prompt and served) and ``k`` - 1
    others drawn from ``seed``."""
    if not finished:
        return []
    order = sorted(finished, key=lambda r: (-(len(r.prompt) + len(r.output)), r.uid))
    rest = order[1:]
    rng = np.random.default_rng([seed % 2 ** 32, 3])
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False) if rest else []
    return [order[0]] + [rest[i] for i in sorted(pick)]


@torch.inference_mode()
def gaps(ref, params, cfg: dict, requests: Sequence, device, control: bool = False
         ) -> Tuple[float, int, float]:
    """(widest gap of the served tokens, tokens compared, widest gap of the
    control's first-ranked tokens or nan) over ``requests`` (each with
    ``prompt`` and ``output``)."""
    worst, worst_c, n = 0.0, (0.0 if control else float("nan")), 0
    for r in requests:
        prompt = np.asarray(r.prompt, np.int64)
        out = np.asarray(r.output, np.int64)
        seq = torch.from_numpy(np.concatenate([prompt, out[:-1]])).to(device)
        p = len(prompt)
        served = torch.from_numpy(out).to(device)
        h = ref.hidden(params, cfg, seq)[p - 1:]
        hc = ref.hidden(params, cfg, seq, "fp8")[p - 1:] if control else None
        blocks_c = ref.logits_blocks(params, cfg, hc, "fp8") if control else None
        i = 0
        for lg in ref.logits_blocks(params, cfg, h):
            rows = torch.arange(lg.shape[0], device=device)
            best = lg.max(dim=1).values
            at = lg[rows, served[i:i + lg.shape[0]]]
            worst = max(worst, float((best - at).max()))
            if control:
                first_c = next(blocks_c).argmax(dim=1)
                worst_c = max(worst_c, float((best - lg[rows, first_c]).max()))
            i += lg.shape[0]
        n += len(out)
    return worst, n, worst_c
