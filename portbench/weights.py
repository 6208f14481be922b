"""Random weights from the run's seed, made on the device in the type they
are served in: one normal draw for the whole model, cut into the leaves of
the reference's ``param_spec`` (the parameter tree the port's model
takes) and scaled in place. The same tensors go to the port and to the
reference."""
from __future__ import annotations

import math
from typing import Any, Dict

import torch


def make_params(spec, seed: int, device, dtype=torch.bfloat16,
                offsets: Dict[str, float] = None) -> Dict[str, Any]:
    """The tree of ``spec``'s leaves; a leaf named in ``offsets`` (the
    reference's ``OFFSETS``) is kept in float32, as the port keeps it, and
    centred on its offset."""
    offsets = offsets or {}
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    total = sum(math.prod(shape) for _, shape, _ in spec)
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    tree: Dict[str, Any] = {}
    off = 0
    for path, shape, scale in spec:
        n = math.prod(shape)
        leaf = flat[off:off + n].view(shape).mul_(scale)
        if path[-1] in offsets:
            leaf = leaf.float().add_(offsets[path[-1]])
        off += n
        node = tree
        for key, nxt in zip(path[:-1], path[1:]):
            if isinstance(key, int):
                while len(node) <= key:
                    node.append({})
                node = node[key]
            else:
                node = node.setdefault(key, [] if isinstance(nxt, int) else {})
        node[path[-1]] = leaf
    return tree
