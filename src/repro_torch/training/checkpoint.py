"""Checkpointing: one directory per step, atomic commit, restore onto the
target's device and dtype.

Counterpart of ``repro.training.checkpoint``, with the same on-disk
contract::

    <root>/step_000000123/
        manifest.json      # leaf paths, shapes, dtypes, step
        arr_000000.npy ... # one file per leaf
        _COMPLETE          # commit marker written last (atomicity)

A step is written into ``step_*.tmp`` and renamed on commit; ``keep``
complete steps are kept; steps without ``_COMPLETE`` are ignored by
``list_steps`` / ``latest_step``, so restarts are preemption-safe. Leaves
are torch tensors saved from the host as ``.npy``; numpy has no bfloat16,
so a bf16 leaf is stored as its uint16 bit pattern and the manifest says
``bfloat16``. The reference's elastic reshard on restore becomes
``restore_checkpoint(..., like)`` putting each leaf on ``like``'s device and
dtype. The files are this package's own; reading the JAX package's
checkpoints is not a goal.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.training import tree as T

_COMPLETE = "_COMPLETE"


def _host(leaf: torch.Tensor) -> tuple:
    """(numpy array, dtype name) of a tensor leaf, copied to the host; a
    bf16 leaf as its uint16 bit pattern."""
    t = leaf.detach().cpu()
    arr = t.view(torch.int16).numpy().view(np.uint16) if t.dtype == torch.bfloat16 else t.numpy()
    return arr, str(t.dtype).removeprefix("torch.")


def save_checkpoint(root: str, step: int, tree: Any, *, keep: int = 3) -> str:
    """Blocking save. Returns the checkpoint directory."""
    d = os.path.join(root, f"step_{step:09d}")
    tmp = d + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": int(step), "leaves": [], "format": 1}
    for i, (path, leaf) in enumerate(zip(T.paths(tree), T.leaves(tree))):
        arr, dtype = _host(leaf)
        fname = f"arr_{i:06d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append(
            {"file": fname, "path": path, "shape": list(arr.shape), "dtype": dtype})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, _COMPLETE), "w") as f:
        f.write("ok")
    if os.path.exists(d):
        shutil.rmtree(d)
    os.rename(tmp, d)
    _gc_old(root, keep)
    return d


def save_checkpoint_async(root: str, step: int, tree: Any, *, keep: int = 3) -> threading.Thread:
    """Non-blocking save: copies every leaf to host memory now, writes the
    files on a background thread so the train loop keeps stepping."""
    host = T.map(lambda l: l.detach().to("cpu", copy=True), tree)
    t = threading.Thread(target=save_checkpoint, args=(root, step, host), kwargs={"keep": keep})
    t.start()
    return t


def _gc_old(root: str, keep: int):
    steps = sorted(list_steps(root))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(root, f"step_{s:09d}"), ignore_errors=True)


def list_steps(root: str) -> List[int]:
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(root, name, _COMPLETE)):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(root: str) -> Optional[int]:
    steps = list_steps(root)
    return steps[-1] if steps else None


def restore_checkpoint(root: str, step: int, like: Any) -> Any:
    """Restore into the structure of ``like`` (a tree of tensors, meta
    tensors included), each leaf on ``like``'s leaf's device and dtype."""
    d = os.path.join(root, f"step_{step:09d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    leaves_like, paths = T.leaves(like), T.paths(like)
    if len(manifest["leaves"]) != len(leaves_like):
        raise ValueError(
            f"checkpoint has {len(manifest['leaves'])} leaves, target needs {len(leaves_like)}")
    out = []
    for path, meta, leaf_like in zip(paths, manifest["leaves"], leaves_like):
        arr = np.load(os.path.join(d, meta["file"]))
        if tuple(arr.shape) != tuple(leaf_like.shape):
            raise ValueError(
                f"leaf {path}: checkpoint shape {arr.shape} != target {tuple(leaf_like.shape)}")
        t = torch.from_numpy(arr)
        if meta["dtype"] == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        device = "cpu" if leaf_like.device.type == "meta" else leaf_like.device
        out.append(t.to(device=device, dtype=leaf_like.dtype))
    return T.unflatten(like, out)
