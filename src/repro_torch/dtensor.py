"""The model on DTensor: what its functions need when params, caches and
inputs are ``DTensor``s laid out by ``launch/sharding.py``.

DTensor's sharding propagation plays GSPMD's part: an op over DTensors
runs on each rank's shard, with the collectives the placements call for.
Two things do not propagate, and this module handles both:

* A constant made inside the model (``torch.arange``, a rope frequency
  table) is a plain tensor. ``lift(t, like)`` puts it on ``like``'s mesh,
  replicated; on a plain ``like`` it returns ``t`` unchanged, so the
  single-device path runs exactly as before.
* An op DTensor has no strategy for (the cache writes' indexed stores, the
  MoE's capacity dispatch, the kernels themselves) runs under ``local_map``
  (the counterpart of ``shard_map``) over the smallest function around it.
  ``site(name, fn, ...)`` wraps one and records ``name`` in ``SITES``, the
  set the dry run writes as ``local_map_sites``.

Every helper is a no-op on plain tensors; ``is_dtensor`` is how the model's
functions choose their sharded branch.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from repro_torch.launch.mesh import data_axes

SITES: set = set()


def _dtensor_cls():
    from torch.distributed.tensor import DTensor
    return DTensor


def is_dtensor(t) -> bool:
    if not isinstance(t, torch.Tensor) or type(t) is torch.Tensor:
        return False
    return isinstance(t, _dtensor_cls())


def lift(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` replicated on ``like``'s mesh when ``like`` is a DTensor."""
    if not is_dtensor(like) or is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate

    mesh = like.device_mesh
    return _dtensor_cls().from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def arange(n: int, like: torch.Tensor, **kw) -> torch.Tensor:
    """``torch.arange(n)`` on ``like``'s device, lifted onto its mesh."""
    return lift(torch.arange(n, device=like.device, **kw), like)


def replicate(placements) -> tuple:
    from torch.distributed.tensor import Replicate
    return tuple(Replicate() for _ in placements)


def batch_only(t) -> tuple:
    """``t``'s placements with every shard of a dim other than 0 (and any
    partial sum) replaced by ``Replicate``: the layout of a per-row tensor
    derived from ``t``."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                 for p in t.placements)


def shard_dim_axes_of(placements, dim: int) -> list:
    """The mesh dims (in mesh order) of ``placements`` that shard tensor dim
    ``dim`` (0: the batch)."""
    return [i for i, p in enumerate(placements) if p.is_shard() and p.dim == dim]


def shard_index(mesh, mesh_dims: Sequence[int]) -> int:
    """This rank's index among the shards cut over ``mesh_dims`` (mesh
    order, the first dim outermost) and the shard count."""
    idx = 0
    for d in mesh_dims:
        idx = idx * mesh.size(d) + mesh.get_local_rank(d)
    return idx


def shard_count(mesh, mesh_dims: Sequence[int]) -> int:
    n = 1
    for d in mesh_dims:
        n *= mesh.size(d)
    return n


def axis_layout(mesh, *, batch: tuple | None = None, heads: tuple | None = None) -> tuple:
    """Placements on ``mesh`` with tensor dim ``batch[0]`` (of size
    ``batch[1]``) split over the data axes (``("pod", "data")``, or
    ``"data"`` alone when the size does not divide both) and dim
    ``heads[0]`` over ``"model"``, each only where its size divides: the
    scans' layout, which needs no communication. An axis of one rank
    shards nothing."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.mesh_dim_names
    out = [Replicate()] * mesh.ndim
    if batch is not None:
        dim, size = batch
        data = [names.index(a) for a in data_axes(mesh)]
        if size % shard_count(mesh, data):
            data = [i for i in data if names[i] == "data" and size % mesh.size(i) == 0]
        for i in data:
            if mesh.size(i) > 1:
                out[i] = Shard(dim)
    if heads is not None and "model" in names:
        dim, size = heads
        i = names.index("model")
        if size % mesh.size(i) == 0 and mesh.size(i) > 1:
            out[i] = Shard(dim)
    return tuple(out)


def constrain_batch(x: torch.Tensor) -> torch.Tensor:
    """An activation DTensor pinned to batch-only layout: dim 0 over the data
    axes (when they divide it), replicated elsewhere, partial sums reduced:
    the reference's ``sharding_hints.constrain_batch`` at unit boundaries,
    which keeps the partitioner from replicating the batch or leaving
    sequence shards behind. A plain tensor, or a batch the data axes do not
    divide, passes unchanged."""
    if not is_dtensor(x):
        return x
    mesh = x.device_mesh
    pl = axis_layout(mesh, batch=(0, x.shape[0]))
    if any(p.is_shard() for p in pl) and tuple(x.placements) != pl:
        x = x.redistribute(mesh, pl)
    return x


def partial_over(placements, mesh_dims) -> tuple:
    """``placements`` with ``Partial()`` in place of ``Replicate`` on
    ``mesh_dims``: the layout of the gradient of an input every rank along
    those dims holds whole but uses for its own share of the work (a weight
    against a split batch, an activation against split heads or experts),
    so the ranks' gradients sum to the whole."""
    from torch.distributed.tensor import Partial

    return tuple(Partial() if i in mesh_dims and p.is_replicate() else p
                 for i, p in enumerate(placements))


class _PinGrad(torch.autograd.Function):
    """Identity forward; in the backward the gradient is laid out as
    ``placements`` (a partial sum reduced there)."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g, None


def pin_grad(x: torch.Tensor) -> torch.Tensor:
    """``x`` whose gradient is reduced to ``x``'s batch-only layout as soon as
    it arrives: a ``local_map``'d function whose input gradient is a partial
    sum (``partial_over``) leaves DTensor free to reduce-scatter it along a
    feature dim, whose non-contiguous shards a later view cannot take."""
    if not is_dtensor(x) or not x.requires_grad:
        return x
    return _PinGrad.apply(x, batch_only(x))


class _ContiguousGrad(torch.autograd.Function):
    """Identity forward; the backward hands on a contiguous gradient."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _contiguous_grads(fn: Callable) -> Callable:
    def run(*args):
        return fn(*(_ContiguousGrad.apply(t) if isinstance(t, torch.Tensor) and t.requires_grad
                    else t for t in args))
    return run


def site(name: str, fn: Callable, *, out_placements, in_placements, mesh=None,
         in_grad_placements=None):
    """``fn`` under ``local_map`` (inputs redistributed to
    ``in_placements``; their gradients laid out as ``in_grad_placements``,
    by default as the inputs), recorded in ``SITES`` as ``name``. On a mesh
    of more than one rank the local gradients leave ``fn`` contiguous: a
    DTensor made from a strided shard (an einsum's gradient) fails the
    views that follow it."""
    from torch.distributed.tensor.experimental import local_map

    SITES.add(name)
    if mesh is not None and mesh.size() > 1:
        fn = _contiguous_grads(fn)
    return local_map(fn, out_placements=out_placements, in_placements=in_placements,
                     in_grad_placements=in_grad_placements, device_mesh=mesh,
                     redistribute_inputs=True)


def all_reduce(t: torch.Tensor, op: str, mesh, mesh_dims: Sequence[int]) -> torch.Tensor:
    """``t`` reduced (``"sum"`` | ``"max"``) over ``mesh_dims`` of ``mesh``
    inside a ``local_map``'d function; the identity over no dims. The
    functional collectives have no backward: a site that autograd runs
    through returns a ``Partial`` output instead."""
    from torch.distributed import _functional_collectives as funcol

    for d in mesh_dims:
        t = funcol.all_reduce(t, op, (mesh, d))
    return t
