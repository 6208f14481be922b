"""Sharding rules engine: param / cache / batch / state trees -> specs, and
specs -> DTensor placements.

Counterpart of ``repro.launch.sharding``, with the same rule tables and the
same greedy engine. Rules are ordered (mesh_axis, tensor_dim) preferences
keyed by leaf name (and ndim where names collide). The engine assigns
greedily, skipping any assignment whose dimension is not divisible by the
mesh axis size, so the same table serves every architecture (gemma-2b's
kv=1 MQA, deepseek's 128 heads, mamba2's head counts) and every mesh.
Unknown leaves fall back to largest-dim-over-'model'.

Params are 2-D sharded (TP dim over 'model', complementary dim over 'data',
FSDP style); decode caches shard batch over the data axes and the
*sequence* over 'model' (kv-head counts 1, 8, 32, 36 are mostly not
divisible by 16, sequence always is). Params are replicated across pods;
activations and batches shard over ('pod', 'data').

A spec (``PartitionSpec``) has one entry per tensor dim: ``None``, an axis
name, or a tuple of axis names, as ``jax.sharding.PartitionSpec`` holds them (the
CPU tests compare the two leaf for leaf). ``placements(spec, mesh)`` turns
one into DTensor placements: a dim sharded over ``("pod", "data")`` is
``Shard(d)`` on both mesh dims, pod-major as XLA lays it out;
``distribute(tree, specs, mesh)`` places a whole tree. Leaf names are the
port's tree paths (``training/tree.py``: ``/stages/0/b0/attn/wq``).
"""
from __future__ import annotations

import re
from typing import Any, List, Optional, Sequence, Tuple

import torch

from repro_torch.launch.mesh import axis_sizes
from repro_torch.training import tree as T


class PartitionSpec:
    """One leaf's layout: per tensor dim ``None``, an axis name or a tuple of
    axis names. Not a tuple, so the tree helpers (``training/tree.py``)
    treat it as a leaf; it iterates, indexes and compares like one."""

    __slots__ = ("dims",)

    def __init__(self, *dims):
        self.dims = tuple(dims)

    def __iter__(self):
        return iter(self.dims)

    def __len__(self):
        return len(self.dims)

    def __getitem__(self, i):
        return self.dims[i]

    def __eq__(self, other):
        return tuple(self) == tuple(other) if isinstance(other, (PartitionSpec, tuple)) \
            else NotImplemented

    def __hash__(self):
        return hash(self.dims)

    def __repr__(self):
        return f"PartitionSpec{self.dims!r}"


P = PartitionSpec
Spec = PartitionSpec

# ---------------------------------------------------------------- rule table
# name (regex) -> list of (mesh_axis_role, dim) preferences. Roles: "model"
# or "data"; dim indices are AFTER stripping the leading n_units stack dim.
# The first applicable preference per mesh axis wins.
_PARAM_RULES: List[Tuple[str, Optional[int], List[Tuple[str, int]]]] = [
    # (name_pattern, ndim or None=any, preferences)
    (r"table$", 2, [("model", 0), ("data", 1), ("model", 1)]),
    (r"(wq|wk|wv)$", 3, [("model", 1), ("data", 0), ("model", 0), ("model", 2)]),
    (r"(wo|w_o)$", 3, [("model", 0), ("data", 2), ("model", 2)]),
    (r"w_gate$", 3, [("model", 1), ("data", 0)]),          # gdn output gate
    (r"(w_gate|w_up)$", 2, [("model", 1), ("data", 0)]),   # mlp
    (r"w_down$", 2, [("model", 0), ("data", 1)]),
    (r"router$", 2, [("model", 1), ("data", 0)]),
    (r"(w_gate|w_up)$", 3, [("model", 0), ("data", 1)]),   # moe experts (E,d,ff)
    (r"w_down$", 3, [("model", 0), ("data", 2)]),          # moe (E,ff,d)
    (r"(w_uk|w_uv|w_uq)$", 3, [("model", 1), ("data", 0), ("model", 0)]),
    (r"(w_dkv|w_dq|w_kr)$", 2, [("model", 1), ("data", 0), ("model", 0)]),
    (r"w_in$", 2, [("model", 1), ("data", 0)]),
    (r"conv_w$", 2, [("model", 1)]),
    (r"(conv_b)$", 1, [("model", 0)]),
    (r"(a_log|d_skip|dt_bias)$", 1, [("model", 0)]),
    (r"(w_beta|w_alpha)$", 2, [("model", 1), ("data", 0)]),
    (r"w_out$", 2, [("model", 0), ("data", 1)]),
    (r"scale$", 1, []),                                    # norms: replicate
    (r"gate$", 0, []),
]

_CACHE_RULES: List[Tuple[str, Optional[int], List[Tuple[str, int]]]] = [
    (r"[/.]?(k|v)$", 4, [("data", 0), ("model", 1), ("data", 1)]),   # (B,L,KV,hd)
    (r"(ckv)$", 3, [("data", 0), ("model", 1), ("data", 1)]),        # (B,L,rank)
    (r"(kr)$", 3, [("data", 0), ("model", 1), ("data", 1)]),
    (r"(ssm)$", 4, [("data", 0), ("model", 1)]),                     # (B,H,P,N)
    (r"(conv)$", 3, [("data", 0), ("model", 2)]),                    # (B,K-1,C)
    (r"(gdn)$", 4, [("data", 0), ("model", 1)]),                     # (B,H,K,K)
]


def _prod(xs) -> int:
    n = 1
    for x in xs:
        n *= int(x)
    return n


def _role_axes(mesh, role: str) -> Tuple[str, ...]:
    """'data' role covers ('pod','data') on multi-pod meshes for batch-like
    dims; for params the 'data' role is the 'data' axis only (params are
    replicated across pods)."""
    if role == "model":
        return ("model",)
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def _assign(shape: Sequence[int], prefs: List[Tuple[str, int]], mesh, *,
            data_axes_combined: bool) -> Spec:
    sizes = axis_sizes(mesh)
    dims: List[Any] = [None] * len(shape)
    used_mesh: set = set()
    for role, dim in prefs:
        if dim >= len(shape):
            continue
        if role == "data" and data_axes_combined:
            axes = _role_axes(mesh, "data")
        else:
            axes = (role,) if role in sizes else ()
        axes = tuple(a for a in axes if a not in used_mesh)
        if not axes:
            continue
        total = _prod(sizes[a] for a in axes)
        if dims[dim] is not None or total == 0:
            continue
        if shape[dim] % total == 0 and shape[dim] > 0:
            dims[dim] = axes if len(axes) > 1 else axes[0]
            used_mesh.update(axes)
        elif len(axes) > 1:
            # try just the plain 'data' axis
            a = axes[-1]
            if shape[dim] % sizes[a] == 0:
                dims[dim] = a
                used_mesh.add(a)
    return P(*dims)


def _fallback_spec(shape: Sequence[int], mesh) -> Spec:
    """Largest-dim over 'model', second-largest over 'data'."""
    sizes = axis_sizes(mesh)
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    dims: List[Any] = [None] * len(shape)
    roles = ["model", "data"]
    for dim in order:
        if not roles:
            break
        role = roles[0]
        if role in sizes and shape[dim] % sizes[role] == 0 and shape[dim] >= sizes[role]:
            dims[dim] = role
            roles.pop(0)
    return P(*dims)


def _match(rules, name: str, ndim: int):
    for pat, nd, prefs in rules:
        if re.search(pat, name) and (nd is None or nd == ndim):
            return prefs
    return None


def _spec_for_leaf(name: str, leaf, mesh, rules, *, stacked_under_stages: bool,
                   data_axes_combined: bool) -> Spec:
    shape = tuple(leaf.shape)
    lead_none = 0
    if stacked_under_stages and "stages" in name:
        lead_none = 1
        shape = shape[1:]
    if len(shape) == 0:
        return P()
    key = name.split("/")[-1]
    prefs = _match(rules, key, len(shape))
    if prefs is None:
        spec = _fallback_spec(shape, mesh)
    else:
        spec = _assign(shape, prefs, mesh, data_axes_combined=data_axes_combined)
    return P(*([None] * lead_none), *spec)


def _drop_data(prefs):
    return [(role, dim) for role, dim in prefs if role != "data"]


def _param_rules(fsdp: bool):
    return _PARAM_RULES if fsdp else [
        (pat, nd, _drop_data(prefs)) for pat, nd, prefs in _PARAM_RULES]


def _by_path(fn, tree):
    return T.unflatten(tree, [fn(p, leaf) for p, leaf in zip(T.paths(tree), T.leaves(tree))])


def param_shardings(params_like: Any, mesh, *, fsdp: bool = True) -> Any:
    """Spec tree for params (concrete or meta).

    ``fsdp=False`` drops the 'data'-axis (ZeRO-style) dimension from every
    rule: small models keep params replicated across data and sharded over
    'model' only, avoiding the batch-vs-FSDP axis conflict that otherwise
    replicates activations. Use FSDP only when params and optimizer do not
    fit model-parallel sharding alone (``needs_fsdp``).
    """
    rules = _param_rules(fsdp)
    return _by_path(lambda name, leaf: _spec_for_leaf(
        name, leaf, mesh, rules, stacked_under_stages=True, data_axes_combined=False),
        params_like)


def cache_shardings(cache_like: Any, mesh) -> Any:
    return _by_path(lambda name, leaf: _spec_for_leaf(
        name, leaf, mesh, _CACHE_RULES, stacked_under_stages=True, data_axes_combined=True),
        cache_like)


def batch_shardings(batch_like: Any, mesh) -> Any:
    """Batch-dim-0 sharding over ('pod','data') with divisibility fallback."""
    dp = _role_axes(mesh, "data")
    sizes = axis_sizes(mesh)
    total = _prod(sizes[a] for a in dp)

    def f(leaf):
        shape = tuple(leaf.shape)
        if shape and shape[0] % total == 0:
            return P(dp if len(dp) > 1 else dp[0], *([None] * (len(shape) - 1)))
        if shape and len(dp) > 1 and shape[0] % sizes["data"] == 0:
            return P("data", *([None] * (len(shape) - 1)))
        return P(*([None] * len(shape)))

    return T.map(f, batch_like)


def state_shardings(state_like: Any, mesh, *, fsdp: bool = True) -> Any:
    """TrainState: params / mu / nu / error_buf shard like params; scalars
    replicate."""
    rules = _param_rules(fsdp)

    def f(name, leaf):
        if len(leaf.shape) == 0:
            return P()
        return _spec_for_leaf(name, leaf, mesh, rules, stacked_under_stages=True,
                              data_axes_combined=False)
    return _by_path(f, state_like)


def needs_fsdp(cfg, mesh, budget_bytes: float = 8e9) -> bool:
    """FSDP ('data'-axis param sharding) only when bf16 params + fp32 Adam
    moments exceed the per-device budget under model-only sharding."""
    model_ways = axis_sizes(mesh).get("model", 1)
    per_dev = cfg.param_count() * (2 + 4 + 4) / model_ways
    return per_dev > budget_bytes


def replicated(mesh) -> Spec:
    """The spec of a replicated leaf (any rank: ``placements`` pads it)."""
    return P()


# ------------------------------------------------------------ DTensor layout
def placements(spec: Spec, mesh) -> tuple:
    """A spec -> one DTensor placement per mesh dim: ``Shard(d)`` on every
    mesh axis of more than one rank that spec entry ``d`` names,
    ``Replicate()`` elsewhere (on a mesh of one rank everything is
    replicated, so the step runs as on one device). Mesh axes sharding one
    dim split it in mesh order (pod-major)."""
    from torch.distributed.tensor import Replicate, Shard

    sizes = axis_sizes(mesh)
    out = [Replicate()] * len(mesh.mesh_dim_names)
    for d, entry in enumerate(spec):
        for a in (() if entry is None else (entry,) if isinstance(entry, str) else entry):
            if sizes[a] > 1:       # a shard over one rank is the whole tensor
                out[mesh.mesh_dim_names.index(a)] = Shard(d)
    return tuple(out)


def local_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """The shard shape of a ``shape`` tensor laid out by ``spec`` (the
    reference's ``NamedSharding.shard_shape``; the rules only shard evenly)."""
    sizes = axis_sizes(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        if entry is not None:
            axes = (entry,) if isinstance(entry, str) else entry
            out[d] //= _prod(sizes[a] for a in axes)
    return tuple(out)


def distribute(tree: Any, specs: Any, mesh) -> Any:
    """Each tensor leaf of ``tree`` as a DTensor laid out by its spec. Every
    rank holds the same full tensor (made from one seed), so a shard is cut
    locally with no communication; a meta leaf becomes a meta shard of the
    local shape."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def one(t, spec):
        if not isinstance(t, torch.Tensor):
            return t
        pl = placements(spec, mesh)
        if t.is_meta:
            local = torch.empty(local_shape(t.shape, spec, mesh), dtype=t.dtype, device="meta")
            return DTensor.from_local(local, mesh, pl, run_check=False,
                                      shape=t.shape, stride=t.stride())
        return distribute_tensor(t, mesh, pl, src_data_rank=None)

    return T.map(one, tree, specs)
