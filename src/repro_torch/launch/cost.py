"""The dry run's counter: what one step costs, read off the step run on
``device="meta"`` tensors.

``CostCounter`` is a ``TorchDispatchMode``. Every ATen op the step
dispatches passes through it, and it records

* ``flops``: the FLOPs of every matmul-like op, by the formulas of
  ``torch.utils.flop_counter`` (``flop_registry``: mm, bmm, addmm,
  baddbmm, convolutions, the fused attention ops);
* ``bytes``: the bytes of every op's tensor inputs and outputs, each op
  counted on its own. It stands in for XLA's ``bytes accessed``, but
  nothing is fused: an elementwise chain that XLA would fuse into one pass
  counts each of its ops' reads and writes. Views and ``empty`` allocations
  move nothing and count nothing; an indexed read (``buf[rows, pos]``, an
  embedding lookup, a gather) counts its indices and the elements it reads
  and writes, not the whole tensor it reads from, and an indexed write in
  place (``index_put_``, a scatter) its indices and values and the
  elements it writes, not the whole tensor written into;
* ``kernels``: each hand-written kernel the step would launch, by name, its
  calls and its ``kernels.cost`` count (the wrappers' meta branch calls
  ``add_kernel``); their bytes and operations are added to ``bytes`` and
  ``flops``, since no ATen op of theirs passes through the mode;
* ``peak_bytes``: the peak, over the step, of the bytes held by storages
  the step allocated. An estimate standing in for XLA's
  ``temp_size_in_bytes``: it assumes each storage is freed as soon as
  Python drops its last reference, with no caching allocator and no
  fragmentation, and it counts the step's outputs among the live storages.
"""
from __future__ import annotations

import collections
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten
# allocations that write nothing (views move nothing either: ``func.is_view``)
_NO_TRAFFIC = {aten.empty, aten.empty_like, aten.new_empty, aten.empty_strided,
               aten.new_empty_strided}
# indexed reads of their first argument, and indexed writes into it in place
_GATHERS = {aten.index, aten._unsafe_index, aten.index_select, aten.gather, aten.embedding}
_SCATTERS = {aten.index_put_, aten._index_put_impl_, aten.index_copy_, aten.index_add_,
             aten.scatter_, aten.scatter_add_, aten.scatter_reduce_}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CostCounter(TorchDispatchMode):
    """Counts a step's FLOPs, bytes, kernel calls and peak live storage;
    use as ``with CostCounter() as c: step(...)``."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.flops_by_op = collections.Counter()
        self.bytes = 0
        self.kernels = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live = {}
        self._outside = set()

    def exclude(self, tensors) -> None:
        """Storages that exist before the step (its arguments): an op that
        writes them in place allocates nothing."""
        self._outside.update(id(t.untyped_storage()) for t in tensors)

    def add_kernel(self, name: str, cost) -> None:
        """One call of hand-written kernel ``name`` with ``cost`` (a
        ``kernels.cost.Cost``)."""
        k = self.kernels.setdefault(name, {"calls": 0, "bytes": 0, "ops": 0})
        k["calls"] += 1
        k["bytes"] += cost.bytes
        k["ops"] += cost.ops
        self.bytes += cost.bytes
        self.flops += cost.ops

    def _free(self, key: int, nbytes: int) -> None:
        if self._live.pop(key, None) is not None:
            self.live_bytes -= nbytes

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._live or key in self._outside:
            return
        nbytes = st.nbytes()
        self._live[key] = nbytes
        self.live_bytes += nbytes
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key, nbytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        if packet in flop_registry:
            n = int(flop_registry[packet](*args, **kwargs, out_val=out))
            self.flops += n
            self.flops_by_op[str(packet)] += n
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if not (func.is_view or packet in _NO_TRAFFIC):
            ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
            if packet in _GATHERS:        # indices read, elements read and written
                self.bytes += sum(_nbytes(t) for t in ins[1:]) + 2 * sum(map(_nbytes, outs))
            elif packet in _SCATTERS:     # indices and values read, values written
                self.bytes += sum(_nbytes(t) for t in ins[1:]) + _nbytes(ins[-1])
            else:
                self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        for t in outs:
            self._track(t)
        return out

    def record(self) -> dict:
        """The counts as a JSON-ready dict."""
        return {"flops": self.flops, "flops_by_op": dict(self.flops_by_op),
                "bytes": self.bytes, "peak_bytes": self.peak_bytes,
                "kernels": {k: dict(v) for k, v in sorted(self.kernels.items())}}
