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

On a step over DTensors (the pod dry run) the counter steps aside for every
op on DTensors (``NotImplemented``, as PyTorch's ``CommDebugMode`` does), so
DTensor splits it into the ops on each rank's shards and their collectives,
and only those reach the counts (DTensor's fake-tensor runs at global
shapes, which infer each op's output layout, run uncounted): FLOPs and bytes PER DEVICE, as XLA's
partitioned module reports them. Collectives move no bytes of ``bytes``:
``CollectiveCounter`` counts them, each in program order with its
per-device operand bytes and the op name XLA gives it (all-gather,
all-reduce, reduce-scatter, all-to-all, collective-permute), into the
reference's ``hlo_stats.CollectiveStats``.
"""
from __future__ import annotations

import collections
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.launch.hlo_stats import CollectiveStats

aten = torch.ops.aten
# allocations that write nothing (views move nothing either: ``func.is_view``)
_NO_TRAFFIC = {aten.empty, aten.empty_like, aten.new_empty, aten.empty_strided,
               aten.new_empty_strided}
# indexed reads of their first argument, and indexed writes into it in place
_GATHERS = {aten.index, aten._unsafe_index, aten.index_select, aten.gather, aten.embedding}
_SCATTERS = {aten.index_put_, aten._index_put_impl_, aten.index_copy_, aten.index_add_,
             aten.scatter_, aten.scatter_add_, aten.scatter_reduce_}


# the functional collectives DTensor issues (and the c10d ops a process group
# runs when called directly) -> the name XLA gives the same collective
COLLECTIVE_NAMES = {
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
}
_COMM_NAMESPACES = ("_c10d_functional", "c10d_functional", "c10d",
                    "_c10d_functional_autograd")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _on_dtensors(types) -> bool:
    from torch.distributed.tensor import DTensor
    return any(t is not torch.Tensor and issubclass(t, DTensor) for t in types)


def _on_fakes(types) -> bool:
    """One of the fake-tensor runs by which DTensor infers an op's global
    output shape (its fake arguments' allocations included): no work of a
    rank."""
    from torch._subclasses.fake_tensor import FakeTensor
    if torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None:
        return True
    return any(t is not torch.Tensor and issubclass(t, FakeTensor) for t in types)


def _comm_name(func):
    """(is a communication op, its XLA collective name or None)."""
    if func.namespace not in _COMM_NAMESPACES:
        return False, None
    return True, COLLECTIVE_NAMES.get(func.overloadpacket.__name__)


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
        if _on_dtensors(types):       # DTensor splits it into per-shard ops first
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _on_fakes(types) or _comm_name(func)[0]:   # collectives: CollectiveCounter's
            return out
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


class CollectiveCounter(TorchDispatchMode):
    """Records every collective a step issues on each rank, in program order:
    ``with CollectiveCounter() as cc: step(...)``; ``cc.stats()`` is the
    reference's ``CollectiveStats`` (bytes and counts by op, the schedule).
    Bytes are the operand's on one rank (the local shard an all-gather
    sends, the whole local tensor an all-reduce or reduce-scatter reduces),
    as the partitioned HLO's shapes are per device."""

    def __init__(self):
        super().__init__()
        self.schedule = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _on_dtensors(types):
            return NotImplemented
        kwargs = kwargs or {}
        name = _comm_name(func)[1]
        if name is not None and not _on_fakes(types):
            # c10d's in-place ops take (outputs, inputs) but for all-reduce and broadcast
            out_first = func.namespace == "c10d" and name not in ("all-reduce",
                                                                   "collective-permute")
            operand = args[1] if out_first else args[0]
            ts = [operand] if isinstance(operand, torch.Tensor) else list(operand)
            self.schedule.append((name, sum(_nbytes(t) for t in ts)))
        return func(*args, **kwargs)

    def stats(self) -> CollectiveStats:
        by_bytes, by_count = collections.Counter(), collections.Counter()
        for name, b in self.schedule:
            by_bytes[name] += b
            by_count[name] += 1
        return CollectiveStats(dict(by_bytes), dict(by_count), list(self.schedule))
