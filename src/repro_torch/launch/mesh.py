"""Device meshes: the one card, the production pods, the host's world.

Counterpart of ``repro.launch.mesh`` on ``torch.distributed``'s
``DeviceMesh``. Everything here is a FUNCTION, not a module constant, so
importing the module touches no process group.

* ``make_production_mesh(multi_pod=)``: the reference's pod meshes, 16 x 16
  ``("data", "model")`` and 2 x 16 x 16 ``("pod", "data", "model")``, over
  the process group that is up (256 or 512 ranks). The dry run starts a
  fake group of that size in one process (``start_fake_group``): its ranks
  run no collective, and DTensor's propagation over meta tensors gives each
  rank's shapes and the collectives it would issue.
* ``make_host_mesh(model_axis=)``: a (world / model_axis, model_axis) mesh
  over the world that is up: one rank on the card (NCCL, ``"cuda"``), gloo
  ranks on the CPU.
* ``data_axes(mesh)``: the axes that carry the batch.

The mesh records (``Mesh``) name the dry run's cells: ``h100x1`` (one
card), ``h100x16x16`` and ``h100x2x16x16`` (the pods, priced with
``H100_SXM`` by ``benchmarks/roofline_report``).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch.distributed as dist


class Mesh(NamedTuple):
    name: str
    n_devices: int


H100X1 = Mesh("h100x1", 1)
H100X16X16 = Mesh("h100x16x16", 256)
H100X2X16X16 = Mesh("h100x2x16x16", 512)

POD_SHAPE = (16, 16)
POD_AXES = ("data", "model")
MULTI_POD_SHAPE = (2, 16, 16)
MULTI_POD_AXES = ("pod", "data", "model")


def pod_mesh_record(multi_pod: bool) -> Mesh:
    return H100X2X16X16 if multi_pod else H100X16X16


def start_fake_group(world_size: int) -> None:
    """Make the default process group a fake one of ``world_size`` ranks in
    this process (rank 0), replacing one of another size. Its collectives
    move nothing; it exists so that a ``DeviceMesh`` of a pod's size can be
    built on one host for the dry run and the CPU tests."""
    try:   # an internal module of PyTorch's test suite: imported here only
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:  # pragma: no cover -- depends on the install
        raise RuntimeError(
            "the pod dry run needs PyTorch's fake process group "
            "(torch.testing._internal.distributed.fake_pg), missing from this "
            f"install: {e}") from e
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def _mesh(device_type: str, shape: Tuple[int, ...], axes: Tuple[str, ...]):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    """16 x 16 = 256 chips per pod; ``multi_pod`` adds a leading 2-pod axis.
    Needs a process group of 256 (512) ranks: ``start_fake_group`` for the
    dry run, whose ranks hold ``"cpu"`` (meta) tensors."""
    shape, axes = (MULTI_POD_SHAPE, MULTI_POD_AXES) if multi_pod else (POD_SHAPE, POD_AXES)
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized() or dist.get_world_size() != n:
        raise RuntimeError(f"make_production_mesh(multi_pod={multi_pod}) needs a process "
                           f"group of {n} ranks (start_fake_group({n}) for a dry run)")
    return _mesh("cpu", shape, axes)


def make_host_mesh(*, model_axis: int = 1):
    """(world / model_axis, model_axis) ``("data", "model")`` mesh over the
    process group that is up: ``"cuda"`` under NCCL, else ``"cpu"``."""
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs a process group: "
                           "torch.distributed.init_process_group first")
    n = dist.get_world_size()
    if n % model_axis:
        raise ValueError(f"model_axis {model_axis} does not divide the world of {n}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return _mesh(device_type, (n // model_axis, model_axis), POD_AXES)


class MeshShape(NamedTuple):
    """A mesh's axis names and sizes without devices or a process group:
    enough for the sharding rules (``launch/sharding.py``), which read
    nothing else of a ``DeviceMesh``."""
    mesh_dim_names: Tuple[str, ...]
    shape: Tuple[int, ...]


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or a ``MeshShape``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def data_axes(mesh) -> tuple:
    """Mesh axes that carry the batch (grad-reduction axes)."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))
