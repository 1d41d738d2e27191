"""Meshes: the production and local meshes of training, and the solver
fleet's device list.

The training meshes are ``torch.distributed.device_mesh.DeviceMesh``\\ es
with the JAX package's shapes and axis names: one rank a device, ranks laid
out in row-major order over the axes.  They are built over the process
group the caller has made (``torch.distributed.init_process_group``: NCCL
across GPUs, gloo in the tests).  Nothing here makes a process group or
picks a backend; without one the builders raise.  ``device="cuda"`` (the
default) needs a GPU and raises :class:`KernelError` without one;
``device="cpu"`` builds a mesh over CPU tensors (the tests' gloo worlds).

The JAX package's ``use_mesh`` has no counterpart (see
``runtime.sharding``): a DTensor carries its mesh.

PyTorch has no solver-mesh object, so :class:`SolverMesh` is a small value
of its own: the devices in shard order and the axis name ``"solve"``.  A
device may repeat.  Repeated ``"cpu"`` entries stand in for the forced
host devices with which the JAX package's tests simulate a fleet, and
repeated ``"cuda:0"`` entries drive every shard through the kernels of
one GPU.  Nothing here touches a device: the fleet is resolved and used
by ``repro_torch.core.mcop_shard``.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.kernels.build import KernelError

__all__ = [
    "POD_CHIPS",
    "make_mesh",
    "make_production_mesh",
    "make_local_mesh",
    "SolverMesh",
    "make_solver_mesh",
]

POD_CHIPS = 256  # devices of one pod: the 16 x 16 ("data", "model") mesh


def _world(device: str) -> int:
    """The caller's world size, once the device and the group are there."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise KernelError("no CUDA device to build a mesh over")
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("no process group: call torch.distributed.init_process_group "
                           "before building a mesh")
    return dist.get_world_size()


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *,
              device: str = "cuda") -> DeviceMesh:
    """A mesh of ``shape`` named ``axes`` over the whole world of the
    caller's process group, whose size must be the product of ``shape``."""
    world = _world(device)
    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    if math.prod(shape) != world:
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks, the world has {world}")
    return DeviceMesh(torch.device(device).type, torch.arange(world).reshape(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda") -> DeviceMesh:
    """16 x 16 ("data", "model") on one pod, or 2 x 16 x 16 ("pod", "data",
    "model") across two: a world of 256 or 512 ranks."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"), device=device)
    return make_mesh((16, 16), ("data", "model"), device=device)


def make_local_mesh(*, data: int | None = None, model: int = 1,
                    device: str = "cuda") -> DeviceMesh:
    """("data", "model") over whatever world exists: ``data`` defaults to
    ``world // model``, and ``data * model`` must be the world."""
    world = _world(device)
    if data is None:
        data = world // model
    if data * model != world:
        raise ValueError(f"data {data} x model {model} != world {world}")
    return make_mesh((data, model), ("data", "model"), device=device)


@dataclasses.dataclass(frozen=True)
class SolverMesh:
    """A 1-D solver fleet: shard ``s`` of a solve batch runs on
    ``devices[s]``."""

    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...] = ("solve",)

    def __post_init__(self) -> None:
        if len(self.axis_names) != 1:
            raise ValueError(f"a solver mesh has one axis, got {self.axis_names}")


def make_solver_mesh(devices=None) -> SolverMesh:
    """1-D mesh over the solver fleet's devices, axis name ``"solve"``.

    ``devices=None`` takes every CUDA device this process sees, in index
    order; with none it raises :class:`KernelError` (it never builds a CPU
    fleet unasked).  An explicit list (device names or ``torch.device``)
    is used as given, repeats included; an empty one raises
    ``ValueError``.
    """
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise KernelError("no CUDA device to build a solver mesh over")
        devs = [torch.device("cuda", i) for i in range(count)]
    else:
        devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("cannot build a solver mesh over zero devices")
    return SolverMesh(tuple(devs))
