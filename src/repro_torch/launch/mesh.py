"""The solver fleet's mesh: an ordered list of devices on one axis.

Only :func:`make_solver_mesh` is here: the JAX package's
``make_production_mesh``, ``make_local_mesh``, ``use_mesh`` and
``POD_CHIPS`` build meshes for training and its dry run, which this
package does not have yet (ROADMAP, Queue A item 14).

PyTorch has no mesh object, so :class:`SolverMesh` is a small value of
its own: the devices in shard order and the axis name ``"solve"``.  A
device may repeat.  Repeated ``"cpu"`` entries stand in for the forced
host devices with which the JAX package's tests simulate a fleet, and
repeated ``"cuda:0"`` entries drive every shard through the kernels of
one GPU.  Nothing here touches a device: the fleet is resolved and used
by ``repro_torch.core.mcop_shard``.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.build import KernelError

__all__ = ["SolverMesh", "make_solver_mesh"]


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
