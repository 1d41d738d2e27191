"""Distributed runtime: the solver fleet's sharding helpers and elastic
re-placement.

Ported so far: ``sharding`` (the solver part) and ``elastic``.  The
training runtime of the JAX package (the rest of ``sharding``,
``pipeline``, ``compression``) comes with ROADMAP Queue A item 14.
"""

from repro_torch.runtime.elastic import (
    DeviceState,
    ElasticEvent,
    ElasticMeshManager,
    HeartbeatMonitor,
    PendingElasticEvent,
)
from repro_torch.runtime.sharding import SOLVE_AXIS, solver_axis, solver_shards

__all__ = [
    "DeviceState",
    "ElasticEvent",
    "ElasticMeshManager",
    "HeartbeatMonitor",
    "PendingElasticEvent",
    "SOLVE_AXIS",
    "solver_axis",
    "solver_shards",
]
