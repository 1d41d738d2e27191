"""Distributed runtime: the solver fleet's sharding helpers, elastic
re-placement and gradient compression.

Ported so far: ``sharding`` (the solver part), ``elastic`` and
``compression``.  The rest of the JAX package's training runtime (the
rest of ``sharding``, ``pipeline``) is still to come (ROADMAP Queue A).
"""

from repro_torch.runtime.compression import (
    CompressionState,
    init_compression_state,
    int8_compress,
    int8_decompress,
    topk_compress_with_ef,
    wire_bytes,
)

from repro_torch.runtime.elastic import (
    DeviceState,
    ElasticEvent,
    ElasticMeshManager,
    HeartbeatMonitor,
    PendingElasticEvent,
)
from repro_torch.runtime.sharding import SOLVE_AXIS, solver_axis, solver_shards

__all__ = [
    "CompressionState",
    "init_compression_state",
    "int8_compress",
    "int8_decompress",
    "topk_compress_with_ef",
    "wire_bytes",
    "DeviceState",
    "ElasticEvent",
    "ElasticMeshManager",
    "HeartbeatMonitor",
    "PendingElasticEvent",
    "SOLVE_AXIS",
    "solver_axis",
    "solver_shards",
]
