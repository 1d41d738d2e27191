"""Distributed runtime: sharding rules (parameters, states, inputs and
the solver fleet's axis), the GPipe pipeline over ``"pod"``, elastic
re-placement and gradient compression."""

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
from repro_torch.runtime.pipeline import pipeline_apply, pipeline_spec_for, stack_stage_params
from repro_torch.runtime.sharding import (
    FSDP_MIN_ELEMENTS,
    SOLVE_AXIS,
    batch_axes,
    input_shardings,
    logical_batch_spec,
    param_shardings,
    param_spec,
    param_specs,
    placements,
    shard_params,
    solver_axis,
    solver_shards,
    state_shardings,
)

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
    "pipeline_apply",
    "pipeline_spec_for",
    "stack_stage_params",
    "FSDP_MIN_ELEMENTS",
    "batch_axes",
    "input_shardings",
    "logical_batch_spec",
    "param_shardings",
    "param_spec",
    "param_specs",
    "placements",
    "shard_params",
    "state_shardings",
    "SOLVE_AXIS",
    "solver_axis",
    "solver_shards",
]
