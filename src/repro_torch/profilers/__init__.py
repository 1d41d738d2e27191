"""Profilers (paper §6): program information collection.  (The network
and energy profilers of the JAX package are not ported yet.)"""

from repro_torch.profilers.program import (
    app_profile_from_config,
    boundary_act_bytes,
    layer_flops,
    layer_param_bytes,
    layer_param_count,
    stage_specs,
)

__all__ = [
    "app_profile_from_config",
    "boundary_act_bytes",
    "layer_flops",
    "layer_param_bytes",
    "layer_param_count",
    "stage_specs",
]
