"""Profilers (paper §6): program, network and energy information collection."""

from repro_torch.profilers.energy import EnergyProfiler, EnergyReport
from repro_torch.profilers.network import BandwidthSample, NetworkProfiler, SimulatedChannel
from repro_torch.profilers.program import (
    app_profile_from_config,
    boundary_act_bytes,
    layer_flops,
    layer_param_bytes,
    layer_param_count,
    stage_specs,
)

__all__ = [
    "BandwidthSample",
    "NetworkProfiler",
    "SimulatedChannel",
    "EnergyProfiler",
    "EnergyReport",
    "app_profile_from_config",
    "boundary_act_bytes",
    "layer_flops",
    "layer_param_bytes",
    "layer_param_count",
    "stage_specs",
]
