"""Helpers shared by the ``test_torch_*`` parity suites.

Both packages are imported here and only here in the test tree's helper
layer: inputs are made with numpy from a seed, handed to ``repro`` (JAX,
on the CPU) and to ``repro_torch`` (``device="cpu"``), and state crosses
between them as numpy arrays and plain dicts through
``repro_torch.convert``.
"""

import numpy as np

import repro.core as J
import repro_torch.core as T
from repro_torch import convert


def wcg_pair(g_jax):
    """The port's WCG holding the same arrays as a ``repro`` WCG."""
    return convert.wcg_from_arrays(
        np.asarray(g_jax.w_local), np.asarray(g_jax.w_cloud),
        np.asarray(g_jax.adj), np.asarray(g_jax.offloadable), g_jax.names,
    )


def profile_pair(p_jax):
    return convert.profile_from_arrays(
        np.asarray(p_jax.t_local), np.asarray(p_jax.data_in),
        np.asarray(p_jax.data_out), np.asarray(p_jax.offloadable), p_jax.names,
    )


def env_pair(rng, k):
    """K seeded environments as (repro EnvArrays, port EnvArrays)."""
    def log_uniform(lo, hi):
        # two decades: from nothing worth offloading to everything
        return np.exp(rng.uniform(np.log(lo), np.log(hi), k))

    cols = {
        "bandwidth_up": log_uniform(0.02, 8.0),
        "bandwidth_down": log_uniform(0.02, 8.0),
        "speedup": log_uniform(1.02, 6.0),
        "p_compute": rng.uniform(0.5, 1.5, k),
        "p_idle": rng.uniform(0.1, 0.5, k),
        "p_transfer": rng.uniform(0.8, 2.0, k),
    }
    return (
        J.EnvArrays(*(cols[f].copy() for f in J.EnvArrays._fields)),
        convert.env_arrays_from_columns(cols),
    )


def models():
    """(name, repro model, port model) for the three built-in objectives."""
    return [
        ("time", J.ResponseTimeModel(), T.ResponseTimeModel()),
        ("energy", J.EnergyModel(), T.EnergyModel()),
        ("weighted", J.WeightedModel(0.3), T.WeightedModel(0.3)),
    ]


def event_key(e):
    """Everything an AdaptationEvent says, as comparable plain values."""
    return (
        e.step,
        tuple(float(getattr(e.env, f)) for f in J.EnvArrays._fields),
        float(e.result.min_cut),
        tuple(bool(b) for b in e.result.local_mask),
        float(e.partial_cost),
        float(e.no_offload_cost),
        float(e.full_offload_cost),
        float(e.gain),
        bool(e.repartitioned),
        bool(e.cache_hit),
    )


def placement_key(e):
    """The decision part of an event (for f32 backends: no cut values)."""
    return (
        e.step,
        tuple(bool(b) for b in e.result.local_mask),
        bool(e.repartitioned),
        bool(e.cache_hit),
    )
