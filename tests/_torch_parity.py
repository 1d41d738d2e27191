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


# ----------------------------------------------------------------------
# Models: the same parameters in both packages, caches compared key by key
# ----------------------------------------------------------------------


def model_pair(arch, *, dtype="float32", seed=0, **overrides):
    """(config, repro model, repro params, port model, port params) of the
    reduced ``arch``: the JAX parameters carried into the port's model
    through ``convert.model_params_from_jax``, its key set checked."""
    import dataclasses

    import jax

    from repro.configs import ARCHITECTURES, reduce_config
    from repro.models.transformer import Model as JModel
    from repro_torch.configs import ARCHITECTURES as T_ARCHITECTURES
    from repro_torch.configs import reduce_config as t_reduce_config
    from repro_torch.models.transformer import Model as TModel

    j_cfg = reduce_config(ARCHITECTURES[arch], dtype=dtype, **overrides)
    t_cfg = t_reduce_config(T_ARCHITECTURES[arch], dtype=dtype, **overrides)
    assert dataclasses.asdict(j_cfg) == dataclasses.asdict(t_cfg)
    j_model = JModel(j_cfg)
    j_params = j_model.init(jax.random.PRNGKey(seed))
    t_model = TModel(t_cfg, device="cpu")
    t_params = t_model.init(seed)
    sd = convert.model_params_from_jax(jax.tree_util.tree_map(np.asarray, j_params), t_cfg)
    assert set(sd) == set(t_params.state_dict())
    t_params.load_state_dict(sd)
    return t_cfg, j_model, j_params, t_model, t_params


def flat_cache(cache, prefix=""):
    """A nested cache dict as ``{"a/b": leaf}`` (leaves: arrays, tensors, ints)."""
    out = {}
    for key, val in cache.items():
        if isinstance(val, dict):
            out.update(flat_cache(val, f"{prefix}{key}."))
        else:
            out[prefix + key] = val
    return out


def hold_cache(t_cache, j_cache, tol):
    """The port's cache holds the JAX cache's keys, length and values."""
    got, want = flat_cache(t_cache), flat_cache(j_cache)
    assert set(got) == set(want)
    for key, val in want.items():
        if key == "length":
            assert got[key] == int(val)
        else:
            np.testing.assert_allclose(got[key].float().numpy(), np.asarray(val, np.float32),
                                       atol=tol, rtol=tol, err_msg=key)
