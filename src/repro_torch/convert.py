"""State carried across from the JAX package, as numpy arrays and dicts.

This package never imports the JAX package.  Whoever holds that package's
objects (the parity tests, a migration script) extracts their fields as
numpy arrays and plain dicts and hands them to the functions here, which
return this package's objects.  A
:class:`~repro_torch.core.placement_cache.PlacementCache` needs no
function of its own: the JSON snapshot either package writes
(``cache.snapshot()`` / ``cache.save(path)``) loads in the other
(:func:`placement_cache_from_snapshot` is a one-line convenience).

Model parameters cross as the JAX parameter tree with its leaves as numpy
arrays (``jax.tree_util.tree_map(np.asarray, params)``):
:func:`tree_to_state_dict` turns one module's tree into its
``state_dict``, :func:`model_params_from_jax` a whole model's.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.cost_models import AppProfile, EnvArrays
from repro_torch.core.graph import WCG, WCGBatch
from repro_torch.core.placement_cache import EnvQuantizer, PlacementCache
from repro_torch.core.session_batch import _LEAF_FIELDS, SessionBatch

__all__ = [
    "wcg_from_arrays",
    "wcg_batch_from_arrays",
    "profile_from_arrays",
    "env_arrays_from_columns",
    "session_batch_from_state",
    "placement_cache_from_snapshot",
    "tree_to_state_dict",
    "model_params_from_jax",
    "jax_leaf_ndim",
    "jax_leaf_groups",
    "jax_leaf_shapes",
    "weight_decay_mask",
]

ENV_COLUMNS = EnvArrays._fields


def wcg_from_arrays(w_local, w_cloud, adj, offloadable, names: Sequence[str] = ()) -> WCG:
    """A :class:`WCG` from its four arrays (copied, validated, float64)."""
    return WCG(
        w_local=np.array(w_local, dtype=np.float64),
        w_cloud=np.array(w_cloud, dtype=np.float64),
        adj=np.array(adj, dtype=np.float64),
        offloadable=np.array(offloadable, dtype=bool),
        names=list(names),
    )


def wcg_batch_from_arrays(
    w_local, w_cloud, adj, pinned, n_valid: Sequence[int] = (), names: Sequence[str] = ()
) -> WCGBatch:
    """A :class:`WCGBatch` from stacked ``(k, m[, m])`` arrays; dtypes are
    kept (float64 host batches stay bit-identical)."""
    return WCGBatch(
        np.array(w_local),
        np.array(w_cloud),
        np.array(adj),
        np.array(pinned, dtype=bool),
        n_valid=tuple(n_valid),
        names=tuple(names),
    )


def profile_from_arrays(
    t_local, data_in, data_out, offloadable, names: Sequence[str] = ()
) -> AppProfile:
    """An :class:`AppProfile` from the profiler's four arrays."""
    return AppProfile(
        t_local=np.array(t_local, dtype=np.float64),
        data_in=np.array(data_in, dtype=np.float64),
        data_out=np.array(data_out, dtype=np.float64),
        offloadable=np.array(offloadable, dtype=bool),
        names=list(names),
    )


def env_arrays_from_columns(columns) -> EnvArrays:
    """:class:`EnvArrays` from six ``(k,)`` columns: a mapping keyed by
    field name, or a sequence in field order (``ENV_COLUMNS``)."""
    if isinstance(columns, Mapping):
        cols = [columns[name] for name in ENV_COLUMNS]
    else:
        cols = list(columns)
        if len(cols) != len(ENV_COLUMNS):
            raise ValueError(f"expected {len(ENV_COLUMNS)} columns, got {len(cols)}")
    return EnvArrays(*(np.array(c, dtype=np.float64) for c in cols))


def session_batch_from_state(
    n: int, threshold: float, min_interval: int, state
) -> SessionBatch:
    """A :class:`SessionBatch` from the scalars and the arrays of
    ``SessionBatch.checkpoint()``: a sequence in checkpoint order, or a
    mapping keyed by field name.  Arrays are copied, dtypes kept."""
    if isinstance(state, Mapping):
        arrays = [state[f] for f in _LEAF_FIELDS]
    else:
        arrays = list(state)
        if len(arrays) != len(_LEAF_FIELDS):
            raise ValueError(f"expected {len(_LEAF_FIELDS)} arrays, got {len(arrays)}")
    return SessionBatch(
        int(n), float(threshold), int(min_interval), *(np.array(a) for a in arrays)
    )


def placement_cache_from_snapshot(
    snapshot,
    *,
    fingerprint: str | None = None,
    rel_step: float | None = None,
    capacity: int = 4096,
) -> PlacementCache:
    """A warm :class:`PlacementCache` from the shared JSON snapshot (a
    ``dict`` or a file path).  ``rel_step`` defaults to the snapshot's."""
    if rel_step is None and isinstance(snapshot, Mapping):
        rel_step = snapshot.get("rel_step")
    quantizer = EnvQuantizer(rel_step) if rel_step is not None else None
    return PlacementCache.from_snapshot(
        snapshot, fingerprint=fingerprint, quantizer=quantizer, capacity=capacity
    )


def _tensor(a, device) -> torch.Tensor:
    """A numpy leaf as a tensor of the same dtype (a copy: arrays taken from
    JAX are read-only).  bfloat16 leaves arrive as ``ml_dtypes.bfloat16``
    arrays, which ``torch.from_numpy`` rejects: they go through float32
    (exact for bfloat16)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def tree_to_state_dict(tree: Mapping, device="cpu", prefix: str = "") -> dict:
    """A nested dict of arrays → ``{"a.b.c": tensor}``: the ``state_dict``
    of the port's module whose submodules and parameters bear the tree's
    names (``{"in_proj": {"w": …}}`` → ``"in_proj.w"``)."""
    out = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out.update(tree_to_state_dict(val, device, name + "."))
        else:
            out[name] = _tensor(val, device)
    return out


# JAX tree keys holding layers stacked along leading axes: the number of
# stacked axes, and each becomes one index of the port's module lists
_STACKED = {"blocks": 1, "dense0": 1, "enc_blocks": 1, "dec_blocks": 1, "slstm": 1,
            "mamba": 2, "mlstm": 2}
# per-layer norm scales kept as one parameter: {"scale": (groups[, every], d)}
_SCALE_STACKS = ("shared_ln", "shared_ln2", "ln_m", "ln_s")


def model_params_from_jax(params_np: Mapping, cfg, device="cpu") -> dict:
    """The ``state_dict`` of the port's model holding the JAX package's
    parameters ``params_np`` (its ``Model.init`` tree, leaves as numpy), for
    every family.

    Leaves stacked over layers become per-layer modules: ``blocks``,
    ``dense0``, ``enc_blocks``, ``dec_blocks`` and the sLSTM stack
    ``slstm`` (layer axis) → ``blocks.{i}.…``; the Mamba2 stack ``mamba``
    and the mLSTM stack ``mlstm`` ``(groups, every, …)`` → ``mamba.{g}.{i}.…``.
    The stacked norm scales ``shared_ln``, ``shared_ln2``, ``ln_m`` and
    ``ln_s`` (``{"scale": (groups[, every], d)}``) become one parameter each.
    A mixture-of-experts layer's expert weights stay stacked ``(E, …)``, as
    the port's ``MoE`` holds them."""
    from repro_torch.models.transformer import FAMILIES

    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown model family {cfg.family!r}")
    sd = {}
    for key, val in params_np.items():
        if key in _STACKED:
            stacked = tree_to_state_dict(val, "cpu")
            for name, t in stacked.items():
                if _STACKED[key] == 1:
                    for i in range(t.shape[0]):
                        sd[f"{key}.{i}.{name}"] = t[i].clone().to(device)
                else:
                    for g in range(t.shape[0]):
                        for i in range(t.shape[1]):
                            sd[f"{key}.{g}.{i}.{name}"] = t[g, i].clone().to(device)
        elif key in _SCALE_STACKS:
            sd[key] = _tensor(val["scale"], device)
        else:
            sd.update(tree_to_state_dict(val, device, key + "."))
    return sd


def jax_leaf_ndim(name: str, ndim: int) -> int:
    """The rank of the JAX package's leaf that the port's parameter ``name``
    (of rank ``ndim``) holds a slice of: a layer stacked along leading axes
    there (``_STACKED``: ``blocks.{i}.…`` one axis, ``mamba.{g}.{i}.…`` two)
    adds its stacked axes; every other parameter, the stacked norm scales
    of ``_SCALE_STACKS`` included (held whole), has the leaf's rank."""
    return ndim + _STACKED.get(name.split(".", 1)[0], 0)


def _named(params):
    return params.named_parameters() if isinstance(params, torch.nn.Module) else params.items()


def jax_leaf_groups(params) -> dict:
    """``{name: the JAX leaf's path}`` (its keys joined by dots) for a
    model's parameters (an ``nn.Module`` or a ``{name: tensor}`` dict): the
    per-layer tensors of a stacked leaf share one path
    (``mamba.0.1.in_proj.w`` -> ``mamba.in_proj.w``), a stacked norm scale
    held whole is its leaf (``shared_ln`` -> ``shared_ln.scale``), and every
    other parameter keeps its name.  Gradient compression takes a JAX leaf
    as its unit (``runtime.compression``)."""
    out = {}
    for k, _ in _named(params):
        head, *rest = k.split(".")
        if head in _SCALE_STACKS:
            out[k] = f"{head}.scale"
        else:
            out[k] = ".".join([head, *rest[_STACKED.get(head, 0):]])
    return out


def jax_leaf_shapes(params) -> dict:
    """``{name: (the JAX leaf's path, the JAX leaf's shape)}`` for a model's
    parameters (an ``nn.Module`` or a ``{name: tensor}`` dict): the path of
    :func:`jax_leaf_groups` with its keys joined by ``/`` (the sharding
    rules' form), and the shape of the leaf the parameter is a slice of:
    the layer counts of its stack (``blocks.{i}``: the number of blocks;
    ``mamba.{g}.{i}``: groups, then layers a group) followed by the
    parameter's own shape.  A parameter no layer stack holds has its own
    shape."""
    named = list(_named(params))
    counts: dict = {}
    for k, _ in named:
        head, *rest = k.split(".")
        n = _STACKED.get(head, 0)
        if n:
            idx = [int(i) + 1 for i in rest[:n]]
            counts[head] = [max(a, b) for a, b in zip(counts.get(head, idx), idx)]
    paths = jax_leaf_groups(dict(named))
    return {k: (paths[k].replace(".", "/"),
                tuple(counts.get(k.split(".", 1)[0], ())) + tuple(p.shape))
            for k, p in named}


def weight_decay_mask(params) -> dict:
    """``{name: decays}`` for a model's parameters (an ``nn.Module`` or a
    ``{name: tensor}`` dict): the JAX package's AdamW decays every leaf of
    two or more dimensions, and its leaves are stacked over layers, so a
    per-layer norm scale, bias, ``a_log``, ``d_skip`` or ``dt_bias`` of a
    stacked layer decays there though it is 1-D here.  The answer comes
    from the JAX leaf's rank (:func:`jax_leaf_ndim`)."""
    return {k: jax_leaf_ndim(k, p.ndim) >= 2 for k, p in _named(params)}
