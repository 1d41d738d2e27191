"""State carried across from the JAX package, as numpy arrays and dicts.

This package never imports the JAX package.  Whoever holds that package's
objects (the parity tests, a migration script) extracts their fields as
numpy arrays and plain dicts and hands them to the functions here, which
return this package's objects.  A
:class:`~repro_torch.core.placement_cache.PlacementCache` needs no
function of its own: the JSON snapshot either package writes
(``cache.snapshot()`` / ``cache.save(path)``) loads in the other
(:func:`placement_cache_from_snapshot` is a one-line convenience).
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np

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
