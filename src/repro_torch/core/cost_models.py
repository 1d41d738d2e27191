"""Partitioning cost models (paper §4.3).

An :class:`AppProfile` is the raw, environment-independent description of
an application that the profilers produce: per-task local execution times
and per-invocation transfer sizes.  A cost model turns a profile plus the
current *environment* (bandwidth B, speedup F, device powers) into a
:class:`~repro_torch.core.graph.WCG` whose total cost under a placement equals
the paper's objective:

* :class:`ResponseTimeModel`   — Eq. 4  (T_total)
* :class:`EnergyModel`         — Eq. 6  (E_total)
* :class:`WeightedModel`       — Eq. 8  (ω-blend, normalised by the
  all-local costs so time and energy are dimensionless and comparable)

Offloading gains (Eqs. 5/7/9) are provided as
:func:`offloading_gain`: ``1 − partial/no-offloading``.

Hardware constants default to the paper's HP iPAQ measurements
(P_m≈0.9 W, P_i≈0.3 W, P_tr≈1.3 W, §7.1) so the reproduction figures are
directly comparable to Figs. 17–19.

The models are *batch-first*: each implements
:meth:`CostModel.batch_weights` — pure array arithmetic mapping a profile
plus K stacked environments (:class:`EnvArrays`) to K graphs' weight
tensors.  The math is written polymorphically, so the same code path
serves two callers:

* host construction (numpy float64): :meth:`CostModel.build_batch`
  returns a :class:`~repro_torch.core.graph.WCGBatch`, and the scalar
  :meth:`CostModel.build` is literally a batch of one — bit-identical to
  the historical per-environment constructors;
* device construction (torch tensors, float32):
  ``repro_torch.core.mcop.solve_envs`` runs ``batch_weights`` on the
  device right before the Stoer–Wagner solver, so an environment sweep
  does no per-environment host work at all.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core.graph import WCG, WCGBatch, NonFiniteWeightError

__all__ = [
    "Environment",
    "EnvArrays",
    "validate_env_finite",
    "AppProfile",
    "CostModel",
    "ResponseTimeModel",
    "EnergyModel",
    "WeightedModel",
    "offloading_gain",
    "PAPER_POWERS",
]

# Paper §7.1 fixed values (HP iPAQ PDA, 400 MHz XScale).
PAPER_POWERS = dict(p_compute=0.9, p_idle=0.3, p_transfer=1.3)


@dataclasses.dataclass(frozen=True)
class Environment:
    """Mutable mobile environment (paper Fig. 1): what the profilers track.

    bandwidth_up/down are in data-units per time-unit (the paper assumes
    B_up == B_down for convenience; we keep both).  ``speedup`` is F.
    """

    bandwidth_up: float
    bandwidth_down: float
    speedup: float
    p_compute: float = PAPER_POWERS["p_compute"]
    p_idle: float = PAPER_POWERS["p_idle"]
    p_transfer: float = PAPER_POWERS["p_transfer"]

    @classmethod
    def symmetric(cls, bandwidth: float, speedup: float, **kw) -> "Environment":
        return cls(bandwidth, bandwidth, speedup, **kw)

    def replace(self, **kw) -> "Environment":
        return dataclasses.replace(self, **kw)


class EnvArrays(NamedTuple):
    """K environments as six (k,) arrays — the batched Environment.

    Columns are numpy on the host; the device paths hold the same six
    columns as torch tensors (see :meth:`to`).
    """

    bandwidth_up: np.ndarray
    bandwidth_down: np.ndarray
    speedup: np.ndarray
    p_compute: np.ndarray
    p_idle: np.ndarray
    p_transfer: np.ndarray

    @classmethod
    def from_envs(cls, envs: Sequence[Environment], dtype=np.float64) -> "EnvArrays":
        return cls(
            np.array([e.bandwidth_up for e in envs], dtype),
            np.array([e.bandwidth_down for e in envs], dtype),
            np.array([e.speedup for e in envs], dtype),
            np.array([e.p_compute for e in envs], dtype),
            np.array([e.p_idle for e in envs], dtype),
            np.array([e.p_transfer for e in envs], dtype),
        )

    @property
    def k(self) -> int:
        return int(self.speedup.shape[0])

    def astype(self, dtype) -> "EnvArrays":
        return EnvArrays(*(np.asarray(f, dtype) for f in self))

    def to(self, device, dtype=torch.float32) -> "EnvArrays":
        """The six columns as torch tensors on ``device``."""
        return EnvArrays(
            *(torch.as_tensor(np.asarray(f), dtype=dtype).to(device) for f in self)
        )

    def env(self, i: int) -> Environment:
        """Materialize row ``i`` as a scalar :class:`Environment`.

        ``float()`` of a float64 array element is exact, so round-tripping
        ``from_envs`` → ``env`` preserves every value bitwise — the batched
        session engine relies on this when it emits per-session events.
        """
        return Environment(
            float(self.bandwidth_up[i]),
            float(self.bandwidth_down[i]),
            float(self.speedup[i]),
            float(self.p_compute[i]),
            float(self.p_idle[i]),
            float(self.p_transfer[i]),
        )

    def take(self, indices) -> "EnvArrays":
        """Row subset (fancy indexing) — e.g. the cache-miss sessions a
        batched tick flushes through ``solve_envs``."""
        idx = np.asarray(indices)
        return EnvArrays(*(np.asarray(f)[idx] for f in self))


def validate_env_finite(envs: EnvArrays) -> None:
    """Reject NaN/Inf environment inputs, naming the offending row.

    Host-only (a no-op when any column is a device tensor):
    corrupted measurements used to flow silently into the weight math
    and poison every graph of the batch; now the first host boundary
    (``CostModel.build_batch``, ``solve_envs``) raises
    :class:`~repro_torch.core.graph.NonFiniteWeightError` instead.  The cheap
    aggregate probe runs every call; the per-row scan only on failure.
    """
    if not all(isinstance(col, np.ndarray) for col in envs):
        return
    probe = sum(float(col.sum()) for col in envs)
    if np.isfinite(probe):
        return
    finite = np.ones(envs.k, dtype=bool)
    for col in envs:
        finite &= np.isfinite(col)
    rows = np.nonzero(~finite)[0]
    first = int(rows[0])
    fields = [
        name
        for name, col in zip(envs._fields, envs)
        if not np.isfinite(col[first])
    ]
    more = "" if rows.size <= 1 else f" (+{rows.size - 1} more row(s))"
    raise NonFiniteWeightError(
        f"non-finite environment input: row {first} "
        f"({', '.join(f'{f}={float(getattr(envs, f)[first])!r}' for f in fields)})"
        f"{more}; rejecting before it corrupts the weight math",
        rows=rows,
    )


@dataclasses.dataclass
class AppProfile:
    """Environment-independent application profile (program profiler output).

    Attributes:
      t_local:   (n,) local execution time of each task.
      data_in:   (n, n) — data_in[i, j] = bytes sent i→j on invocation
                 (paper's in_ij); asymmetric in general.
      data_out:  (n, n) — data_out[i, j] = bytes returned j→i (out_ji).
      offloadable: (n,) bool.
      names:     labels.
    """

    t_local: np.ndarray
    data_in: np.ndarray
    data_out: np.ndarray
    offloadable: np.ndarray
    names: list[str] = dataclasses.field(default_factory=list)

    def __post_init__(self) -> None:
        self.t_local = np.asarray(self.t_local, dtype=np.float64)
        self.data_in = np.asarray(self.data_in, dtype=np.float64)
        self.data_out = np.asarray(self.data_out, dtype=np.float64)
        self.offloadable = np.asarray(self.offloadable, dtype=bool)
        if not self.names:
            self.names = [f"v{i}" for i in range(self.n)]

    @property
    def n(self) -> int:
        return int(self.t_local.shape[0])

    @classmethod
    def from_wcg_times(cls, g: WCG, *, bandwidth: float = 1.0) -> "AppProfile":
        """Invert Eq. 1 assuming symmetric bandwidth: recover transfer sizes."""
        data = g.adj * bandwidth / 2.0
        return cls(
            t_local=g.w_local.copy(),
            data_in=data,
            data_out=data.T.copy(),
            offloadable=g.offloadable.copy(),
            names=list(g.names),
        )


def _ns(x):
    """numpy or torch namespace matching ``x``.

    The batched weight math below is written once and dispatched here:
    host callers pass numpy float64 (bit-identical to the historical
    scalar constructors), the device path passes torch tensors.  Only names
    the two libraries share are used (``swapaxes``, ``broadcast_to``,
    ``maximum`` with an array bound).
    """
    return torch if isinstance(x, torch.Tensor) else np


def _edge_time_batch(data_in, data_out, env: EnvArrays):
    """Eq. 1, batched: w(e(v_i, v_j)) = in_ij/B_up + out_ij/B_down, symmetrised.

    The communication charge is paid once per cut edge regardless of
    direction, so the WCG edge weight is the *total* transfer time across
    the (i, j) boundary.  ``data_in``/``data_out`` are (n, n); the result
    is (k, n, n).
    """
    xp = _ns(env.bandwidth_up)
    per_dir = (
        data_in[None] / env.bandwidth_up[:, None, None]
        + data_out[None] / env.bandwidth_down[:, None, None]
    )
    return per_dir + xp.swapaxes(per_dir, -1, -2)


class CostModel:
    """Base: maps (profile, environments) → WCG / WCGBatch weights.

    Subclasses implement :meth:`batch_weights` only; the scalar
    :meth:`build` and the host :meth:`build_batch` both ride on it.
    """

    name = "abstract"

    @property
    def fingerprint(self) -> str:
        """Identity of the *objective* for cache-persistence guards: a
        placement cached under one cost model must not warm-start a
        tenant optimizing another.  Parametric models must fold their
        parameters in (see :class:`WeightedModel`).  Two instances with
        equal fingerprints must price identically."""
        return self.name

    def batch_weights(self, t_local, data_in, data_out, env: EnvArrays):
        """Pure array math: profile tensors + K environments → weights.

        Inputs may be numpy arrays or torch tensors; returns
        ``(w_local (k, n), w_cloud (k, n), adj (k, n, n))``.  Zero-padded
        profile columns stay zero, so callers may pass padded tensors.
        """
        raise NotImplementedError

    def build_batch(
        self,
        profile: AppProfile,
        envs: "Sequence[Environment] | EnvArrays",
        *,
        m: int | None = None,
        dtype=np.float64,
    ) -> WCGBatch:
        """K environments → one :class:`WCGBatch` (vectorized host build).

        Row ``i`` is bit-identical to ``self.build(profile, envs[i])``;
        ``m`` optionally zero-pads to a solver bucket size.  ``envs`` may
        be an :class:`EnvArrays` already — the batched session engine
        never materializes per-environment Python objects.
        """
        env_arrays = (
            envs.astype(dtype)
            if isinstance(envs, EnvArrays)
            else EnvArrays.from_envs(envs, dtype)
        )
        validate_env_finite(env_arrays)
        wl, wc, adj = self.batch_weights(
            np.asarray(profile.t_local, dtype),
            np.asarray(profile.data_in, dtype),
            np.asarray(profile.data_out, dtype),
            env_arrays,
        )
        return WCGBatch.pack(
            wl, wc, adj, np.broadcast_to(profile.offloadable, wl.shape),
            m=m, names=profile.names, dtype=dtype,
        )

    def build(self, profile: AppProfile, env: Environment) -> WCG:
        """Scalar front door — a batch of one over the same code path."""
        return self.build_batch(profile, [env]).wcg(0)

    def local_total(self, profile: AppProfile, env: Environment) -> float:
        """Cost of the no-offloading scheme (denominator of the gains)."""
        return float(self.build(profile, env).total_cost(np.ones(profile.n, bool)))


class ResponseTimeModel(CostModel):
    """Eq. 4: node = execution time on the given side; edge = transfer time."""

    name = "time"

    def batch_weights(self, t_local, data_in, data_out, env: EnvArrays):
        xp = _ns(env.speedup)
        t_c = t_local[None, :] / env.speedup[:, None]  # T_v^l = F · T_v^c  (F > 1)
        t_l = xp.broadcast_to(t_local[None, :], t_c.shape)
        return t_l, t_c, _edge_time_batch(data_in, data_out, env)


class EnergyModel(CostModel):
    """Eq. 6: mobile-side energy.

    Local run: P_m · T_l.  Remote run: the device idles while the cloud
    computes — P_i · T_c.  Cut edge: P_tr · transfer time.
    """

    name = "energy"

    def batch_weights(self, t_local, data_in, data_out, env: EnvArrays):
        t_c = t_local[None, :] / env.speedup[:, None]
        return (
            env.p_compute[:, None] * t_local[None, :],
            env.p_idle[:, None] * t_c,
            env.p_transfer[:, None, None] * _edge_time_batch(data_in, data_out, env),
        )


class WeightedModel(CostModel):
    """Eq. 8: ω·T/T_local + (1−ω)·E/E_local.

    Linearity makes the blend itself a WCG: every node/edge weight is the
    ω-combination of the normalised time and energy weights, so MCOP (or
    any partitioner) applies unchanged — this is why the paper can reuse
    one algorithm across all three objectives.
    """

    name = "weighted"

    def __init__(self, omega: float = 0.5):
        if not 0.0 <= omega <= 1.0:
            raise ValueError("omega must be in [0, 1]")
        self.omega = omega
        self._time = ResponseTimeModel()
        self._energy = EnergyModel()

    @property
    def fingerprint(self) -> str:
        return f"{self.name}:{self.omega!r}"

    def batch_weights(self, t_local, data_in, data_out, env: EnvArrays):
        xp = _ns(env.speedup)
        wl_t, wc_t, adj_t = self._time.batch_weights(t_local, data_in, data_out, env)
        wl_e, wc_e, adj_e = self._energy.batch_weights(t_local, data_in, data_out, env)
        floor = 1e-30 if xp is np else wl_t.new_tensor(1e-30)
        t_norm = xp.maximum(wl_t.sum(axis=-1), floor)[:, None]  # T_local per graph
        e_norm = xp.maximum(wl_e.sum(axis=-1), floor)[:, None]  # E_local per graph
        w = self.omega
        return (
            w * wl_t / t_norm + (1 - w) * wl_e / e_norm,
            w * wc_t / t_norm + (1 - w) * wc_e / e_norm,
            w * adj_t / t_norm[..., None] + (1 - w) * adj_e / e_norm[..., None],
        )


def offloading_gain(no_offload_cost: float, partial_cost: float) -> float:
    """§7.1: Offloading Gain = 1 − partial/no-offloading (as a fraction)."""
    if no_offload_cost <= 0:
        return 0.0
    return 1.0 - partial_cost / no_offload_cost
