"""Array-native pricing/telemetry: trace of placements → one fused report.

The paper frames partition quality as a cost/energy *trade-off report*
(§7, Figs. 17–19): for every environment the interesting numbers are the
cost of the chosen placement, the no-offloading baseline, the
full-offloading baseline, and the offloading gain between them.  The
adaptive loop's ``_emit`` used to produce those numbers with three
scalar graph evaluations per event — once construction and solving are
fused, that per-event host pricing is what dominates a sweep.

This module is the batched sibling: a whole trace of
``(environment, placement)`` pairs is priced in ONE vectorized
evaluation — one ``cost_model.build_batch`` (a single pass of array
arithmetic over the profile tensors) followed by one
:meth:`~repro_torch.core.graph.WCGBatch.price_batch` call.  Results are
collected in a :class:`PriceReport` of (k,) arrays, so downstream
telemetry/dashboards can consume it without touching Python objects.

Bit-identity contract: every number in the report equals the scalar
path (``g.total_cost`` + ``baselines.no_offloading`` /
``baselines.full_offloading`` + ``offloading_gain``) *bitwise*, because
host pricing batches are unpadded and both paths reduce in the same
order (see :meth:`repro_torch.core.graph.WCG.total_cost`).  The parity suite
asserts ``==``, not ``approx``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.core.graph import WCGBatch

__all__ = [
    "PriceReport",
    "price_batch",
    "price_trace",
    "vector_gain",
    "device_price_summary",
]


def vector_gain(no_offload: np.ndarray, partial: np.ndarray) -> np.ndarray:
    """Vectorized §7.1 offloading gain: ``1 − partial/no_offload``.

    Matches :func:`repro_torch.core.cost_models.offloading_gain` elementwise
    (a non-positive no-offloading cost yields 0.0, same guard).
    """
    no_offload = np.asarray(no_offload, dtype=np.float64)
    partial = np.asarray(partial, dtype=np.float64)
    out = np.zeros_like(no_offload)
    ok = no_offload > 0
    np.divide(partial, no_offload, out=out, where=ok)
    return np.where(ok, 1.0 - out, 0.0)


@dataclasses.dataclass
class PriceReport:
    """K priced placements as stacked (k,) arrays — the batched event.

    Attributes:
      partial_cost:      (k,) Eq.-2 cost of each placement at its own
                         environment's prices.
      no_offload_cost:   (k,) all-local baseline (paper §7.1).
      full_offload_cost: (k,) everything-offloadable-remote baseline.
      gain:              (k,) offloading gain ``1 − partial/no_offload``.
    """

    partial_cost: Any
    no_offload_cost: Any
    full_offload_cost: Any
    gain: Any

    def __len__(self) -> int:
        return int(np.asarray(self.partial_cost).shape[0])

    def row(self, i: int) -> tuple[float, float, float, float]:
        """Scalar view of one trace step: (partial, no_off, full, gain)."""
        return (
            float(self.partial_cost[i]),
            float(self.no_offload_cost[i]),
            float(self.full_offload_cost[i]),
            float(self.gain[i]),
        )


def price_batch(batch: WCGBatch, local_masks: np.ndarray) -> PriceReport:
    """Price K placements against an already-built :class:`WCGBatch`.

    Args:
      batch:       K stacked WCGs (one pricing evaluation regardless of K).
        For bit-identity with the scalar path the batch must be unpadded
        (``m == n``); padded batches are still numerically correct
        (padding contributes exactly 0.0) but may differ from the scalar
        path in the last ulp because numpy's pairwise summation groups
        by row length.
      local_masks: (k, m) bool placements (padding columns True).
    Returns:
      :class:`PriceReport` with (k,) rows in batch order.
    """
    partial, no_off, full = batch.price_batch(local_masks)
    return PriceReport(
        partial_cost=np.asarray(partial, dtype=np.float64),
        no_offload_cost=np.asarray(no_off, dtype=np.float64),
        full_offload_cost=np.asarray(full, dtype=np.float64),
        gain=vector_gain(no_off, partial),
    )


def price_trace(
    profile,
    model,
    trace: Sequence[tuple],
) -> PriceReport:
    """Price a trace of ``(environment, placement-mask)`` pairs in one pass.

    The array-native replacement for looping ``_emit``-style telemetry:
    the K WCGs are constructed by ONE vectorized
    ``model.build_batch`` call (rows bit-identical to the scalar
    ``model.build``) and all 3·K cost numbers come from ONE
    :meth:`~repro_torch.core.graph.WCGBatch.price_batch` evaluation.

    Args:
      profile: :class:`~repro_torch.core.cost_models.AppProfile` shared by the
        whole trace (one application, K environment points).
      model:   :class:`~repro_torch.core.cost_models.CostModel` pricing the
        objective (time / energy / weighted).
      trace:   sequence of ``(Environment, local_mask)`` pairs; each
        mask is (n,) bool over the profile's vertices.
    Returns:
      :class:`PriceReport` with row ``i`` bit-identical to pricing
      ``trace[i]`` through the scalar path.
    """
    trace = list(trace)
    if not trace:
        empty = np.zeros(0, dtype=np.float64)
        return PriceReport(empty, empty.copy(), empty.copy(), empty.copy())
    envs = [env for env, _ in trace]
    masks = np.stack([np.asarray(m, dtype=bool) for _, m in trace])
    if masks.shape != (len(trace), profile.n):
        raise ValueError(
            f"trace masks must be (k, {profile.n}), got {masks.shape}"
        )
    batch = model.build_batch(profile, envs)  # unpadded: m == profile.n
    return price_batch(batch, masks)


# ----------------------------------------------------------------------
# Device-resident reduction: build → price → reduce on the device, so
# telemetry over K sessions syncs a handful of scalars to the host
# instead of K-sized report arrays.
# ----------------------------------------------------------------------

_SUMMARY_FIELDS = (
    "partial_mean",
    "partial_min",
    "partial_max",
    "no_offload_mean",
    "full_offload_mean",
    "gain_mean",
    "gain_min",
    "gain_max",
)


def device_price_summary(
    profile, model, envs, masks, active=None, *, device: str | torch.device = "cuda"
) -> dict:
    """Device-side pricing telemetry: K sessions → 8 scalars.

    The whole chain — ``model.batch_weights`` WCG construction, Eq.-2
    pricing of the placements, both §7.1 baselines, the offloading gains
    *and the reductions over sessions* — runs as tensor code on
    ``device``; only the eight reduced scalars come back, in ONE host
    synchronisation.  This is the dashboard path for batched session
    ticks at 10⁵–10⁶ users, where syncing K-sized :class:`PriceReport`
    arrays per tick would dominate.

    Args:
      profile: shared :class:`~repro_torch.core.cost_models.AppProfile`.
      model:   :class:`~repro_torch.core.cost_models.CostModel` objective.
      envs:    :class:`~repro_torch.core.cost_models.EnvArrays` (k rows)
               or a sequence of Environments.
      masks:   (k, n) bool placements to price.
      active:  optional (k,) bool — sessions to include in the
               reductions (idle slots of a fixed-capacity batch are
               priced but excluded).
      device:  where the tensor code runs; the default needs a GPU.
    Returns:
      dict of Python floats (mean/min/max partial cost, mean baselines,
      mean/min/max gain) in float32 — this is telemetry, NOT the
      bit-exact host pricing path that placement/clamp decisions ride.
    """
    from repro_torch.core.cost_models import EnvArrays
    from repro_torch.kernels.mcop_phase import require_device

    device = require_device(device)
    if not isinstance(envs, EnvArrays):
        envs = EnvArrays.from_envs(envs)
    f32 = torch.float32

    def dev(a, dtype=f32):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    m = dev(np.asarray(masks, dtype=bool), torch.bool)
    weights = (
        torch.ones(m.shape[0], dtype=f32, device=device)
        if active is None
        else dev(np.asarray(active, dtype=bool))
    )
    wl, wc, adj = model.batch_weights(
        dev(profile.t_local), dev(profile.data_in), dev(profile.data_out),
        envs.to(device),
    )

    def price(mask):
        node = torch.where(mask, wl, wc).sum(dim=-1)
        cut = mask[:, :, None] != mask[:, None, :]
        return node + (adj * cut).sum(dim=(-1, -2)) / 2.0

    partial = price(m)
    no_off = wl.sum(dim=-1)
    full = price(dev(~np.asarray(profile.offloadable, dtype=bool), torch.bool)[None, :].expand_as(m))
    gain = torch.where(no_off > 0, 1.0 - partial / no_off, torch.zeros_like(no_off))
    # weighted (active-session) reductions; `weights` is 0/1 so idle
    # slots of a fixed-capacity session batch never skew the means
    w_sum = weights.sum().clamp_min(1.0)
    on = weights > 0
    inf = torch.full_like(partial, float("inf"))

    def mean(x):
        return (x * weights).sum() / w_sum

    out = torch.stack(
        [
            mean(partial),
            torch.where(on, partial, inf).min(),
            torch.where(on, partial, -inf).max(),
            mean(no_off),
            mean(full),
            mean(gain),
            torch.where(on, gain, inf).min(),
            torch.where(on, gain, -inf).max(),
        ]
    ).cpu()  # ONE host sync for the whole summary
    return {k: float(v) for k, v in zip(_SUMMARY_FIELDS, out)}
