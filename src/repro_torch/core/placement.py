"""Placement mapper: MCOP partitions → executable distribution artifacts.

The vertices of the framework-level WCG are *stages* (embedding, layer
groups, head); the two sides are *tiers* (two pools of accelerators, or
accelerator vs host).  The mapper produces:

* a per-stage tier assignment (the raw MCOP answer),
* a *contiguous pipeline split* for chain-structured models — pipeline
  execution needs contiguous stage ranges, so the mapper computes the
  optimal contiguous refinement (exact scan over boundaries) and reports
  the contiguity penalty vs. the unconstrained MCOP cut,
* cut-edge statistics (activation bytes crossing tiers per step).

Tier and stage descriptions are analytic (FLOPs, bytes), so profiled
numbers swap in without changing the graph.  ``TPUV5E_TIER`` is the tier
description the JAX package's serving report prices; it is carried here
as data under the same name so that plans are ``==`` to that package's.

Everything here is host numpy float64.  :func:`plan_placement` solves with
the f64 reference MCOP by default; :func:`plan_placement_batch` solves a
sweep over link bandwidths in one ``mcop_batch`` dispatch (default: the
CUDA solve kernel on ``device``).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import baselines
from repro_torch.core.graph import WCG, WCGBatch
from repro_torch.core.mcop import DEFAULT_BUCKETS, MCOPResult, _bucket_size, mcop, mcop_batch

__all__ = [
    "TierSpec",
    "StageSpec",
    "TPUV5E_TIER",
    "build_stage_wcg",
    "PlacementPlan",
    "plan_placement",
    "plan_placement_batch",
]


@dataclasses.dataclass(frozen=True)
class TierSpec:
    """One side of the offloading decision: a set of chips (or the host).

    peak_flops:  per-chip peak (bf16 FLOP/s)
    hbm_bw:      per-chip HBM bytes/s
    chips:       chips in the tier
    link_bw:     bytes/s available *to the other tier* (DCN / ICI / PCIe)
    p_compute/p_idle/p_transfer: per-chip watts for the energy model
    """

    name: str
    chips: int
    peak_flops: float
    hbm_bw: float
    link_bw: float
    p_compute: float = 250.0
    p_idle: float = 60.0
    p_transfer: float = 40.0

    @property
    def total_flops(self) -> float:
        return self.chips * self.peak_flops

    @property
    def total_hbm_bw(self) -> float:
        return self.chips * self.hbm_bw


TPUV5E_TIER = TierSpec(
    name="v5e-pod",
    chips=256,
    peak_flops=197e12,
    hbm_bw=819e9,
    link_bw=50e9,
)


@dataclasses.dataclass(frozen=True)
class StageSpec:
    """One vertex of the framework-level WCG.

    flops:          FLOPs per step for this stage (fwd+bwd for training).
    bytes_hbm:      HBM traffic per step (weights + activations).
    act_bytes_out:  activation bytes flowing to each successor per step —
                    the WCG edge weight numerator (Eq. 1's in/out data).
    pinned_tier:    None = offloadable; 0/1 = must run on that tier
                    (paper's unoffloadable tasks: ingest, sampler, IO).
    """

    name: str
    flops: float
    bytes_hbm: float
    act_bytes_out: float
    params_bytes: float = 0.0
    pinned_tier: int | None = None
    successors: tuple[int, ...] = ()  # stage indices; default: next in chain


def _stage_time(stage: StageSpec, tier: TierSpec) -> float:
    """Roofline step-time estimate of a stage on a tier: max(compute, memory)."""
    return max(stage.flops / tier.total_flops, stage.bytes_hbm / tier.total_hbm_bw)


def build_stage_wcg(
    stages: Sequence[StageSpec],
    tier_local: TierSpec,
    tier_remote: TierSpec,
    *,
    inter_tier_bw: float | None = None,
) -> WCG:
    """Stage chain/graph → WCG under the response-time cost model.

    ``w_local``/``w_cloud`` are roofline step times on the two tiers;
    edges charge activation transfer over the inter-tier link (Eq. 1 with
    B_up = B_down = link bandwidth).  Stages pinned to the remote tier are
    encoded with an infinite local cost (and vice versa via
    ``offloadable=False``).
    """
    n = len(stages)
    bw = inter_tier_bw or min(tier_local.link_bw, tier_remote.link_bw)
    w_local = np.zeros(n)
    w_cloud = np.zeros(n)
    offloadable = np.ones(n, dtype=bool)
    adj = np.zeros((n, n))
    big = 0.0
    for i, st in enumerate(stages):
        w_local[i] = _stage_time(st, tier_local)
        w_cloud[i] = _stage_time(st, tier_remote)
        big += w_local[i] + w_cloud[i]
    for i, st in enumerate(stages):
        succ = st.successors if st.successors else ((i + 1,) if i + 1 < n else ())
        for j in succ:
            w = st.act_bytes_out / bw
            adj[i, j] += w
            adj[j, i] += w
        if st.pinned_tier == 0:
            offloadable[i] = False
        elif st.pinned_tier == 1:
            # pin to remote: make local execution prohibitively expensive
            w_local[i] = big * 1e3 + w_local[i]
    names = [s.name for s in stages]
    return WCG(w_local, w_cloud, adj, offloadable, names=names)


@dataclasses.dataclass
class PlacementPlan:
    """Executable outcome of one MCOP run over a stage graph."""

    stage_tier: np.ndarray        # (n,) int — 0 local tier, 1 remote tier
    mcop_cost: float              # unconstrained MCOP cut value
    contiguous_boundary: int      # stages [0, b) on tier0, [b, n) on tier1
    contiguous_cost: float        # cost of the contiguous refinement
    contiguity_penalty: float     # contiguous_cost − mcop_cost (≥ −eps)
    cut_bytes: float              # activation bytes crossing tiers per step
    result: MCOPResult

    @property
    def is_split(self) -> bool:
        return 0 < self.contiguous_boundary < self.stage_tier.shape[0]

    def tier_stages(self, tier: int) -> np.ndarray:
        return np.nonzero(self.stage_tier == tier)[0]


def _contiguous_refinement(g: WCG) -> tuple[int, float]:
    """Best chain split: stages [0, b) local, [b, n) remote.  Exact O(n²).

    b == n means everything local (no offloading); b == 0 would violate
    pinned-local stages, so b ranges over [1, n].
    """
    n = g.n
    best_b, best_cost = n, np.inf
    for b in range(1, n + 1):
        mask = np.zeros(n, dtype=bool)
        mask[:b] = True
        if np.any(~mask & ~g.offloadable):
            continue  # would offload a pinned stage
        cost = g.total_cost(mask)
        if cost < best_cost:
            best_b, best_cost = b, cost
    return best_b, float(best_cost)


def _finalize_plan(g: WCG, result: MCOPResult, bw: float) -> PlacementPlan:
    """Partition result → executable plan (tiering, contiguity, cut bytes)."""
    tier = (~result.local_mask).astype(np.int32)
    boundary, contig_cost = _contiguous_refinement(g)
    cut = result.local_mask[:, None] != result.local_mask[None, :]
    # row-major reduction, matching the vectorized batch finalization
    cut_bytes = float((g.adj * cut).sum(axis=-1).sum() / 2.0 * bw)
    return PlacementPlan(
        stage_tier=tier,
        mcop_cost=float(result.min_cut),
        contiguous_boundary=boundary,
        contiguous_cost=contig_cost,
        contiguity_penalty=float(contig_cost - result.min_cut),
        cut_bytes=cut_bytes,
        result=result,
    )


def plan_placement(
    stages: Sequence[StageSpec],
    tier_local: TierSpec,
    tier_remote: TierSpec,
    *,
    backend: str = "reference",
    exact: bool = False,
    inter_tier_bw: float | None = None,
    device: str | torch.device = "cuda",
) -> PlacementPlan:
    """Run the partitioning pass and derive the pipeline plan.

    ``exact=True`` swaps MCOP for the max-flow oracle (beyond-paper exact
    mode); the default follows the paper.  ``device`` is where a device
    backend (``"torch"``, ``"cuda"``) runs; the default ``"reference"``
    solves on the host.
    """
    g = build_stage_wcg(stages, tier_local, tier_remote, inter_tier_bw=inter_tier_bw)
    if exact:
        pr = baselines.maxflow_optimal(g)
        result = MCOPResult(min_cut=pr.cost, local_mask=pr.local_mask, phases=[])
    else:
        result = baselines.clamp_no_offloading(g, mcop(g, backend=backend, device=device))
    bw = inter_tier_bw or min(tier_local.link_bw, tier_remote.link_bw)
    return _finalize_plan(g, result, bw)


def _contiguous_costs_batch(batch: WCGBatch) -> np.ndarray:
    """Vectorized :func:`_contiguous_refinement` scan over an unpadded batch.

    Returns (k, n) Eq.-2 costs where column ``j`` is the chain split
    ``b = j + 1`` (stages [0, b) local); splits that would offload a
    pinned stage are ``inf``.  Row reductions match the scalar
    ``g.total_cost`` order bit-for-bit, so ``argmin`` resolves exact ties
    to the same boundary the serial first-minimum scan picks.
    """
    wl = np.asarray(batch.w_local)
    wc = np.asarray(batch.w_cloud)
    adj = np.asarray(batch.adj)
    pin = np.asarray(batch.pinned, dtype=bool)
    k, m = wl.shape
    bmasks = np.tril(np.ones((m, m), dtype=bool))  # row j: [0, j] local
    node = np.where(bmasks[None], wl[:, None, :], wc[:, None, :]).sum(axis=-1)
    cut = bmasks[:, :, None] != bmasks[:, None, :]
    comm = np.empty((k, m))
    # chunk the boundary axis: the (k, nb, m, m) temp stays bounded while
    # per-(row, boundary) reduction order — hence bit-parity — is untouched
    step = max(1, int(4_000_000 // max(k * m * m, 1)))
    for s in range(0, m, step):
        comm[:, s : s + step] = (
            adj[:, None, :, :] * cut[None, s : s + step]
        ).sum(axis=-1).sum(axis=-1) / 2.0
    viol = (~bmasks[None, :, :] & pin[:, None, :]).any(axis=-1)
    return np.where(viol, np.inf, node + comm)


def plan_placement_batch(
    stages: Sequence[StageSpec],
    tier_local: TierSpec,
    tier_remote: TierSpec,
    *,
    inter_tier_bws: Sequence[float],
    backend: str = "cuda",
    device: str | torch.device = "cuda",
) -> list[PlacementPlan]:
    """Tier sweep: one plan per inter-tier bandwidth, solved in ONE batch.

    The elastic/adaptive loops re-plan as link conditions change; sweeping
    candidate bandwidths (or forecast bands) costs one device dispatch for
    the whole sweep instead of one trace per point.  Array-native: the
    stage graph is rooflined ONCE (node weights don't depend on the link),
    the K adjacencies are a single broadcast edge rescale (Eq. 1: edges
    are ``bytes/B``), the stacked :class:`~repro_torch.core.graph.WCGBatch`
    goes straight into :func:`mcop_batch`, and the *pricing* side of the
    plans — §4.3 clamp baselines, cut-byte statistics and the contiguous
    refinement scan — is one vectorized evaluation over the sweep instead
    of O(k·n) scalar ``total_cost`` calls.  Results match calling
    :func:`plan_placement` per bandwidth (boundaries and tiers exactly).

    Args:
      stages:         the framework-level WCG vertices (chain order).
      tier_local/tier_remote: the two placement sides.
      inter_tier_bws: K link bandwidths (bytes/s); 0/None falls back to
        ``min(link_bw)`` exactly like :func:`plan_placement`.
      backend:        MCOP batch backend for the solve (``"cuda"``,
        ``"torch"`` or ``"reference"``).
      device:         where a device backend runs (default the GPU).
    Returns:
      list of K :class:`PlacementPlan`, in ``inter_tier_bws`` order.
    """
    # same None/0 fallback plan_placement applies, so results really match
    bws = [
        bw or min(tier_local.link_bw, tier_remote.link_bw) for bw in inter_tier_bws
    ]
    base = build_stage_wcg(stages, tier_local, tier_remote, inter_tier_bw=1.0)
    k, n = len(bws), base.n
    scale = np.asarray(bws, dtype=np.float64)
    batch = WCGBatch.pack(
        np.broadcast_to(base.w_local, (k, n)),
        np.broadcast_to(base.w_cloud, (k, n)),
        base.adj[None] / scale[:, None, None],
        np.broadcast_to(base.offloadable, (k, n)),
        m=_bucket_size(n, DEFAULT_BUCKETS),
        names=base.names,
    )
    results = mcop_batch(batch, backend=backend, device=device)

    # ---- vectorized finalization (the sweep's pricing side) -----------
    # Unpadded pricing view: host reductions on (k, n[, n]) tensors are
    # bit-identical to the scalar per-plan path (see WCG.total_cost).
    price = WCGBatch(
        np.ascontiguousarray(batch.w_local[:, :n]),
        np.ascontiguousarray(batch.w_cloud[:, :n]),
        np.ascontiguousarray(batch.adj[:, :n, :n]),
        np.ascontiguousarray(batch.pinned[:, :n]),
        n_valid=(n,) * k,
        names=base.names,
    )
    no_off = np.asarray(price.w_local).sum(axis=-1)  # §7.1 all-local baseline
    clamped = [
        baselines.clamp_no_offloading_priced(r, float(no_off[i]))  # §4.3
        for i, r in enumerate(results)
    ]
    final_masks = np.stack([r.local_mask for r in clamped])
    mcop_costs = np.array([r.min_cut for r in clamped])
    cut = final_masks[:, :, None] != final_masks[:, None, :]
    cut_bytes = (
        (np.asarray(price.adj) * cut).sum(axis=-1).sum(axis=-1) / 2.0 * scale
    )
    ccosts = _contiguous_costs_batch(price)
    b_idx = np.argmin(ccosts, axis=-1)  # first minimum, like the serial scan

    return [
        PlacementPlan(
            stage_tier=(~final_masks[i]).astype(np.int32),
            mcop_cost=float(mcop_costs[i]),
            contiguous_boundary=int(b_idx[i]) + 1,
            contiguous_cost=float(ccosts[i, b_idx[i]]),
            contiguity_penalty=float(ccosts[i, b_idx[i]] - mcop_costs[i]),
            cut_bytes=float(cut_bytes[i]),
            result=result,
        )
        for i, result in enumerate(clamped)
    ]
