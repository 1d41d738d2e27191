"""MCOP — the paper's Min-Cost Offloading Partitioning algorithm (§5).

All implementations share one contract: the minimum over phases of the
paper's Eq. 10 cut value

    C_cut(A−t, t) = C_local − [w_local(t) − w_cloud(t)] + Σ_{v∈A∖t} w(e(t,v))

together with the induced placement (True = execute locally).

Backends, and the JAX package's name for each:

* ``"reference"`` — :func:`mcop_reference`, a line-by-line numpy
  transcription of Algorithms 1–3 (Merge / MinCut / MinCutPhase) in f64
  that keeps a full per-phase trace, so tests can check the paper's §5.5
  case study *exactly*.  The semantic oracle everything else is tested
  against.  (``"reference"`` there too.)

* ``"torch"`` — the plain batched solver
  ``kernels.mcop_phase.stoer_wagner_plain``: ordinary tensor code, f32,
  on whatever device is asked for.  (``"jax"``.)

* ``"cuda"`` — ``kernels.mcop_phase.mcop_stoer_wagner_kernel``: the full
  solve of every graph of a bucket inside one hand-written CUDA kernel,
  one thread block per graph.  (``"pallas"``.)

* ``"cuda_fused"`` (:func:`solve_envs` only) —
  ``kernels.mcop_phase.mcop_fused_solve_kernel``: the kernel builds each
  environment's WCG weights itself, so six scalars per environment go in
  and the adjacency batch never exists in device memory.
  (``"pallas_fused"``.)

Device rule: every entry point takes ``device`` (default ``"cuda"``) and
runs its tensor work there; with no such device it raises
``kernels.build.KernelError``.  Nothing looks for a GPU to decide where to
run.  A kernel
wrapper given CPU tensors (``device="cpu"``, as the tests pass) runs the
kernel's plain version, so ``"cuda"``/``"cuda_fused"`` on the CPU compute
the same function through ordinary tensor code.  The device tiers are
f32; the reference solver, host pricing and every cache/drift decision
stay numpy f64.

:func:`mcop_batch` pads a heterogeneous list of graphs into static shape
*buckets* (default 16/64/256 vertices, 64-aligned beyond) and solves each
bucket in ONE dispatch with ONE host synchronisation; it also accepts a
:class:`~repro_torch.core.graph.WCGBatch` directly.  :func:`solve_envs`
is the fused environment→placement pipeline: the profile is padded once
to its bucket, six columns per environment go to the device, one
dispatch builds and solves the K graphs.

The JAX package keeps a cache of jitted build+solve executables
(``_FUSED_SOLVERS``); eager PyTorch compiles nothing per cost model, so
there is nothing to cache and the port has no counterpart.  ``mesh`` is
accepted as ``None``/``False`` only: this package solves on one device.

Padding semantics: padded vertices carry zero weights, zero edges, and
are marked *pinned*, so the anchor fold absorbs them with no effect on
any phase cut; graphs with no unoffloadable vertex are anchored at vertex
0, matching :func:`mcop_reference`.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.graph import WCG, WCGBatch

__all__ = [
    "PhaseRecord",
    "MCOPResult",
    "mcop_reference",
    "mcop_torch",
    "mcop_batch",
    "solve_envs",
    "mcop",
    "DEFAULT_BUCKETS",
    "BATCH_BACKENDS",
]

_NEG_INF = -1e30
_POS_INF = 1e30


@dataclasses.dataclass
class PhaseRecord:
    """Trace of one MinCutPhase run (paper Algorithm 3)."""

    order: list[str]          # induced ordering of current-graph nodes, by label
    s: str                    # second-to-last added
    t: str                    # last added
    cut_value: float          # Eq. 10 cut-of-the-phase
    cloud_members: frozenset  # original vertex indices inside t


@dataclasses.dataclass
class MCOPResult:
    min_cut: float
    local_mask: np.ndarray          # (n,) bool over original vertices
    phases: list[PhaseRecord]
    local_indices: tuple[int, ...] = ()
    cloud_indices: tuple[int, ...] = ()

    def __post_init__(self) -> None:
        mask = np.asarray(self.local_mask, dtype=bool)
        self.local_indices = tuple(int(i) for i in np.nonzero(mask)[0])
        self.cloud_indices = tuple(int(i) for i in np.nonzero(~mask)[0])


# ======================================================================
# Reference implementation — Algorithms 1, 2, 3 verbatim.
# ======================================================================


class _MutableGraph:
    """Dense mutable view used by the reference implementation.

    ``members[i]`` is the set of *original* vertex indices coalesced into
    current vertex ``i``; Algorithm 1's Merge adds edge weights and node
    weight tuples.
    """

    def __init__(self, g: WCG):
        self.adj = g.adj.copy()
        self.w_local = g.w_local.copy()
        self.w_cloud = g.w_cloud.copy()
        self.alive = np.ones(g.n, dtype=bool)
        self.members: list[set[int]] = [{i} for i in range(g.n)]
        self.names = list(g.names)

    @property
    def alive_indices(self) -> np.ndarray:
        return np.nonzero(self.alive)[0]

    def label(self, i: int) -> str:
        return "{" + "".join(sorted(self.names[j] for j in self.members[i])) + "}" \
            if len(self.members[i]) > 1 else self.names[next(iter(self.members[i]))]

    def merge(self, s: int, t: int) -> int:
        """Algorithm 1: fold t into s.  Returns the surviving index (s)."""
        if s == t or not (self.alive[s] and self.alive[t]):
            raise ValueError("merge requires two distinct alive vertices")
        # multiple edges resolved by adding edge weights (Alg. 1, line 4)
        self.adj[s, :] += self.adj[t, :]
        self.adj[:, s] += self.adj[:, t]
        self.adj[s, s] = 0.0
        self.adj[t, :] = 0.0
        self.adj[:, t] = 0.0
        # node weights resolved by adding tuples (Alg. 1, lines 5–7)
        self.w_local[s] += self.w_local[t]
        self.w_cloud[s] += self.w_cloud[t]
        self.w_local[t] = self.w_cloud[t] = 0.0
        self.members[s] |= self.members[t]
        self.members[t] = set()
        self.alive[t] = False
        return s


def _min_cut_phase(
    g: _MutableGraph, start: int, c_local_total: float
) -> tuple[float, int, int, list[str]]:
    """Algorithm 3: one phase.  Returns (cut value, s, t, induced order).

    Grows A from ``start``; at every step absorbs the most tightly
    connected vertex, where tightness is the paper's
    Δ(v) = w(e(A, v)) − [w_local(v) − w_cloud(v)].
    """
    alive = g.alive_indices
    in_a = np.zeros(g.adj.shape[0], dtype=bool)
    in_a[start] = True
    conn = g.adj[start].copy()  # w(e(A, v)) maintained incrementally
    order = [g.label(start)]
    added: list[int] = [start]
    gains = g.w_local - g.w_cloud

    for _ in range(len(alive) - 1):
        # strict '<' in Algorithm 3 line 11 → first maximum wins ties,
        # which reproduces the paper's induced orderings.
        best, best_v = _NEG_INF, -1
        for v in alive:
            if not in_a[v]:
                delta = conn[v] - gains[v]
                if best < delta:
                    best, best_v = delta, v
        in_a[best_v] = True
        conn += g.adj[best_v]
        order.append(g.label(best_v))
        added.append(best_v)

    t = added[-1]
    s = added[-2] if len(added) >= 2 else added[-1]
    # Eq. 10: Σ_{v∈A∖t} w(e(t, v)) is exactly conn over the full graph row.
    comm = float(g.adj[t, g.alive].sum())
    cut = c_local_total - float(gains[t]) + comm
    return cut, s, t, order


def mcop_reference(g: WCG, *, start: int | None = None) -> MCOPResult:
    """Algorithm 2 (MinCut): merge unoffloadables, run |V|−1 phases."""
    work = _MutableGraph(g)
    c_local_total = float(g.w_local.sum())  # invariant under merging

    # Step 1 (§5.1): merge all unoffloadable vertices into the source.
    pinned = np.nonzero(~g.offloadable)[0]
    if pinned.size == 0:
        source = 0 if start is None else start
    else:
        source = int(pinned[0])
        for other in pinned[1:]:
            work.merge(source, int(other))
    if start is not None:
        source = start  # test hook: explicit anchor

    best_cut = _POS_INF
    best_members: frozenset = frozenset()
    phases: list[PhaseRecord] = []

    # Step 2: coarse partitioning, |V|−1 phases (Algorithm 2 lines 6–13).
    while work.alive.sum() > 1:
        cut, s, t, order = _min_cut_phase(work, source, c_local_total)
        phases.append(
            PhaseRecord(
                order=order,
                s=work.label(s),
                t=work.label(t),
                cut_value=cut,
                cloud_members=frozenset(work.members[t]),
            )
        )
        if cut < best_cut:
            best_cut = cut
            best_members = frozenset(work.members[t])
        survivor = work.merge(s, t)
        if t == source:   # keep the anchor alive under merging
            source = survivor

    local_mask = np.ones(g.n, dtype=bool)
    for i in best_members:
        local_mask[i] = False
    return MCOPResult(min_cut=float(best_cut), local_mask=local_mask, phases=phases)


# ======================================================================
# Device tiers — plain tensor solver and the CUDA kernels.
# ======================================================================

DEFAULT_BUCKETS = (16, 64, 256)

# device backends of mcop_batch; solve_envs adds "cuda_fused"
BATCH_BACKENDS = ("torch", "cuda")

_SOLVER_DTYPE = np.float32


def _single_device(mesh) -> None:
    if mesh is not None and mesh is not False:
        raise NotImplementedError(
            "repro_torch solves on one device: pass mesh=None or mesh=False "
            "(the sharded solver fleet is not part of this package yet)"
        )


def _bucket_size(n: int, buckets: Sequence[int]) -> int:
    for b in sorted(buckets):
        if n <= b:
            return int(b)
    # beyond the largest bucket: 64-align so stragglers still share shapes
    return int(-(-n // 64) * 64)


def _pack_bucket(
    graphs: Sequence[WCG], m: int, dtype
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Zero-pad a bucket of WCGs to m vertices in preallocated batch
    buffers; padding is pinned so the anchor fold absorbs it without
    touching any cut value (see module docstring)."""
    b = len(graphs)
    adj = np.zeros((b, m, m), dtype)
    wl = np.zeros((b, m), dtype)
    wc = np.zeros((b, m), dtype)
    pinned = np.ones((b, m), dtype=bool)
    for i, g in enumerate(graphs):
        n = g.n
        adj[i, :n, :n] = g.adj
        wl[i, :n] = g.w_local
        wc[i, :n] = g.w_cloud
        pinned[i, :n] = ~g.offloadable
        if not pinned[i, :n].any():
            pinned[i, 0] = True  # anchor at vertex 0, matching mcop_reference
    return adj, wl, wc, pinned


def _dispatch_arrays(adj, wl, wc, pin, backend: str):
    """One device dispatch over pre-packed (b, m[, m]) tensors."""
    # deferred: keep core importable without pulling the kernel module
    from repro_torch.kernels.mcop_phase import (
        mcop_stoer_wagner_kernel,
        stoer_wagner_plain,
    )

    if backend == "torch":
        return stoer_wagner_plain(adj, wl, wc, pin)
    return mcop_stoer_wagner_kernel(adj, wl, wc, pin)


def _to_host(cuts, masks) -> tuple[np.ndarray, np.ndarray]:
    """Both results in ONE copy to the host — the call's only sync."""
    both = torch.cat([cuts[:, None], masks.to(cuts.dtype)], dim=1).cpu().numpy()
    return both[:, 0], both[:, 1:] > 0.5


def _solve_packed(packed, backend: str, device) -> tuple[np.ndarray, np.ndarray]:
    """Host arrays → device → one dispatch → one host sync back."""
    from repro_torch.kernels.mcop_phase import require_device

    device = require_device(device)
    adj, wl, wc, pin = (torch.from_numpy(a).to(device) for a in packed)
    return _to_host(*_dispatch_arrays(adj, wl, wc, pin, backend))


def _solve_wcg_batch(batch: WCGBatch, *, backend: str, device) -> list["MCOPResult"]:
    """Array-native entry: a WCGBatch is already one packed bucket."""
    if backend == "reference":
        return [mcop_reference(g) for g in batch.to_wcgs()]
    if backend not in BATCH_BACKENDS:
        raise ValueError(f"unknown MCOP batch backend: {backend!r}")
    cuts, masks = _solve_packed(
        (
            np.ascontiguousarray(batch.adj, _SOLVER_DTYPE),
            np.ascontiguousarray(batch.w_local, _SOLVER_DTYPE),
            np.ascontiguousarray(batch.w_cloud, _SOLVER_DTYPE),
            batch.anchored_pinned(),
        ),
        backend,
        device,
    )
    return [
        MCOPResult(
            min_cut=float(cuts[i]),
            local_mask=masks[i, : batch.n_valid[i]].copy(),
            phases=[],
        )
        for i in range(batch.k)
    ]


def mcop_batch(
    graphs: Sequence[WCG] | WCGBatch,
    *,
    backend: str = "cuda",
    buckets: Sequence[int] = DEFAULT_BUCKETS,
    device: str | torch.device = "cuda",
    mesh=None,
) -> list[MCOPResult]:
    """Solve many MCOP instances at once; results in input order.

    Args:
      graphs:   a sequence of :class:`~repro_torch.core.graph.WCG`
        (arbitrary, heterogeneous sizes), or a single
        :class:`~repro_torch.core.graph.WCGBatch` of K graphs padded to
        one static shape ``(k, m[, m])``.
      backend:  ``"cuda"`` (one kernel launch per bucket), ``"torch"``
        (the plain batched solver), or ``"reference"`` (loops the numpy
        oracle — testing/parity).
      buckets:  static shape buckets; each graph is zero-padded to the
        smallest bucket ≥ its vertex count and each bucket is ONE device
        dispatch.  Ignored for a ``WCGBatch`` (its padded shape *is* the
        bucket).
      device:   where the device backends run (ignored by
        ``"reference"``).  The default needs a GPU and raises without.
      mesh:     ``None``/``False`` only (single device).
    Returns:
      ``list[MCOPResult]`` in input order; ``result[i].local_mask`` is
      ``(n_i,)`` bool over graph ``i``'s ORIGINAL vertices (padding
      cropped), True = execute locally.  ``min_cut`` is the Eq.-10
      optimum in solver precision (f32 on the device backends).
    """
    _single_device(mesh)
    if isinstance(graphs, WCGBatch):
        return _solve_wcg_batch(graphs, backend=backend, device=device)
    graphs = list(graphs)
    if backend == "reference":
        return [mcop_reference(g) for g in graphs]
    if backend not in BATCH_BACKENDS:
        raise ValueError(f"unknown MCOP batch backend: {backend!r}")

    by_bucket: dict[int, list[int]] = {}
    for i, g in enumerate(graphs):
        by_bucket.setdefault(_bucket_size(g.n, buckets), []).append(i)

    results: list[MCOPResult | None] = [None] * len(graphs)
    for m, idxs in sorted(by_bucket.items()):
        packed = _pack_bucket([graphs[i] for i in idxs], m, _SOLVER_DTYPE)
        cuts, masks = _solve_packed(packed, backend, device)
        for row, i in enumerate(idxs):
            results[i] = MCOPResult(
                min_cut=float(cuts[row]),
                local_mask=masks[row, : graphs[i].n].copy(),
                phases=[],
            )
    return results  # type: ignore[return-value]


def mcop_torch(g: WCG, *, device: str | torch.device = "cuda") -> MCOPResult:
    """One graph through the plain tensor solver, unpadded.  Semantics
    match :func:`mcop_reference` (f32 arithmetic)."""
    return mcop_batch([g], backend="torch", buckets=(g.n,), device=device)[0]


# ======================================================================
# Fused environment→placement pipeline: build + solve, one dispatch.
# ======================================================================


def _fused_dispatch(model, backend: str, t_local, data_in, data_out, pinned, env):
    """Build the K graphs' weights and solve them, all on ``env``'s device."""
    from repro_torch.kernels.mcop_phase import (
        FUSED_MODEL_KINDS,
        mcop_fused_solve_kernel,
        mcop_stoer_wagner_kernel,
        stoer_wagner_plain,
    )

    if backend == "cuda_fused":
        kind = getattr(model, "name", None)
        if kind not in FUSED_MODEL_KINDS:
            raise ValueError(
                f"backend='cuda_fused' implements the in-kernel weight "
                f"build only for cost-model kinds {FUSED_MODEL_KINDS}; "
                f"got model {model!r} (name={kind!r}) — use "
                f"backend='cuda' for custom models"
            )
        env_mat = torch.stack(list(env), dim=-1).contiguous()  # EnvArrays → (k, 6)
        return mcop_fused_solve_kernel(
            t_local, data_in, data_out, pinned, env_mat,
            kind=kind, omega=float(getattr(model, "omega", 0.5)),
        )
    wl, wc, adj = model.batch_weights(t_local, data_in, data_out, env)
    pin = pinned[None, :].expand(wl.shape).contiguous()
    wl, wc, adj = wl.contiguous(), wc.contiguous(), adj.contiguous()
    if backend == "torch":
        return stoer_wagner_plain(adj, wl, wc, pin)
    return mcop_stoer_wagner_kernel(adj, wl, wc, pin)


def solve_envs(
    profile,
    model,
    envs: Sequence,
    *,
    backend: str = "cuda",
    buckets: Sequence[int] = DEFAULT_BUCKETS,
    device: str | torch.device = "cuda",
    metrics=None,
    mesh=None,
) -> list[MCOPResult]:
    """Fused Fig.-1 pipeline: K environments → K placements, one dispatch.

    Args:
      profile: :class:`~repro_torch.core.cost_models.AppProfile` — the
        environment-independent application description; its ``(n,)`` /
        ``(n, n)`` tensors are zero-padded once to the shape bucket.
      model:   :class:`~repro_torch.core.cost_models.CostModel`; its
        ``batch_weights`` runs on the device (``"torch"``/``"cuda"``) or
        is replaced by the kernel's own build (``"cuda_fused"``).
      envs:    K :class:`~repro_torch.core.cost_models.Environment`
        points, or an :class:`~repro_torch.core.cost_models.EnvArrays`
        holding them as six (k,) columns (the batched session engine's
        form); six scalars per environment are all that goes to the
        device.
      backend: ``"torch"`` / ``"cuda"`` (weights built by tensor code,
        then the plain solver / the solve kernel), ``"cuda_fused"`` (the
        kernel that builds each environment's weights itself; built-in
        cost-model kinds only), or ``"reference"`` to route the
        vectorized host build through the numpy oracle (exact-parity
        testing).
      buckets: static shape buckets for the padded vertex count.
      device:  where the device backends run; the default needs a GPU.
      metrics: optional :class:`~repro_torch.obs.metrics.MetricsRegistry`
        — when given, each call counts one ``solve_envs_dispatches`` and
        times the dispatch into ``solve_envs_duration_s``, both labeled
        ``(backend, bucket, devices)`` with ``devices=1``.  ``None``
        (default) adds no work and no clock reads.
      mesh:    ``None``/``False`` only (single device).
    Returns:
      ``list[MCOPResult]``, one per environment in input order, masks
      ``(n,)`` bool over the profile's vertices.

    Placements match the object path
    ``mcop_batch([model.build(profile, e) for e in envs])`` (asserted by
    the parity suite; construction happens in f32 here, so an *exact* tie
    between two cuts could in principle resolve differently than the
    build-f64-then-cast object path — equal-cost placements either way).
    One host synchronisation per call: the copy of the results.
    """
    from repro_torch.core.cost_models import (  # deferred: no import cycle
        EnvArrays,
        validate_env_finite,
    )

    _single_device(mesh)
    if not isinstance(envs, EnvArrays):
        envs = EnvArrays.from_envs(list(envs))
    k = envs.k
    if k == 0:
        return []
    # corrupted environments must be named here, not silently solved
    # (NaN weights partition into garbage) — see NonFiniteWeightError
    validate_env_finite(envs)
    if metrics is not None:
        bucket = _bucket_size(profile.n, buckets)
        metrics.counter(
            "solve_envs_dispatches", backend=backend, bucket=bucket, devices=1
        ).inc()
        timer = metrics.timer(
            "solve_envs_duration_s", backend=backend, bucket=bucket, devices=1
        )
    else:
        from repro_torch.obs.trace import NULL_SPAN as timer
    if backend == "reference":
        with timer:
            return [
                mcop_reference(g)
                for g in model.build_batch(profile, envs).to_wcgs()
            ]
    if backend not in BATCH_BACKENDS + ("cuda_fused",):
        raise ValueError(f"unknown MCOP batch backend: {backend!r}")
    from repro_torch.kernels.mcop_phase import require_device

    device = require_device(device)
    dtype = _SOLVER_DTYPE
    n = profile.n
    m = _bucket_size(n, buckets)

    # Environment-independent profile tensors, zero-padded to the bucket;
    # padding is pinned and a pin-free profile anchors at vertex 0 (the
    # same convention _pack_bucket applies per graph).
    t_local = np.zeros(m, dtype)
    data_in = np.zeros((m, m), dtype)
    data_out = np.zeros((m, m), dtype)
    pinned = np.ones(m, dtype=bool)
    t_local[:n] = profile.t_local
    data_in[:n, :n] = profile.data_in
    data_out[:n, :n] = profile.data_out
    pinned[:n] = ~profile.offloadable
    if not pinned[:n].any():
        pinned[0] = True

    with timer:
        # six columns per environment cross to the device as one matrix
        env_dev = torch.from_numpy(np.stack(envs.astype(dtype), axis=0)).to(device)
        env_cols = EnvArrays(*env_dev.unbind(0))
        cuts, masks = _fused_dispatch(
            model,
            backend,
            torch.from_numpy(t_local).to(device),
            torch.from_numpy(data_in).to(device),
            torch.from_numpy(data_out).to(device),
            torch.from_numpy(pinned).to(device),
            env_cols,
        )
        cuts_h, masks_h = _to_host(cuts, masks)
    return [
        MCOPResult(min_cut=float(cuts_h[i]), local_mask=masks_h[i, :n].copy(), phases=[])
        for i in range(k)
    ]


def mcop(
    g: WCG, *, backend: str = "reference", device: str | torch.device = "cuda"
) -> MCOPResult:
    """Front door used by the rest of the framework.

    Backends: ``"reference"`` (numpy oracle with per-phase trace; no
    device), ``"torch"`` (plain tensor solver), ``"cuda"`` (single-graph
    batch through the solve kernel).  For many graphs per call use
    :func:`mcop_batch`.
    """
    if backend == "reference":
        return mcop_reference(g)
    if backend == "torch":
        return mcop_torch(g, device=device)
    if backend == "cuda":
        return mcop_batch([g], backend="cuda", device=device)[0]
    raise ValueError(f"unknown MCOP backend: {backend!r}")
