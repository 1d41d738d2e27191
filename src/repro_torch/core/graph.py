"""Weighted consumption graphs (WCGs) — the paper's §4.2 data structure.

A WCG annotates every vertex with a 2-tuple ``<w_local(v), w_cloud(v)>``
(cost of executing the task on the weak tier vs. the strong tier) and every
edge with the communication cost paid only when the edge is *cut*, i.e. its
endpoints are placed on different tiers (Eq. 1 of the paper).

The canonical representation here is dense: a symmetric ``(n, n)`` adjacency
matrix of edge weights (0 == no edge) plus per-vertex cost vectors.  Dense
is the right layout for this framework because (i) the paper's graphs are
small-to-medium task graphs (|V| in the tens-to-thousands), (ii) the
device solvers (``kernels.mcop_phase``) index whole rows of the matrix,
and (iii) merging vertices is a row/column add — O(n) — instead of
pointer surgery.

Generators are provided for every topology in the paper's Fig. 2 (linear,
loop, tree, mesh) plus random connected graphs for property tests, the
reconstructed 6-node worked example of §5.5, and the face-recognition call
tree of Fig. 12.

:class:`WCGBatch` is the array-native sibling: K environments' worth of
WCGs stacked into ``(k, m[, m])`` tensors sharing one static topology
(vertex count, labels, padding layout).  Cost models *build* it in one
pass of array arithmetic and the batched solver (`mcop.mcop_batch`)
consumes it without any per-environment Python graph objects on the hot
path; :meth:`WCGBatch.to` moves its arrays onto a torch device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np
import torch

__all__ = [
    "WCG",
    "WCGBatch",
    "NonFiniteWeightError",
    "linear_graph",
    "loop_graph",
    "tree_graph",
    "mesh_graph",
    "random_wcg",
    "paper_example_graph",
    "face_recognition_graph",
    "TOPOLOGY_BUILDERS",
]


class NonFiniteWeightError(ValueError):
    """NaN/Inf detected in WCG weights or environment inputs.

    Corruption used to propagate silently into the solver (Stoer–Wagner
    happily partitions a NaN graph into garbage); now it is rejected at
    the first host boundary with the offending rows named, so the
    resilience layer can treat it as a transient failure and retry on
    clean inputs.  ``rows`` carries the offending batch-row indices.
    """

    def __init__(self, message: str, *, rows=()):
        super().__init__(message)
        self.rows = tuple(int(r) for r in rows)


@dataclasses.dataclass
class WCG:
    """Weighted consumption graph (paper §4.2).

    Attributes:
      w_local:  (n,) float64 — cost of executing vertex i on the local tier.
      w_cloud:  (n,) float64 — cost of executing vertex i on the remote tier.
      adj:      (n, n) float64 symmetric, zero diagonal — communication cost
                charged iff the edge is cut.
      offloadable: (n,) bool — False marks the paper's *unoffloadable* tasks
                (camera/GPS/UI-pinned; here: ingest/sampler/host-pinned
                stages).  At least one vertex must be unoffloadable to act
                as the local anchor; the generators default to vertex 0.
      names:    optional vertex labels for reporting.
    """

    w_local: np.ndarray
    w_cloud: np.ndarray
    adj: np.ndarray
    offloadable: np.ndarray
    names: list[str] = dataclasses.field(default_factory=list)

    def __post_init__(self) -> None:
        self.w_local = np.asarray(self.w_local, dtype=np.float64)
        self.w_cloud = np.asarray(self.w_cloud, dtype=np.float64)
        self.adj = np.asarray(self.adj, dtype=np.float64)
        self.offloadable = np.asarray(self.offloadable, dtype=bool)
        n = self.n
        if self.adj.shape != (n, n):
            raise ValueError(f"adj must be ({n},{n}), got {self.adj.shape}")
        if self.w_cloud.shape != (n,) or self.offloadable.shape != (n,):
            raise ValueError("vertex attribute shape mismatch")
        if not np.allclose(self.adj, self.adj.T):
            raise ValueError("adj must be symmetric (undirected comm costs)")
        if np.any(np.diag(self.adj) != 0):
            raise ValueError("adj diagonal must be zero")
        if np.any(self.adj < 0):
            raise ValueError("communication costs must be non-negative")
        if not self.names:
            self.names = [f"v{i}" for i in range(n)]

    # ------------------------------------------------------------------
    @property
    def n(self) -> int:
        return int(self.w_local.shape[0])

    @property
    def num_edges(self) -> int:
        return int(np.count_nonzero(np.triu(self.adj)))

    @property
    def local_cost_total(self) -> float:
        """C_local = Σ_v w_local(v) — the paper's no-offloading cost."""
        return float(self.w_local.sum())

    @property
    def gains(self) -> np.ndarray:
        """Per-vertex offloading gain w_local − w_cloud (paper Eq. 10 term)."""
        return self.w_local - self.w_cloud

    # ------------------------------------------------------------------
    def total_cost(self, local_mask: np.ndarray) -> float:
        """Eq. 2: total cost of the placement ``I`` (True == run locally).

        Args:
          local_mask: (n,) bool — True places the vertex on the local tier.
        Returns:
          float — Σ node costs + Σ cut-edge costs (cut edges are those with
          exactly one endpoint local).

        The comm term reduces row-by-row (``sum(axis=-1)`` then ``sum()``)
        so this scalar evaluation is bit-identical to one row of the
        vectorized :meth:`WCGBatch.total_cost` / :meth:`WCGBatch.price_batch`
        on an unpadded batch — the parity contract the fused pricing
        pipeline (``repro_torch.core.pricing``) asserts against.
        """
        local_mask = np.asarray(local_mask, dtype=bool)
        if local_mask.shape != (self.n,):
            raise ValueError("placement mask shape mismatch")
        node_cost = np.where(local_mask, self.w_local, self.w_cloud).sum()
        cut = local_mask[:, None] != local_mask[None, :]
        # each edge counted twice (symmetric adj), hence /2
        comm_cost = float((self.adj * cut).sum(axis=-1).sum()) / 2.0
        return float(node_cost) + comm_cost

    def validate_placement(self, local_mask: np.ndarray) -> None:
        local_mask = np.asarray(local_mask, dtype=bool)
        if np.any(~local_mask & ~self.offloadable):
            bad = [self.names[i] for i in np.nonzero(~local_mask & ~self.offloadable)[0]]
            raise ValueError(f"unoffloadable vertices placed on cloud tier: {bad}")

    def with_bandwidth_scale(self, scale: float) -> "WCG":
        """Return a WCG whose comm costs are scaled by 1/scale.

        Edge weights are ``bytes / B`` (Eq. 1), so a bandwidth change
        B → scale·B rescales every edge by 1/scale.  Used by the adaptive
        re-partitioning loop (paper Fig. 1) without re-profiling.
        """
        if scale <= 0:
            raise ValueError("bandwidth scale must be positive")
        return WCG(
            w_local=self.w_local.copy(),
            w_cloud=self.w_cloud.copy(),
            adj=self.adj / scale,
            offloadable=self.offloadable.copy(),
            names=list(self.names),
        )

    def with_speedup(self, new_f: float, old_f: float = 1.0) -> "WCG":
        """Rescale cloud costs for a new speedup factor F (T_cloud = T_local/F)."""
        if new_f <= 0:
            raise ValueError("speedup factor must be positive")
        return WCG(
            w_local=self.w_local.copy(),
            w_cloud=self.w_cloud * (old_f / new_f),
            offloadable=self.offloadable.copy(),
            adj=self.adj.copy(),
            names=list(self.names),
        )

    def copy(self) -> "WCG":
        return WCG(
            w_local=self.w_local.copy(),
            w_cloud=self.w_cloud.copy(),
            adj=self.adj.copy(),
            offloadable=self.offloadable.copy(),
            names=list(self.names),
        )


# ----------------------------------------------------------------------
# WCGBatch — K environments of one topology as stacked tensors.
# ----------------------------------------------------------------------


@dataclasses.dataclass
class WCGBatch:
    """K stacked WCGs over one static topology (the array-native WCG).

    Attributes:
      w_local:  (k, m) per-graph local execution costs.
      w_cloud:  (k, m) per-graph remote execution costs.
      adj:      (k, m, m) symmetric per-graph communication costs.
      pinned:   (k, m) bool — True marks unoffloadable vertices AND
                padding (padded vertices carry zero weights/edges, so the
                solver's anchor fold absorbs them for free).
      n_valid:  static per-graph true vertex counts (≤ m); padding lives
                in columns [n_valid[i], m).
      names:    shared vertex labels of the topology ('' == anonymous).

    Arrays are numpy on the host (construction / pricing, float64) or
    torch tensors after :meth:`to`; ``(n_valid, names)`` are static.
    """

    w_local: Any
    w_cloud: Any
    adj: Any
    pinned: Any
    n_valid: tuple[int, ...] = ()
    names: tuple[str, ...] = ()

    def __post_init__(self) -> None:
        self.n_valid = tuple(int(n) for n in self.n_valid)
        self.names = tuple(self.names)
        k, m = self.w_local.shape
        if not self.n_valid:
            self.n_valid = (m,) * k
        if len(self.n_valid) != k or any(not 0 < n <= m for n in self.n_valid):
            raise ValueError(f"n_valid {self.n_valid} inconsistent with (k={k}, m={m})")
        if self.adj.shape != (k, m, m):
            raise ValueError(f"adj must be ({k},{m},{m}), got {self.adj.shape}")
        if self.w_cloud.shape != (k, m) or self.pinned.shape != (k, m):
            raise ValueError("batch attribute shape mismatch")

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.n_valid)

    @property
    def k(self) -> int:
        return len(self.n_valid)

    @property
    def m(self) -> int:
        return int(self.w_local.shape[1])

    def validate_finite(self) -> None:
        """Reject NaN/Inf weights, naming the offending batch rows.

        Host-only (a no-op for device tensors): the cheap aggregate
        probe runs on every call, the per-row scan only on failure.
        Raises :class:`NonFiniteWeightError`.
        """
        arrays = (self.w_local, self.w_cloud, self.adj)
        if not all(isinstance(a, np.ndarray) for a in arrays):
            return
        probe = (
            float(self.w_local.sum())
            + float(self.w_cloud.sum())
            + float(self.adj.sum())
        )
        if np.isfinite(probe):
            return
        k = int(self.w_local.shape[0])
        bad = ~(
            np.isfinite(self.w_local).all(axis=-1)
            & np.isfinite(self.w_cloud).all(axis=-1)
            & np.isfinite(self.adj.reshape(k, -1)).all(axis=-1)
        )
        rows = np.nonzero(bad)[0]
        shown = ", ".join(str(int(r)) for r in rows[:8])
        more = "" if rows.size <= 8 else f" (+{rows.size - 8} more)"
        raise NonFiniteWeightError(
            f"non-finite WCG weights in batch row(s) {shown}{more}; "
            "rejecting before the solver partitions garbage",
            rows=rows,
        )

    # ------------------------------------------------------------------
    @classmethod
    def pack(
        cls,
        w_local: np.ndarray,
        w_cloud: np.ndarray,
        adj: np.ndarray,
        offloadable: np.ndarray,
        *,
        m: int | None = None,
        names: Sequence[str] = (),
        dtype=np.float64,
    ) -> "WCGBatch":
        """Stack already-batched ``(k, n[, n])`` arrays, zero-padding to
        ``m`` vertices (padding is pinned with zero weights/edges).

        Rejects NaN/Inf weights (:class:`NonFiniteWeightError`) — the
        host pack is the first boundary corruption can be named at.
        """
        w_local = np.asarray(w_local, dtype)
        k, n = w_local.shape
        m = n if m is None else int(m)
        if m < n:
            raise ValueError(f"pad target m={m} smaller than n={n}")
        wl = np.zeros((k, m), dtype)
        wc = np.zeros((k, m), dtype)
        a = np.zeros((k, m, m), dtype)
        pin = np.ones((k, m), dtype=bool)
        wl[:, :n] = w_local
        wc[:, :n] = w_cloud
        a[:, :n, :n] = adj
        pin[:, :n] = ~np.asarray(offloadable, dtype=bool)
        batch = cls(wl, wc, a, pin, n_valid=(n,) * k, names=tuple(names))
        batch.validate_finite()
        return batch

    @classmethod
    def from_wcgs(
        cls,
        graphs: Sequence[WCG],
        *,
        m: int | None = None,
        dtype=np.float64,
    ) -> "WCGBatch":
        """Pad a list of WCGs into one batch (generalized bucket packing).

        Graphs may differ in size and pinned sets; ``names`` are kept only
        when every graph shares one labelled topology.  Round-trips with
        :meth:`to_wcgs` exactly (offloadability included).
        """
        graphs = list(graphs)
        if not graphs:
            raise ValueError("cannot batch zero graphs")
        sizes = [g.n for g in graphs]
        m = max(sizes) if m is None else int(m)
        if m < max(sizes):
            raise ValueError(f"pad target m={m} smaller than largest graph {max(sizes)}")
        k = len(graphs)
        wl = np.zeros((k, m), dtype)
        wc = np.zeros((k, m), dtype)
        a = np.zeros((k, m, m), dtype)
        pin = np.ones((k, m), dtype=bool)
        for i, g in enumerate(graphs):
            n = g.n
            wl[i, :n] = g.w_local
            wc[i, :n] = g.w_cloud
            a[i, :n, :n] = g.adj
            pin[i, :n] = ~g.offloadable
        names = tuple(graphs[0].names)
        if any(tuple(g.names) != names for g in graphs[1:]):
            names = ()
        return cls(wl, wc, a, pin, n_valid=tuple(sizes), names=names)

    def to(self, device, dtype=torch.float32) -> "WCGBatch":
        """The same batch as torch tensors on ``device`` (weights in
        ``dtype``, ``pinned`` bool).  ``n_valid`` and ``names`` carry over."""

        def move(a, dt):
            t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
            return t.to(device=device, dtype=dt)

        return WCGBatch(
            move(self.w_local, dtype),
            move(self.w_cloud, dtype),
            move(self.adj, dtype),
            move(self.pinned, torch.bool),
            n_valid=self.n_valid,
            names=self.names,
        )

    # ------------------------------------------------------------------
    def wcg(self, i: int) -> WCG:
        """Materialize graph ``i`` as a plain :class:`WCG` (crops padding)."""
        n = self.n_valid[i]
        names = list(self.names[:n]) if len(self.names) >= n else []
        return WCG(
            w_local=np.array(self.w_local[i, :n], dtype=np.float64),
            w_cloud=np.array(self.w_cloud[i, :n], dtype=np.float64),
            adj=np.array(self.adj[i, :n, :n], dtype=np.float64),
            offloadable=~np.asarray(self.pinned[i, :n], dtype=bool),
            names=names,
        )

    def to_wcgs(self) -> list[WCG]:
        return [self.wcg(i) for i in range(self.k)]

    def anchored_pinned(self) -> np.ndarray:
        """Solver-facing pinned mask: a graph with no unoffloadable vertex
        is anchored at its vertex 0, matching ``mcop_reference`` (padding
        alone must not steal the anchor)."""
        pin = np.asarray(self.pinned, dtype=bool).copy()
        for i, n in enumerate(self.n_valid):
            if not pin[i, :n].any():
                pin[i, 0] = True
        return pin

    def total_cost(self, local_masks: np.ndarray) -> np.ndarray:
        """Vectorized Eq. 2 over the batch.

        Args:
          local_masks: (k, m) bool — one placement per graph; padding
            columns must be masked local (True).  Padded vertices carry
            zero weights and edges, so they contribute exactly 0.0.
        Returns:
          (k,) float — row ``i`` equals ``self.wcg(i).total_cost(mask_i)``;
          *bit*-identical when the batch is unpadded (``m == n_valid[i]``),
          because both paths reduce the comm term row-by-row in the same
          order (see :meth:`WCG.total_cost`).
        """
        masks = np.asarray(local_masks, dtype=bool)
        if masks.shape != self.w_local.shape:
            raise ValueError("placement mask batch shape mismatch")
        node = np.where(masks, self.w_local, self.w_cloud).sum(axis=-1)
        cut = masks[:, :, None] != masks[:, None, :]
        comm = (np.asarray(self.adj) * cut).sum(axis=-1).sum(axis=-1) / 2.0
        return node + comm

    def price_batch(
        self, local_masks: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Vectorized pricing of K placements: Eq. 2 plus the §7.1 baselines.

        One call replaces the three per-graph evaluations the adaptive
        loop's telemetry used to make per event (``total_cost`` of the
        current placement, the no-offloading cost, the full-offloading
        cost) — the array-native ``_emit``.

        Args:
          local_masks: (k, m) bool — the placement to price per graph
            (padding columns True).
        Returns:
          ``(partial, no_offload, full_offload)`` — three (k,) float
          arrays:

          * ``partial[i]``      = ``wcg(i).total_cost(local_masks[i])``
          * ``no_offload[i]``   = cost of running everything locally
            (Σ w_local; the all-True placement has zero cut edges)
          * ``full_offload[i]`` = cost of offloading every offloadable
            vertex (the placement mask is exactly ``pinned``)

          On an unpadded batch every number is bit-identical to the
          scalar path (``g.total_cost`` / ``baselines.no_offloading`` /
          ``baselines.full_offloading``) — asserted by the pricing
          parity suite.
        """
        partial = self.total_cost(local_masks)
        # all-local: np.where over an all-True mask sums w_local verbatim
        # and the cut matrix is empty, so Σ w_local IS the scalar number
        no_offload = np.asarray(self.w_local).sum(axis=-1)
        full_offload = self.total_cost(np.asarray(self.pinned, dtype=bool))
        return partial, no_offload, full_offload


# ----------------------------------------------------------------------
# Topology generators (paper Fig. 2)
# ----------------------------------------------------------------------


def _costs_from_times(
    t_local: np.ndarray, speedup: float
) -> tuple[np.ndarray, np.ndarray]:
    t_local = np.asarray(t_local, dtype=np.float64)
    return t_local, t_local / speedup


def linear_graph(
    n: int,
    *,
    t_local: Sequence[float] | None = None,
    edge_data: Sequence[float] | None = None,
    speedup: float = 2.0,
    bandwidth: float = 1.0,
    rng: np.random.Generator | None = None,
) -> WCG:
    """Fig. 2(b): a sequential chain v0 → v1 → … → v{n-1}."""
    rng = rng or np.random.default_rng(0)
    if t_local is None:
        t_local = rng.uniform(1.0, 10.0, size=n)
    if edge_data is None:
        edge_data = rng.uniform(0.5, 5.0, size=n - 1)
    w_local, w_cloud = _costs_from_times(np.asarray(t_local), speedup)
    adj = np.zeros((n, n))
    for i in range(n - 1):
        adj[i, i + 1] = adj[i + 1, i] = edge_data[i] / bandwidth
    offloadable = np.ones(n, dtype=bool)
    offloadable[0] = False  # entry task pinned to the device
    return WCG(w_local, w_cloud, adj, offloadable)


def loop_graph(
    n: int,
    *,
    speedup: float = 2.0,
    bandwidth: float = 1.0,
    rng: np.random.Generator | None = None,
) -> WCG:
    """Fig. 2(c): a cycle — iterative/online-social style applications."""
    rng = rng or np.random.default_rng(0)
    g = linear_graph(n, speedup=speedup, bandwidth=bandwidth, rng=rng)
    back = rng.uniform(0.5, 5.0) / bandwidth
    g.adj[0, n - 1] = g.adj[n - 1, 0] = back
    return g


def tree_graph(
    n: int,
    *,
    branching: int = 2,
    speedup: float = 2.0,
    bandwidth: float = 1.0,
    rng: np.random.Generator | None = None,
) -> WCG:
    """Fig. 2(d): tree-rooted task hierarchy; root = application entry."""
    rng = rng or np.random.default_rng(0)
    t_local = rng.uniform(1.0, 10.0, size=n)
    w_local, w_cloud = _costs_from_times(t_local, speedup)
    adj = np.zeros((n, n))
    for child in range(1, n):
        parent = (child - 1) // branching
        w = rng.uniform(0.5, 5.0) / bandwidth
        adj[parent, child] = adj[child, parent] = w
    offloadable = np.ones(n, dtype=bool)
    offloadable[0] = False
    return WCG(w_local, w_cloud, adj, offloadable)


def mesh_graph(
    rows: int,
    cols: int,
    *,
    speedup: float = 2.0,
    bandwidth: float = 1.0,
    rng: np.random.Generator | None = None,
) -> WCG:
    """Fig. 2(e): lattice topology (e.g. the Java face-recognition mesh)."""
    rng = rng or np.random.default_rng(0)
    n = rows * cols
    t_local = rng.uniform(1.0, 10.0, size=n)
    w_local, w_cloud = _costs_from_times(t_local, speedup)
    adj = np.zeros((n, n))

    def idx(r: int, c: int) -> int:
        return r * cols + c

    for r in range(rows):
        for c in range(cols):
            if c + 1 < cols:
                w = rng.uniform(0.5, 5.0) / bandwidth
                adj[idx(r, c), idx(r, c + 1)] = adj[idx(r, c + 1), idx(r, c)] = w
            if r + 1 < rows:
                w = rng.uniform(0.5, 5.0) / bandwidth
                adj[idx(r, c), idx(r + 1, c)] = adj[idx(r + 1, c), idx(r, c)] = w
    offloadable = np.ones(n, dtype=bool)
    offloadable[0] = False
    return WCG(w_local, w_cloud, adj, offloadable)


def random_wcg(
    n: int,
    *,
    edge_prob: float = 0.4,
    speedup: float = 2.0,
    n_unoffloadable: int = 1,
    rng: np.random.Generator | None = None,
    integer_weights: bool = False,
) -> WCG:
    """Random connected WCG for property tests (arbitrary topology)."""
    rng = rng or np.random.default_rng(0)
    if integer_weights:
        t_local = rng.integers(0, 20, size=n).astype(np.float64)
    else:
        t_local = rng.uniform(0.0, 20.0, size=n)
    w_local, w_cloud = _costs_from_times(t_local, speedup)
    adj = np.zeros((n, n))
    # spanning chain through a random permutation keeps the graph connected
    perm = rng.permutation(n)
    for a, b in zip(perm[:-1], perm[1:]):
        adj[a, b] = adj[b, a] = (
            float(rng.integers(0, 10)) if integer_weights else rng.uniform(0.0, 10.0)
        )
    extra = rng.random((n, n)) < edge_prob
    for i in range(n):
        for j in range(i + 1, n):
            if extra[i, j] and adj[i, j] == 0:
                adj[i, j] = adj[j, i] = (
                    float(rng.integers(0, 10))
                    if integer_weights
                    else rng.uniform(0.0, 10.0)
                )
    offloadable = np.ones(n, dtype=bool)
    pinned = rng.choice(n, size=max(1, min(n_unoffloadable, n - 1)), replace=False)
    offloadable[pinned] = False
    return WCG(w_local, w_cloud, adj, offloadable)


# ----------------------------------------------------------------------
# The paper's worked example (§5.5, Figs. 6–11) — reconstructed.
# ----------------------------------------------------------------------


def paper_example_graph() -> WCG:
    """The 6-vertex WCG of the paper's case study, reconstructed.

    The paper prints every phase's cut value, induced vertex ordering and
    itemized cut-edge sums (Figs. 6–10) but not the raw figure data.  The
    graph below is reconstructed from those constraints and reproduces the
    published run *exactly*:

      phase 1: order a,c,b,e,d,f;  t=f       cut = 45 − (15−5)  + 5        = 40
      phase 2: order a,c,b,e,{df}; t={df}    cut = 45 − (27−9)  + (1+3+4)  = 35
      phase 3: order a,c,b,{def};  t={def}   cut = 45 − (33−11) + (1+5)    = 29
      phase 4: order a,c,{bdef};   t={bdef}  cut = 45 − (42−14) + (1+4)    = 22  ← min
      phase 5: order a,{bcdef};    t={bcdef} cut = 45 − (45−15) + 12       = 27

    and the optimal partition {a,c} local / {b,d,e,f} cloud at cost 22
    (Fig. 11).  ``tests/test_paper_example.py`` asserts all of the above.
    """
    names = ["a", "b", "c", "d", "e", "f"]
    w_local = np.array([0.0, 9.0, 3.0, 12.0, 6.0, 15.0])
    w_cloud = np.array([0.0, 3.0, 1.0, 4.0, 2.0, 5.0])
    adj = np.zeros((6, 6))
    edges = {
        ("a", "b"): 3.0,
        ("a", "c"): 8.0,
        ("a", "f"): 1.0,
        ("b", "c"): 1.0,
        ("b", "d"): 3.0,
        ("b", "e"): 2.0,
        ("e", "f"): 4.0,
    }
    idx = {s: i for i, s in enumerate(names)}
    for (u, v), w in edges.items():
        adj[idx[u], idx[v]] = adj[idx[v], idx[u]] = w
    offloadable = np.array([False, True, True, True, True, True])
    return WCG(w_local, w_cloud, adj, offloadable, names=names)


def face_recognition_graph(
    *, speedup: float = 2.0, bandwidth_mbps: float = 1.0
) -> WCG:
    """Fig. 12: call tree of the Eigenface face-recognition app.

    Node times (ms, local) and edge transfer sizes (KB) follow the shape of
    the paper's profiled call graph: a main entry invoking image loading,
    training-set preparation, eigenface projection, and a checkAgainst
    matcher fan-out.  ``main`` and ``checkAgainst`` are unoffloadable, as
    in the paper's §7.2 experiment.
    """
    names = [
        "main",          # 0 (pinned)
        "loadImage",     # 1
        "buildMatrix",   # 2
        "computeEigen",  # 3
        "project",       # 4
        "checkAgainst",  # 5 (pinned)
        "distance",      # 6
        "rankMatches",   # 7
        "annotate",      # 8
    ]
    t_local = np.array([5.0, 40.0, 120.0, 400.0, 150.0, 20.0, 90.0, 30.0, 10.0])
    w_local = t_local
    w_cloud = t_local / speedup
    kb = {
        (0, 1): 60.0,
        (0, 5): 8.0,
        (1, 2): 900.0,
        (2, 3): 700.0,
        (3, 4): 120.0,
        (4, 5): 30.0,
        (5, 6): 25.0,
        (6, 7): 12.0,
        (7, 8): 6.0,
    }
    n = len(names)
    adj = np.zeros((n, n))
    for (u, v), size_kb in kb.items():
        # ms = KB / (MB/s) ≈ size_kb / (bandwidth_mbps * 1024) * 1000
        w = size_kb / (bandwidth_mbps * 1024.0) * 1000.0
        adj[u, v] = adj[v, u] = w
    offloadable = np.ones(n, dtype=bool)
    offloadable[0] = False
    offloadable[5] = False
    return WCG(w_local, w_cloud, adj, offloadable, names=names)


TOPOLOGY_BUILDERS: dict[str, Callable[..., WCG]] = {
    "linear": linear_graph,
    "loop": loop_graph,
    "tree": tree_graph,
    "mesh": lambda n, **kw: mesh_graph(max(2, int(np.sqrt(n))), max(2, int(np.ceil(n / max(2, int(np.sqrt(n)))))), **kw),
}
