"""The solver fleet: one solve batch split across the devices of a mesh.

One broker flush produces a bucket's worth of WCG instances (or K
environments for ``solve_envs``); this module splits that batch across
the devices of a :class:`~repro_torch.launch.mesh.SolverMesh` and gathers
the cuts and masks back **bit-identically** to the single-device path.
The parity argument: the batched solvers do strictly per-graph arithmetic
(B1 and B2 solve each graph in its own warp or block with sums in an
order fixed by the graph alone; the plain versions mask lanes, which
changes which lanes update, never the update), so regrouping rows across
devices cannot perturb a bit.  The tests and ``chip_smoke.py`` hold it
with ``==``.

Placement is round-robin with inert padding, as in the JAX package:

* the batch is padded to a multiple of the shard count with graphs that
  are all pinned with zero weights and zero edges (the anchor fold
  absorbs them in zero phases), or, for ``solve_envs``, with environment
  rows of 1.0 (a benign environment, solved and discarded);
* row ``i`` goes to shard ``i mod D``; the host undoes the permutation
  and crops the padding.

Dispatch: every shard's inputs are copied to its device first (a copy
from pageable host memory waits for its stream, so no copy is left
between two launches), then each shard launches on its device's current
stream, none waiting for another, and last each shard's results come
back inside its own ``solve.shard`` / ``solve_envs.shard`` span
(attributes ``shard``, ``devices``, ``rows``: the real rows it holds).
A shard that holds padding only launches nothing.  On a mesh of distinct
CUDA devices each shard's inputs and outputs live on its own device and
the shards' kernels run at once, but one host thread issues every copy
from pageable memory, so the copies do not overlap.  ``chip_smoke.py``
(phase ``solver_fleet``) holds the fleet to the single-device solve
bit for bit on every GPU of its host, or on four repeated ``cuda:0``
entries where the host has one, and the tests on eight repeated ``"cpu"``
entries.  ``mesh=None`` never shards (:func:`resolve_mesh`).

What has no counterpart here: the JAX package donates the input buffers
to its compiled program and caches a compiled ``shard_map`` program per
(mesh, backend); eager PyTorch compiles nothing and frees each shard's
buffers when the call returns.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.launch.mesh import SolverMesh, make_solver_mesh
from repro_torch.obs.trace import NULL_SPAN
from repro_torch.runtime.sharding import solver_shards

__all__ = [
    "ShardPlan",
    "shard_plan",
    "default_solver_mesh",
    "resolve_mesh",
    "runs_on_cpu",
    "sharded_dispatch_arrays",
    "sharded_solve_envs",
]


# ----------------------------------------------------------------------
# Mesh resolution
# ----------------------------------------------------------------------


def default_solver_mesh() -> SolverMesh | None:
    """The fleet this process can see: every CUDA device when there are
    two or more, else ``None`` (the single-device path, no permutation).
    A caller passes it as ``mesh=`` to ask for the fleet; ``mesh=None``
    does not take it (see :func:`resolve_mesh`)."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count <= 1:
        return None
    return make_solver_mesh()


def resolve_mesh(mesh) -> SolverMesh | None:
    """Normalise the ``mesh=`` argument the solve entry points accept.

    * ``None``  — auto: the single-device path on every host.  The JAX
      package's auto takes :func:`default_solver_mesh`; here it does not,
      because the fleet gains only where the kernel outweighs the host: on
      four H100 80GB HBM3 of one host (700 W) ``solve_envs`` at K = 1024,
      n = 256 took 0.45x the single-device time, but ``mcop_batch`` over
      2048 graphs of 5-200 vertices 1.57x and ``solve_envs`` at K = 13
      1.7-2.3x (PERF.md, section 5).  Pass ``default_solver_mesh()`` for it.
    * ``False`` — the single-device path.
    * a :class:`SolverMesh` — use it; a one-shard mesh collapses to the
      plain path (identical results, no permutation round trip).

    Anything else raises ``TypeError``.  The result is again a valid
    ``mesh=`` argument with the same meaning.
    """
    if mesh is None or mesh is False:
        return None
    if not isinstance(mesh, SolverMesh):
        raise TypeError(f"mesh must be a SolverMesh, None, or False; got {mesh!r}")
    return mesh if solver_shards(mesh) > 1 else None


def runs_on_cpu(mesh: SolverMesh | None, device) -> bool:
    """Whether every solve of an entry point runs on the CPU: the mesh's
    devices when it has one, else ``device``."""
    devices = mesh.devices if mesh is not None else (torch.device(device),)
    return all(d.type == "cpu" for d in devices)


# ----------------------------------------------------------------------
# Shard plan: padding + round-robin permutation (pure numpy, testable)
# ----------------------------------------------------------------------


class ShardPlan(NamedTuple):
    """How k rows land on a d-shard fleet.

    ``perm`` reorders the padded batch into shard-major blocks (shard s's
    rows are contiguous), ``inverse`` undoes it after the gather; both
    have length ``k + pad``.
    """

    shards: int
    k: int
    pad: int
    perm: np.ndarray
    inverse: np.ndarray

    @property
    def rows_per_shard(self) -> int:
        return (self.k + self.pad) // self.shards

    def real_rows(self, shard: int) -> int:
        """Rows of the input (not padding) that shard ``shard`` holds."""
        return len(range(shard, self.k, self.shards))


def shard_plan(k: int, shards: int) -> ShardPlan:
    """Round-robin placement of k rows onto ``shards`` devices.

    Row ``i`` goes to shard ``i mod shards``; padding rows (appended at
    the tail, indices ``k .. k+pad-1``) fill the remainder so every shard
    receives exactly ``(k + pad) / shards`` rows.
    """
    if k <= 0:
        raise ValueError(f"cannot plan a shard layout for k={k} rows")
    if shards <= 0:
        raise ValueError(f"cannot shard over {shards} devices")
    pad = (-k) % shards
    kp = k + pad
    perm = np.argsort(np.arange(kp) % shards, kind="stable")
    inverse = np.empty(kp, dtype=np.int64)
    inverse[perm] = np.arange(kp)
    return ShardPlan(shards=shards, k=k, pad=pad, perm=perm, inverse=inverse)


# ----------------------------------------------------------------------
# Dispatch and gather, shared by both entry points
# ----------------------------------------------------------------------


def _run_shards(plan: ShardPlan, mesh: SolverMesh, upload, launch, m: int, *,
                tracer, stage: str) -> tuple[np.ndarray, np.ndarray]:
    """Upload every non-empty shard (``upload(rows slice, device)``), then
    launch each (``launch(uploaded)`` → device ``(cuts, masks)``), then
    read each back inside its ``<stage>.shard`` span.  Returns host
    ``(cuts (k,), masks (k, m))`` in input order."""
    from repro_torch.core.mcop import _to_host  # deferred: cycle
    from repro_torch.kernels.mcop_phase import require_device

    r = plan.rows_per_shard
    shards = [s for s in range(plan.shards) if plan.real_rows(s)]
    reachable = {d: require_device(d) for d in set(mesh.devices)}  # else KernelError
    inputs = {s: upload(slice(s * r, (s + 1) * r), reachable[mesh.devices[s]])
              for s in shards}
    outputs = {s: launch(inputs.pop(s)) for s in shards}
    cuts = np.zeros(plan.k + plan.pad, np.float32)
    masks = np.zeros((plan.k + plan.pad, m), bool)
    for s in range(plan.shards):
        span = (tracer.span(f"{stage}.shard", shard=s, devices=plan.shards,
                            rows=plan.real_rows(s))
                if tracer is not None else NULL_SPAN)
        with span:
            if s in outputs:
                cuts[s * r:(s + 1) * r], masks[s * r:(s + 1) * r] = _to_host(*outputs.pop(s))
    return cuts[plan.inverse][: plan.k], masks[plan.inverse][: plan.k]


# ----------------------------------------------------------------------
# Sharded raw-array dispatch (mcop_batch / WCGBatch flush path)
# ----------------------------------------------------------------------


def sharded_dispatch_arrays(
    adj, wl, wc, pin, *, mesh: SolverMesh, backend: str, tracer=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Solve a packed ``(k, m[, m])`` bucket across the fleet.

    Drop-in for ``core.mcop``'s single-device dispatch with a mesh: pads
    and round-robins the rows on the host, solves each shard on its
    device with ``backend`` (``"torch"`` or ``"cuda"``; each shard routes
    its graphs that are not exactly symmetric to B1's full-row variant, as
    the single-device dispatch does), and returns host ``(cuts (k,),
    masks (k, m))`` in input order, bit-identical to the single-device
    dispatch.
    """
    from repro_torch.core.mcop import _dispatch_arrays  # deferred: cycle

    adj, wl, wc, pin = (np.asarray(a) for a in (adj, wl, wc, pin))
    k, m = wl.shape
    plan = shard_plan(k, solver_shards(mesh))
    if plan.pad:
        # inert rows: all pinned, zero weights and edges — the anchor fold
        # collapses them before any phase runs; cropped after the gather
        adj = np.concatenate([adj, np.zeros((plan.pad, m, m), adj.dtype)])
        wl = np.concatenate([wl, np.zeros((plan.pad, m), wl.dtype)])
        wc = np.concatenate([wc, np.zeros((plan.pad, m), wc.dtype)])
        pin = np.concatenate([pin, np.ones((plan.pad, m), pin.dtype)])
    permuted = [np.ascontiguousarray(a[plan.perm]) for a in (adj, wl, wc, pin)]

    def upload(rows, device):
        return [torch.from_numpy(a[rows]).to(device) for a in permuted]

    def launch(arrays):
        return _dispatch_arrays(*arrays, backend)

    return _run_shards(plan, mesh, upload, launch, m, tracer=tracer, stage="solve")


# ----------------------------------------------------------------------
# Sharded fused build + solve (solve_envs flush path)
# ----------------------------------------------------------------------


def sharded_solve_envs(
    model, backend: str, profile_arrays, env, *, mesh: SolverMesh, tracer=None,
) -> tuple[np.ndarray, np.ndarray]:
    """``solve_envs``' build and solve of K environments across the fleet.

    ``profile_arrays`` are the bucket-padded host ``(t_local, data_in,
    data_out, pinned)``, copied once to each device that holds a shard;
    ``env`` is the ``(6, k)`` host matrix of environment columns in the
    solver dtype.  Pads the columns with rows of 1.0, round-robins the
    rows, builds and solves each shard on its device (``backend`` as in
    ``solve_envs``), and returns host ``(cuts (k,), masks (k, m))`` in
    input order, bit-identical to the single-device call (the weight build
    is row by row, the solve graph by graph).
    """
    from repro_torch.core.cost_models import EnvArrays  # deferred: cycle
    from repro_torch.core.mcop import _fused_dispatch

    env = np.asarray(env)
    k = env.shape[1]
    m = int(np.asarray(profile_arrays[0]).shape[0])
    plan = shard_plan(k, solver_shards(mesh))
    if plan.pad:
        env = np.concatenate([env, np.ones((env.shape[0], plan.pad), env.dtype)], axis=1)
    env = np.ascontiguousarray(env[:, plan.perm])
    profiles: dict = {}

    def upload(rows, device):
        if device not in profiles:
            profiles[device] = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
                                for a in profile_arrays]
        env_dev = torch.from_numpy(np.ascontiguousarray(env[:, rows])).to(device)
        return profiles[device], EnvArrays(*env_dev.unbind(0))

    def launch(uploaded):
        prof, env_cols = uploaded
        return _fused_dispatch(model, backend, *prof, env_cols)

    return _run_shards(plan, mesh, upload, launch, m, tracer=tracer, stage="solve_envs")
