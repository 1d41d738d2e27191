"""MCOP kernels for an NVIDIA GPU, with their plain PyTorch versions.

Two kernels solve the full modified Stoer–Wagner of the paper's
Algorithms 1–3 batched over graphs, one warp per graph with the adjacency
on chip as the packed upper triangle up to :func:`packed_limit` vertices
(several graphs a block), one thread block per graph with a scratch matrix
above it:

* :func:`mcop_stoer_wagner_kernel` (``csrc/mcop_sw.cu``) — solves a batch
  of ``(B, n, n)`` adjacencies held in device memory.  Counterpart of the
  JAX package's Pallas kernel of the same name.
* :func:`mcop_fused_solve_kernel` (``csrc/mcop_fused.cu``) — builds each
  environment's Eq. 4/6/8 weights from the application profile inside the
  warp (or block) and solves at once; per graph six floats come in and
  ``1 + n`` go out, and the ``(K, n, n)`` batch never exists in device
  memory.

A third runs a single MinCutPhase (Algorithm 3) per launch
(``csrc/mcop_phase.cu``; one warp up to n = 256, one block above):

* :func:`mcop_phase_kernel` — one phase on an ``(n, n)`` adjacency in
  device memory; returns ``(cut, s, t)``.  Counterpart of the JAX
  package's Pallas kernel of the same name.  :func:`mcop_phase_packed`
  launches it and returns the three results in one buffer.
* :func:`mcop_phase_step` — one phase of ``kernels.ops.mcop_min_cut``'s
  loop on its device state (:class:`LoopState`: the working matrix, packed
  or full, merged weights, labels, the best cut and its cloud mask, a log
  of ``(cut, s, t)``), followed in the same launch by the Algorithm-1
  merge and the best-cut update the host loop used to do.

Beside each stands its plain version (:func:`stoer_wagner_plain`,
:func:`fused_solve_plain`, ``kernels.ref.mcop_phase_plain``,
``kernels.ref.mcop_phase_step_plain``): the same function as tensor code,
the two solves batched with fixed loop bounds and lane masks and no host
synchronisation inside the loops.  A wrapper takes
the plain version **only** for tensors that lie on
the CPU; on a CUDA tensor it launches the kernel or raises
``kernels.build.KernelError`` — there is no switch and no ``try`` between
them.  ``LAUNCHES`` counts kernel launches.

Semantics shared by all four (and by ``core.mcop.mcop_reference``): the
anchor is the first pinned vertex (vertex 0 if none), every other pinned
vertex is folded into it, ties in the most-tightly-connected-vertex scan
go to the lowest index, a cut improves only on strict ``<``, and padded
vertices are encoded pinned with zero weights and zero edges.  A phase
reads rows, and a merge adds row ``t`` into row ``s`` and column ``t``
into column ``s``, as the reference does on any matrix.  The packed
layouts (B1's and B2's warp variant, B3's packed loop state) hold only the
upper triangle, so they answer for an exactly symmetric adjacency with a
zero diagonal only: a WCG is symmetric to a tolerance, and its callers send
one that is not exactly symmetric to the full-row variants
(``full_rows=True``, a full :class:`LoopState`).  Arithmetic is float32;
sums are taken in different orders by the kernels and the plain versions,
so cuts agree to rounding, not bitwise.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels.build import KernelError

__all__ = [
    "KernelError",
    "mcop_stoer_wagner_kernel",
    "mcop_fused_solve_kernel",
    "mcop_phase_kernel",
    "mcop_phase_packed",
    "mcop_phase_step",
    "phase_result",
    "LoopState",
    "packed_limit",
    "solve_plan",
    "triangle_index",
    "pack_triangle",
    "unpack_triangle",
    "stoer_wagner_plain",
    "fused_solve_plain",
    "FUSED_MODEL_KINDS",
    "SW_MAX_N",
    "FUSED_MAX_N",
    "PHASE_MAX_N",
    "LAUNCHES",
    "reset_launches",
    "require_device",
]

# f32-representable sentinels matching the solver backends in core.mcop —
# graphs priced in FLOPs/bytes can have cuts far above 2**30, so a small
# sentinel would silently swallow every phase cut.
NEG_INF = -1e30
POS_INF = 1e30

# cost-model kinds the in-kernel weight build implements (Eqs. 4 / 6 / 8);
# core.mcop maps CostModel instances onto these.
FUSED_MODEL_KINDS = ("time", "energy", "weighted")

# Largest vertex count each kernel accepts: every shape bucket the solver
# front ends produce up to the reference package's own wrapper limits
# (16, 64, 256, then 64-aligned sizes).  Above packed_limit() (341 vertices
# on an H100) the packed adjacency no longer fits a block's shared memory and
# lives in a scratch matrix in device memory.
SW_MAX_N = 768
FUSED_MAX_N = 512
# The phase kernel takes what the reference package's phase wrapper takes:
# an f32 adjacency of at most 12 MiB (its VMEM bound), n = 1773.
PHASE_MAX_N = 1773

# launches per kernel since the last reset_launches(); a wrapper adds one
# exactly where it launches its kernel, and nowhere else
LAUNCHES = {"mcop_stoer_wagner_kernel": 0, "mcop_fused_solve_kernel": 0,
            "mcop_phase_kernel": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def require_device(device: str | torch.device) -> torch.device:
    """``torch.device(device)``; a CUDA device this process cannot reach
    raises :class:`KernelError`.  Never substitutes another device."""
    dev = torch.device(device)
    if dev.type == "cuda":
        try:
            torch.empty(0, device=dev)
        except (AssertionError, RuntimeError) as err:
            raise KernelError(f"device {dev} is not available: {err}") from err
    return dev


# ======================================================================
# The packed upper triangle (the kernels' working-matrix layout)
# ======================================================================


def tri_floats(n: int) -> int:
    return n * (n - 1) // 2


def triangle_index(i, j, n: int):
    """Position of element ``(i, j)``, ``i != j``, of a symmetric ``n x n``
    matrix with a zero diagonal in its packed upper triangle: rows ``i = 0,
    1, ...`` one after another, row ``i`` holding columns ``i + 1 .. n - 1``
    (``csrc/sw_common.cuh:tri_row``).  Ints, numpy arrays or, when either
    is one, tensors."""
    if isinstance(i, torch.Tensor) or isinstance(j, torch.Tensor):
        i, j = torch.as_tensor(i), torch.as_tensor(j)
        lo, hi = torch.minimum(i, j), torch.maximum(i, j)
    else:
        lo, hi = np.minimum(i, j), np.maximum(i, j)
    return lo * (2 * n - lo - 1) // 2 + hi - lo - 1


def pack_triangle(adj):
    """The packed upper triangle of a square matrix (numpy or torch), in
    the matrix's dtype and on its device."""
    n = adj.shape[-1]
    if isinstance(adj, torch.Tensor):
        iu = torch.triu_indices(n, n, offset=1, device=adj.device)
        return adj[..., iu[0], iu[1]]
    iu = np.triu_indices(n, k=1)
    return adj[..., iu[0], iu[1]]


def unpack_triangle(packed: torch.Tensor, n: int) -> torch.Tensor:
    """The symmetric ``(n, n)`` matrix with a zero diagonal whose packed
    upper triangle is ``packed[:n (n - 1) / 2]``."""
    full = torch.zeros((n, n), dtype=packed.dtype, device=packed.device)
    iu = torch.triu_indices(n, n, offset=1, device=packed.device)
    vals = packed[: tri_floats(n)]
    full[iu[0], iu[1]] = vals
    full[iu[1], iu[0]] = vals
    return full


# ======================================================================
# Plain PyTorch versions
# ======================================================================


def _fold_pinned(adj, w_local, w_cloud, pin):
    """Merge every pinned vertex into the first pinned one, per graph
    (Algorithm 2 step 1).  Returns a private copy of the adjacency plus
    ``(wl, wc, alive, label, src)``; ``label`` maps each original vertex
    to the surviving vertex that represents it."""
    b, n = w_local.shape
    dev = adj.device
    idx = torch.arange(n, device=dev)
    rows = torch.arange(b, device=dev)
    zero = torch.zeros((), dtype=adj.dtype, device=dev)
    any_p = pin.any(dim=-1)
    src = torch.where(any_p, pin.to(torch.int8).argmax(dim=-1), 0)
    others = pin & (idx[None, :] != src[:, None])
    keep = ~others
    fold = (adj * others[:, :, None]).sum(dim=1)  # Σ rows being folded
    # Σ columns being folded, by the same reduction on the transpose: on a
    # symmetric matrix the same bits as ``fold``
    fold_c = (adj.transpose(1, 2).contiguous() * others[:, :, None]).sum(dim=1)
    adj = adj * keep[:, :, None] * keep[:, None, :]
    adj[rows, src, :] += fold * keep
    adj[rows, :, src] += fold_c * keep
    adj[rows, src, src] = 0.0
    src_free = ~pin[rows, src]
    wl_src = (w_local * pin).sum(dim=-1) + w_local[rows, src] * src_free
    wc_src = (w_cloud * pin).sum(dim=-1) + w_cloud[rows, src] * src_free
    wl = torch.where(others, zero, w_local)
    wc = torch.where(others, zero, w_cloud)
    wl[rows, src] = wl_src
    wc[rows, src] = wc_src
    label = torch.where(pin, src[:, None], idx[None, :])
    return adj, wl, wc, keep, label, src


def stoer_wagner_plain(
    adj: torch.Tensor,      # (B, n, n)
    w_local: torch.Tensor,  # (B, n)
    w_cloud: torch.Tensor,  # (B, n)
    pinned: torch.Tensor,   # (B, n) bool
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched modified Stoer–Wagner as plain tensor code.

    All B graphs advance in lock step: phase ``p`` runs ``n − 1 − p``
    absorb steps (a graph that has merged ``p`` times has at most
    ``n − p`` vertices left), and a lane whose graph needs fewer is
    masked.  Membership is a per-vertex representative label, as in the
    kernels.  Runs on whatever device and dtype the inputs have; returns
    ``(min_cuts (B,), local_masks (B, n) bool)``.
    """
    b, n = w_local.shape
    dev = adj.device
    idx = torch.arange(n, device=dev)
    rows = torch.arange(b, device=dev)
    zero = torch.zeros((), dtype=adj.dtype, device=dev)
    ctot = w_local.sum(dim=-1)  # C_local — invariant under merging
    adj, wl, wc, alive, label, src = _fold_pinned(
        adj, w_local, w_cloud, pinned.to(torch.bool)
    )

    best_cut = torch.full((b,), POS_INF, dtype=adj.dtype, device=dev)
    best_cloud = torch.zeros((b, n), dtype=torch.bool, device=dev)

    # ---- Algorithm 2: phases, each followed by an Algorithm-1 merge -----
    for p in range(n - 1):
        n_alive = alive.sum(dim=-1)
        valid = n_alive >= 2
        gains = wl - wc
        in_a = alive & (idx[None, :] == src[:, None])
        conn = adj[rows, src]
        s_reg, t_reg = src, src
        for i in range(n - 1 - p):
            do = (i + 1) < n_alive  # absorb exactly n_alive − 1 vertices
            cand = alive & ~in_a
            scores = torch.where(cand, conn - gains, NEG_INF)
            v = scores.argmax(dim=-1)  # first maximum wins ties
            in_a = in_a | (do[:, None] & (idx[None, :] == v[:, None]))
            conn = torch.where(do[:, None], conn + adj[rows, v], conn)
            s_reg = torch.where(do, t_reg, s_reg)
            t_reg = torch.where(do, v, t_reg)

        # Eq. 10 cut-of-the-phase.
        t_row = adj[rows, t_reg]
        comm = (t_row * alive).sum(dim=-1)
        cut = torch.where(valid, ctot - gains[rows, t_reg] + comm, POS_INF)
        cloud_t = label == t_reg[:, None]
        improved = valid & (cut < best_cut)
        best_cut = torch.where(improved, cut, best_cut)
        best_cloud = torch.where(improved[:, None], cloud_t, best_cloud)

        # Algorithm 1: merge t into s, in place, on the lanes that merge:
        # row s += row t, column s += column t.
        do_merge = valid & (s_reg != t_reg)
        dm = do_merge[:, None]
        t_col = adj[rows, :, t_reg]
        adj[rows, s_reg, :] += torch.where(dm, t_row, zero)
        adj[rows, :, s_reg] += torch.where(dm, t_col, zero)
        adj[rows, s_reg, s_reg] = torch.where(do_merge, zero, adj[rows, s_reg, s_reg])
        adj[rows, t_reg, :] = torch.where(dm, zero, adj[rows, t_reg, :])
        adj[rows, :, t_reg] = torch.where(dm, zero, adj[rows, :, t_reg])
        is_s = idx[None, :] == s_reg[:, None]
        is_t = idx[None, :] == t_reg[:, None]
        wl_t = wl[rows, t_reg][:, None]
        wc_t = wc[rows, t_reg][:, None]
        wl = torch.where(dm & is_t, zero, torch.where(dm & is_s, wl + wl_t, wl))
        wc = torch.where(dm & is_t, zero, torch.where(dm & is_s, wc + wc_t, wc))
        alive = alive & ~(dm & is_t)
        label = torch.where(dm & cloud_t, s_reg[:, None], label)
        # the anchor follows a merged source
        src = torch.where(do_merge & (t_reg == src), s_reg, src)

    return best_cut, ~best_cloud


def _kernel_weights(kind, omega, t_loc, d_in, d_out, env):
    """Eqs. 4/6/8 for K environments, as the fused kernel computes them.

    ``t_loc`` (n,), ``d_in``/``d_out`` (n, n), ``env`` (K, 6) with columns
    [bandwidth_up, bandwidth_down, speedup, p_compute, p_idle,
    p_transfer].  Mirrors ``core.cost_models.CostModel.batch_weights`` in
    the tensors' dtype, including the two-term association of Eq. 1's
    symmetrisation.  Returns ``(wl (K, n), wc (K, n), adj (K, n, n))``.
    """
    b_up, b_down, speedup, p_c, p_i, p_tr = (env[:, c] for c in range(6))
    per_dir = d_in[None] / b_up[:, None, None] + d_out[None] / b_down[:, None, None]
    adj_t = per_dir + per_dir.transpose(-1, -2)
    wl_t = t_loc[None, :].expand(env.shape[0], -1)
    wc_t = t_loc[None, :] / speedup[:, None]
    if kind == "time":
        return wl_t, wc_t, adj_t
    wl_e = p_c[:, None] * t_loc[None, :]
    wc_e = p_i[:, None] * wc_t
    adj_e = p_tr[:, None, None] * adj_t
    if kind == "energy":
        return wl_e, wc_e, adj_e
    # Eq. 8: ω·T/T_local + (1−ω)·E/E_local, normalised per graph.
    t_norm = wl_t.sum(dim=-1).clamp_min(1e-30)[:, None]
    e_norm = wl_e.sum(dim=-1).clamp_min(1e-30)[:, None]
    w = torch.tensor(omega, dtype=t_loc.dtype, device=t_loc.device)
    return (
        w * wl_t / t_norm + (1 - w) * wl_e / e_norm,
        w * wc_t / t_norm + (1 - w) * wc_e / e_norm,
        w * adj_t / t_norm[..., None] + (1 - w) * adj_e / e_norm[..., None],
    )


def _check_kind(kind: str) -> None:
    if kind not in FUSED_MODEL_KINDS:
        raise ValueError(
            f"unknown fused cost-model kind {kind!r}; expected one of "
            f"{FUSED_MODEL_KINDS}"
        )


def fused_solve_plain(
    t_local: torch.Tensor,   # (n,)
    data_in: torch.Tensor,   # (n, n)
    data_out: torch.Tensor,  # (n, n)
    pinned: torch.Tensor,    # (n,) bool
    env: torch.Tensor,       # (K, 6)
    *,
    kind: str,
    omega: float = 0.5,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the fused kernel: build the K graphs, then solve."""
    _check_kind(kind)
    wl, wc, adj = _kernel_weights(kind, omega, t_local, data_in, data_out, env)
    pin = pinned.to(torch.bool)[None, :].expand(env.shape[0], -1)
    return stoer_wagner_plain(adj, wl.contiguous(), wc.contiguous(), pin)


# ======================================================================
# Kernel wrappers
# ======================================================================

_P = ctypes.c_void_p  # pointers and the stream: never ctypes' default 32-bit int
_I = ctypes.c_int


def _library(name: str):
    """The kernel's library with its C signatures declared (first use
    compiles it; see ``kernels.build``)."""
    from repro_torch.kernels import build

    lib = build.load(name)
    if name == "mcop_sw":
        lib.repro_torch_sw_packed_limit.argtypes = [ctypes.POINTER(_I)]
        lib.repro_torch_sw_plan.argtypes = [_I, _I, _I, ctypes.POINTER(_I)]
        lib.repro_torch_sw_plan_rows.argtypes = [_I, _I, ctypes.POINTER(_I)]
        lib.repro_torch_sw_solve.argtypes = [_P] * 7 + [_I] * 7 + [_P]
    elif name == "mcop_phase":
        lib.repro_torch_phase_solve.argtypes = (
            [_P] * 3 + [_I, ctypes.c_float, _I, _I, _P, _P]
        )
        lib.repro_torch_phase_step.argtypes = (
            [_P] * 9 + [_I, _I, ctypes.c_float, _I, _I, _P]
        )
    else:
        lib.repro_torch_fused_plan.argtypes = [_I, _I, _I, ctypes.POINTER(_I)]
        lib.repro_torch_fused_solve.argtypes = (
            [_P] * 8 + [_I] * 3 + [ctypes.c_float] + [_I] * 4 + [_P]
        )
    return lib  # restype stays ctypes' default c_int: the CUDA error code


def _require(t: torch.Tensor, name: str, shape: tuple, dtype, device, *,
             layout: str = "contiguous") -> None:
    """Type, shape, dtype and device of a kernel argument, and its layout:
    ``"contiguous"``, ``"rows"`` (the last dim contiguous; the kernel takes
    the other strides) or ``"any"`` (the kernel takes every stride)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} lies on {t.device}, expected {device}")
    if layout == "contiguous" and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if layout == "rows" and t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"{name} must have a contiguous last dim")


_PLAN_KEYS = ("cpl", "threads", "smem_bytes", "resident_blocks", "graphs_per_block")


def _plan(plan_fn, n: int, batch: int, graphs_per_block: int = 0) -> dict:
    """Launch geometry of a B1 or B2 solve of ``batch`` n-vertex graphs on
    the current device, from the library's plan function: ``cpl`` (columns
    a lane of the warp variant; 0 = the block variant with a scratch
    matrix), ``threads``, ``smem_bytes``, ``resident_blocks``,
    ``graphs_per_block`` and the ``grid``.  ``graphs_per_block`` > 0 asks
    for that many graphs a block (the result is the same bits for every
    choice); 0 lets the plan choose."""
    out = (_I * 5)()
    err = plan_fn(n, batch, graphs_per_block, out)
    if err != 0:
        raise KernelError(
            f"CUDA error {err} while planning an n={n} MCOP solve "
            f"(graphs_per_block={graphs_per_block})"
        )
    plan = dict(zip(_PLAN_KEYS, (int(x) for x in out)))
    per = plan["graphs_per_block"]
    plan["grid"] = max(1, min(-(-batch // per), plan["resident_blocks"]))
    return plan


def _sw_plan_fn(full_rows: bool):
    """B1's plan function: the warp variant up to the packed limit, or
    (``full_rows``) the block variant at every n."""
    lib = _library("mcop_sw")
    if not full_rows:
        return lib.repro_torch_sw_plan
    return lambda n, batch, _graphs_per_block, out: lib.repro_torch_sw_plan_rows(n, batch, out)


def solve_plan(kernel: str, n: int, batch: int, *, graphs_per_block: int = 0,
               device="cuda") -> dict:
    """:func:`_plan` of ``kernel`` (``"mcop_stoer_wagner_kernel"`` or
    ``"mcop_fused_solve_kernel"``) on ``device``, plus ``resident_graphs``
    (graphs the card works on at once)."""
    if kernel == "mcop_stoer_wagner_kernel":
        plan_fn = _sw_plan_fn(False)
    else:
        plan_fn = _library("mcop_fused").repro_torch_fused_plan
    with torch.cuda.device(require_device(device)):
        plan = _plan(plan_fn, n, batch, graphs_per_block)
    plan["resident_graphs"] = min(batch, plan["grid"] * plan["graphs_per_block"])
    return plan


def packed_limit(device="cuda") -> int:
    """Largest n whose packed adjacency fits one block's shared memory on
    ``device``: B1 and B2 run their warp variant up to it, the block
    variant with a scratch matrix above it."""
    lib = _library("mcop_sw")
    out = _I()
    with torch.cuda.device(require_device(device)):
        err = lib.repro_torch_sw_packed_limit(ctypes.byref(out))
    if err != 0:
        raise KernelError(f"CUDA error {err} while reading the packed limit")
    return int(out.value)


def _scratch(plan: dict, n: int, device) -> torch.Tensor:
    """The block variant's per-block scratch adjacency (empty for the warp
    variant).  Freed when the wrapper returns, possibly before the kernel
    ends; PyTorch's allocator hands the block only to later work on the
    same stream, which runs after the kernel."""
    size = 0 if plan["cpl"] else plan["grid"] * n * n
    return torch.empty((size,), dtype=torch.float32, device=device)


def mcop_stoer_wagner_kernel(
    adj: torch.Tensor,      # (B, n, n) f32 — a batch of WCG adjacencies
    w_local: torch.Tensor,  # (B, n) f32
    w_cloud: torch.Tensor,  # (B, n) f32
    pinned: torch.Tensor,   # (B, n) bool — True = unoffloadable or padding
    *,
    full_rows: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Solve a batch of MCOP instances on the inputs' device.

    CUDA tensors launch ``csrc/mcop_sw.cu`` on the current stream (no
    synchronisation; outputs and scratch come from ``torch.empty``); CPU
    tensors run :func:`stoer_wagner_plain`.  Returns ``(min_cuts (B,)
    f32, local_masks (B, n) bool)``.  Each adjacency has a zero diagonal;
    dead/padded vertices must be encoded as pinned with zero weights and
    zero incident edges.  Raises ``ValueError`` for ``n > SW_MAX_N``.

    Symmetry: up to :func:`packed_limit` the kernel's warp variant reads
    the upper triangle only, so it requires every adjacency of the batch
    to be *exactly* symmetric; given one that is not, it answers for the
    matrix mirrored from its upper triangle.  A caller whose batch is not
    exactly symmetric passes ``full_rows=True``: the block variant then
    runs at every n, reading rows and merging rows and columns as the
    reference does (one block a graph: slower).  The wrapper does not test
    the batch itself (that would synchronise with the device);
    ``core.mcop`` tests its host copy of each bucket.  The plain version
    needs neither.
    """
    return _solve_sw(adj, w_local, w_cloud, pinned, full_rows=full_rows)


def _solve_sw(adj, w_local, w_cloud, pinned, graphs_per_block: int = 0,
              full_rows: bool = False):
    """:func:`mcop_stoer_wagner_kernel` with the graphs a block of its
    warp variant chosen by the caller (0: by the plan); the checks run it
    at two settings and compare the bits."""
    if adj.ndim != 3 or adj.shape[-1] != adj.shape[-2]:
        raise ValueError(f"expected a (B, n, n) batch, got {tuple(adj.shape)}")
    b, n = int(adj.shape[0]), int(adj.shape[-1])
    if n > SW_MAX_N:
        raise ValueError(
            f"mcop_stoer_wagner_kernel takes graphs of at most {SW_MAX_N} "
            f"vertices, got n={n}"
        )
    dev = adj.device
    _require(adj, "adj", (b, n, n), torch.float32, dev)
    _require(w_local, "w_local", (b, n), torch.float32, dev)
    _require(w_cloud, "w_cloud", (b, n), torch.float32, dev)
    _require(pinned, "pinned", (b, n), torch.bool, dev)
    if dev.type == "cpu":
        return stoer_wagner_plain(adj, w_local, w_cloud, pinned)
    if dev.type != "cuda":
        raise ValueError(f"no MCOP kernel for device {dev}")
    cuts = torch.empty((b,), dtype=torch.float32, device=dev)
    masks = torch.empty((b, n), dtype=torch.bool, device=dev)
    if b == 0:
        return cuts, masks
    lib = _library("mcop_sw")
    with torch.cuda.device(dev):
        plan = _plan(_sw_plan_fn(full_rows), n, b, graphs_per_block)
        scratch = _scratch(plan, n, dev)
        err = lib.repro_torch_sw_solve(
            adj.data_ptr(), w_local.data_ptr(), w_cloud.data_ptr(),
            pinned.data_ptr(), cuts.data_ptr(), masks.data_ptr(),
            scratch.data_ptr(), b, n, plan["grid"], plan["threads"], plan["cpl"],
            plan["smem_bytes"], int(full_rows), torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise KernelError(f"mcop_sw kernel launch refused (CUDA error {err}; B={b}, n={n}, {plan})")
    LAUNCHES["mcop_stoer_wagner_kernel"] += 1
    return cuts, masks


def mcop_fused_solve_kernel(
    t_local: torch.Tensor,   # (n,) f32 — profile local execution times
    data_in: torch.Tensor,   # (n, n) f32 — profile transfer-in bytes
    data_out: torch.Tensor,  # (n, n) f32 — profile transfer-out bytes
    pinned: torch.Tensor,    # (n,) bool — profile unoffloadable mask
    env: torch.Tensor,       # (K, 6) f32 — per-graph environment columns
    *,
    kind: str,
    omega: float = 0.5,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused pipeline: environment rows → WCG weights → min cut.

    ``kind`` is one of ``FUSED_MODEL_KINDS`` (Eq. 4 / Eq. 6 /
    Eq. 8-with-``omega``); an unknown kind raises ``ValueError`` before
    any launch.  CUDA tensors launch ``csrc/mcop_fused.cu``; CPU tensors
    run :func:`fused_solve_plain`.  Returns ``(min_cuts (K,) f32,
    local_masks (K, n) bool)``.  Raises ``ValueError`` for
    ``n > FUSED_MAX_N``.
    """
    _check_kind(kind)
    if env.ndim != 2 or env.shape[1] != 6:
        raise ValueError(f"env must be (K, 6), got {tuple(env.shape)}")
    k, n = int(env.shape[0]), int(t_local.shape[-1])
    if n > FUSED_MAX_N:
        raise ValueError(
            f"mcop_fused_solve_kernel takes profiles of at most {FUSED_MAX_N} "
            f"vertices, got n={n}"
        )
    dev = env.device
    _require(t_local, "t_local", (n,), torch.float32, dev)
    _require(data_in, "data_in", (n, n), torch.float32, dev)
    _require(data_out, "data_out", (n, n), torch.float32, dev)
    _require(pinned, "pinned", (n,), torch.bool, dev)
    _require(env, "env", (k, 6), torch.float32, dev)
    if dev.type == "cpu":
        return fused_solve_plain(
            t_local, data_in, data_out, pinned, env, kind=kind, omega=omega
        )
    if dev.type != "cuda":
        raise ValueError(f"no MCOP kernel for device {dev}")
    cuts = torch.empty((k,), dtype=torch.float32, device=dev)
    masks = torch.empty((k, n), dtype=torch.bool, device=dev)
    if k == 0:
        return cuts, masks
    lib = _library("mcop_fused")
    with torch.cuda.device(dev):
        plan = _plan(lib.repro_torch_fused_plan, n, k)
        scratch = _scratch(plan, n, dev)
        err = lib.repro_torch_fused_solve(
            t_local.data_ptr(), data_in.data_ptr(), data_out.data_ptr(),
            pinned.data_ptr(), env.data_ptr(), cuts.data_ptr(), masks.data_ptr(),
            scratch.data_ptr(), k, n, FUSED_MODEL_KINDS.index(kind), float(omega),
            plan["grid"], plan["threads"], plan["cpl"], plan["smem_bytes"],
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise KernelError(f"mcop_fused kernel launch refused (CUDA error {err}; K={k}, n={n}, {plan})")
    LAUNCHES["mcop_fused_solve_kernel"] += 1
    return cuts, masks


def mcop_phase_packed(
    adj: torch.Tensor,        # (n, n) f32 — current (possibly merged) graph
    gains,                    # (n,) — w_local − w_cloud
    alive,                    # (n,) bool, or f32 with 1.0 = alive
    src,                      # anchor vertex (int or 0-d tensor)
    c_local_total,            # C_local of the original graph
) -> torch.Tensor:
    """Run one MinCutPhase on ``adj``'s device.  Returns its result packed
    in one ``(3,)`` int32 tensor there: the cut's f32 bits, ``s``, ``t``
    (:func:`phase_result` reads it back in one copy).

    ``gains`` and ``alive`` may be arrays or tensors; they are moved to
    ``adj``'s device as f32 and bool.  A CUDA ``adj`` (contiguous f32)
    launches ``csrc/mcop_phase.cu`` on the current stream without
    synchronising (rows staged in shared memory up to n = 241, read from
    device memory above); a CPU ``adj`` runs ``kernels.ref.mcop_phase_plain``.
    Raises ``ValueError`` for ``n > PHASE_MAX_N``.
    """
    from repro_torch.kernels.ref import mcop_phase_plain

    if adj.ndim != 2 or adj.shape[0] != adj.shape[1]:
        raise ValueError(f"expected an (n, n) adjacency, got {tuple(adj.shape)}")
    n = int(adj.shape[0])
    if n > PHASE_MAX_N:
        raise ValueError(
            f"mcop_phase_kernel takes graphs of at most {PHASE_MAX_N} "
            f"vertices, got n={n}"
        )
    dev = adj.device
    gains = torch.as_tensor(gains, device=dev).to(torch.float32)
    alive = torch.as_tensor(alive, device=dev)
    if alive.dtype != torch.bool:
        alive = alive > 0.5
    src = int(src)
    if not 0 <= src < n:
        raise ValueError(f"src={src} is not a vertex of an n={n} graph")
    ctot = float(torch.as_tensor(c_local_total, dtype=torch.float32))
    _require(adj, "adj", (n, n), torch.float32, dev)
    _require(gains, "gains", (n,), torch.float32, dev)
    _require(alive, "alive", (n,), torch.bool, dev)
    if dev.type == "cpu":
        cut, s, t = mcop_phase_plain(adj, gains, alive, src, ctot)
        return torch.cat([cut.reshape(1).view(torch.int32),
                          torch.tensor([s, t], dtype=torch.int32)])
    if dev.type != "cuda":
        raise ValueError(f"no MCOP kernel for device {dev}")
    out = torch.empty((3,), dtype=torch.int32, device=dev)
    lib = _library("mcop_phase")
    with torch.cuda.device(dev):
        err = lib.repro_torch_phase_solve(
            adj.data_ptr(), gains.data_ptr(), alive.data_ptr(), src, ctot, n,
            _ROWS["staged"], out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise KernelError(f"mcop_phase kernel launch refused (CUDA error {err}; n={n})")
    LAUNCHES["mcop_phase_kernel"] += 1
    return out


def mcop_phase_kernel(adj, gains, alive, src, c_local_total):
    """One MinCutPhase as :func:`mcop_phase_packed` runs it, returned as
    ``(cut, s, t)``: 0-d tensors on ``adj``'s device, f32, int32, int32
    (views of the packed buffer)."""
    out = mcop_phase_packed(adj, gains, alive, src, c_local_total)
    return out[0:1].view(torch.float32)[0], out[1], out[2]


def phase_result(packed: torch.Tensor) -> tuple[float, int, int]:
    """``(cut, s, t)`` of :func:`mcop_phase_packed` as Python numbers: one
    device-to-host copy on a GPU."""
    host = packed.cpu()
    return float(host[0:1].view(torch.float32)[0]), int(host[1]), int(host[2])


# ======================================================================
# The per-phase tier's device loop (kernels.ops.mcop_min_cut)
# ======================================================================

# row strategies of the phase kernels: rows staged in shared memory where
# the matrix fits, or read from device memory and L2
_ROWS = {"staged": 0, "l2": 1}


def _section(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


class LoopState:
    """The state of ``kernels.ops.mcop_min_cut``'s loop after the pinned
    fold, on one device, in one buffer (one upload, one read-back):

    ``packed`` the working matrix (f32, padded to 16 bytes): its packed
    upper triangle, or with ``full`` the whole ``(n, n)`` matrix row-major
    (for a graph that is not exactly symmetric with a zero diagonal),
    ``wl``/``wc`` the merged node costs, ``gains`` scratch,
    ``label`` (int32) the surviving vertex each original vertex merged
    into, ``log`` ``(phases, 3)`` int32 ``(cut bits, s, t)`` of each phase,
    ``scal`` int32 ``[anchor, best cut's f32 bits]`` (the best starts at
    +inf), ``cloud`` (uint8) the best cut's cloud side, ``alive`` (uint8).
    """

    _SECTIONS = ("packed", "wl", "wc", "gains", "label", "log", "scal", "cloud", "alive")

    def __init__(self, adj: np.ndarray, wl: np.ndarray, wc: np.ndarray,
                 alive: np.ndarray, label: np.ndarray, src: int, phases: int, device,
                 *, full: bool = False):
        n = int(wl.shape[0])
        self.n, self.phases, self.full = n, phases, bool(full)
        matrix = n * n if full else tri_floats(n)
        sizes = {"packed": matrix * 4, "wl": 4 * n, "wc": 4 * n, "gains": 4 * n,
                 "label": 4 * n, "log": 12 * phases, "scal": 8, "cloud": n, "alive": n}
        offsets, at = {}, 0
        for name in self._SECTIONS:
            offsets[name] = at
            at += _section(sizes[name])
        host = np.zeros(at, np.uint8)

        def view(buf, name, dtype, count):
            o = offsets[name]
            return buf[o:o + count * np.dtype(dtype).itemsize].view(dtype)

        view(host, "packed", np.float32, matrix)[:] = (
            np.asarray(adj, np.float32).reshape(-1) if full else pack_triangle(adj))
        view(host, "wl", np.float32, n)[:] = wl
        view(host, "wc", np.float32, n)[:] = wc
        view(host, "label", np.int32, n)[:] = label
        view(host, "scal", np.int32, 2)[:] = (src, np.float32(np.inf).view(np.int32))
        view(host, "alive", np.uint8, n)[:] = alive
        self.buffer = torch.from_numpy(host).to(device)
        types = {"packed": (torch.float32, _section(sizes["packed"]) // 4),
                 "wl": (torch.float32, n), "wc": (torch.float32, n),
                 "gains": (torch.float32, n), "label": (torch.int32, n),
                 "log": (torch.int32, 3 * phases), "scal": (torch.int32, 2),
                 "cloud": (torch.uint8, n), "alive": (torch.uint8, n)}
        for name, (dtype, count) in types.items():
            o = offsets[name]
            setattr(self, name, self.buffer[o:o + count * dtype.itemsize].view(dtype))
        self._result = slice(offsets["scal"], offsets["cloud"] + n)
        self._cloud_at = offsets["cloud"] - offsets["scal"]
        # the step kernel's pointer arguments, in its order
        self.pointers = tuple(getattr(self, name).data_ptr() for name in (
            "packed", "wl", "wc", "gains", "label", "log", "scal", "alive", "cloud"))

    def result(self) -> tuple[float, np.ndarray]:
        """``(best cut, cloud mask)``: one device-to-host copy."""
        host = self.buffer[self._result].cpu().numpy()
        best = float(host[4:8].view(np.float32)[0])
        return best, host[self._cloud_at:].astype(bool)

    def read_log(self) -> list[tuple[float, int, int]]:
        """The ``(cut, s, t)`` of every phase run so far, in order."""
        log = self.log.view(-1, 3).cpu().numpy()
        return [(float(np.int32(c).view(np.float32)), int(s), int(t)) for c, s, t in log]


def mcop_phase_step(state: LoopState, phase: int, c_local_total: float, *,
                    rows: str = "staged") -> None:
    """Phase ``phase`` of ``kernels.ops.mcop_min_cut``'s loop and what the
    host loop did after it, on ``state``'s device: one MinCutPhase from the
    anchor, the strict-``<`` best-cut update with its cloud side (the
    members of ``t``), the Algorithm-1 merge of ``t`` into ``s`` in f32
    (``wl``/``wc`` too), the label update, the anchor moved when ``t`` was
    the source, and ``(cut, s, t)`` written to row ``phase`` of the log.
    The state's layout (``state.full``) picks the kernel's: packed rows,
    or full rows staged up to n = 241 and read from L2 above.

    A CUDA state launches ``csrc/mcop_phase.cu``'s step kernel on the
    current stream and reads nothing back; ``rows`` picks where its rows
    come from (``"staged"`` in shared memory, the default, or ``"l2"``;
    the result is the same).  A CPU state runs
    ``kernels.ref.mcop_phase_step_plain``.  The phase must have at least
    two alive vertices (the loop runs alive − 1 phases after the fold).
    """
    from repro_torch.kernels.ref import mcop_phase_step_plain

    if not 0 <= phase < state.phases:
        raise ValueError(f"phase {phase} is outside the state's {state.phases} phases")
    ctot = float(np.float32(c_local_total))
    dev = state.buffer.device
    if dev.type == "cpu":
        mcop_phase_step_plain(state, phase, ctot)
        return
    if dev.type != "cuda":
        raise ValueError(f"no MCOP kernel for device {dev}")
    lib = _library("mcop_phase")
    with torch.cuda.device(dev):
        err = lib.repro_torch_phase_step(
            *state.pointers, state.n, phase, ctot, _ROWS[rows], int(state.full),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise KernelError(
            f"mcop_phase step kernel launch refused (CUDA error {err}; n={state.n})")
    LAUNCHES["mcop_phase_kernel"] += 1
