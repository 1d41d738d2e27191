"""MCOP kernels for an NVIDIA GPU, with their plain PyTorch versions.

Two kernels solve the full modified Stoer–Wagner of the paper's
Algorithms 1–3 batched over graphs, one thread block per graph:

* :func:`mcop_stoer_wagner_kernel` (``csrc/mcop_sw.cu``) — solves a batch
  of ``(B, n, n)`` adjacencies held in device memory.  Counterpart of the
  JAX package's Pallas kernel of the same name.
* :func:`mcop_fused_solve_kernel` (``csrc/mcop_fused.cu``) — builds each
  environment's Eq. 4/6/8 weights from the application profile inside the
  block and solves at once; per graph six floats come in and ``1 + n`` go
  out, and the ``(K, n, n)`` batch never exists in device memory.

A third runs a single MinCutPhase (Algorithm 3) per launch, for the host
loop of ``kernels.ops.mcop_min_cut``:

* :func:`mcop_phase_kernel` (``csrc/mcop_phase.cu``) — one phase on an
  ``(n, n)`` adjacency left in device memory; returns ``(cut, s, t)``.
  Counterpart of the JAX package's Pallas kernel of the same name.
  :func:`mcop_phase_packed` launches it and returns the three results
  in one buffer, for a host loop that reads them back in one copy.

Beside each stands its plain version (:func:`stoer_wagner_plain`,
:func:`fused_solve_plain`, ``kernels.ref.mcop_phase_plain``): the same
function as tensor code, the two solves batched with fixed loop bounds and
lane masks and no host synchronisation inside the loops.  A wrapper takes
the plain version **only** for tensors that lie on
the CPU; on a CUDA tensor it launches the kernel or raises
``kernels.build.KernelError`` — there is no switch and no ``try`` between
them.  ``LAUNCHES`` counts kernel launches.

Semantics shared by all four (and by ``core.mcop.mcop_reference``): the
anchor is the first pinned vertex (vertex 0 if none), every other pinned
vertex is folded into it, ties in the most-tightly-connected-vertex scan
go to the lowest index, a cut improves only on strict ``<``, and padded
vertices are encoded pinned with zero weights and zero edges.  Arithmetic
is float32; sums are taken in different orders by the kernels and the
plain versions, so cuts agree to rounding, not bitwise.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import KernelError

__all__ = [
    "KernelError",
    "mcop_stoer_wagner_kernel",
    "mcop_fused_solve_kernel",
    "mcop_phase_kernel",
    "mcop_phase_packed",
    "phase_result",
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
# (16, 64, 256, then 64-aligned sizes).  Above roughly 235 vertices the working
# adjacency no longer fits a block's shared memory and lives in scratch.
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
    adj = adj * keep[:, :, None] * keep[:, None, :]
    add = fold * keep
    adj[rows, src, :] += add
    adj[rows, :, src] += add
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

        # Algorithm 1: merge t into s, in place, on the lanes that merge.
        do_merge = valid & (s_reg != t_reg)
        dm = do_merge[:, None]
        t_add = torch.where(dm, t_row, zero)
        adj[rows, s_reg, :] += t_add
        adj[rows, :, s_reg] += t_add
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
        lib.repro_torch_sw_plan.argtypes = [_I, ctypes.POINTER(_I)]
        lib.repro_torch_sw_solve.argtypes = [_P] * 7 + [_I] * 6 + [_P]
    elif name == "mcop_phase":
        lib.repro_torch_phase_solve.argtypes = (
            [_P] * 3 + [_I, ctypes.c_float, _I, _I, _P, _P]
        )
    else:
        lib.repro_torch_fused_plan.argtypes = [_I, ctypes.POINTER(_I)]
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


def _plan(plan_fn, n: int, batch: int, device) -> tuple[int, int, int, int, torch.Tensor]:
    """Launch geometry and the per-block scratch adjacency (if needed).

    The scratch is freed when the wrapper returns, possibly before the
    kernel ends; PyTorch's allocator hands the block only to later work on
    the same stream, which runs after the kernel."""
    out = (_I * 4)()
    err = plan_fn(n, out)
    if err != 0:
        raise KernelError(f"CUDA error {err} while planning an n={n} MCOP solve")
    threads, in_smem, smem_bytes, resident = (int(x) for x in out)
    grid = max(1, min(batch, resident))
    scratch = torch.empty(
        (0 if in_smem else grid * n * n,), dtype=torch.float32, device=device
    )
    return grid, threads, in_smem, smem_bytes, scratch


def mcop_stoer_wagner_kernel(
    adj: torch.Tensor,      # (B, n, n) f32 — a batch of WCG adjacencies
    w_local: torch.Tensor,  # (B, n) f32
    w_cloud: torch.Tensor,  # (B, n) f32
    pinned: torch.Tensor,   # (B, n) bool — True = unoffloadable or padding
) -> tuple[torch.Tensor, torch.Tensor]:
    """Solve a batch of MCOP instances on the inputs' device.

    CUDA tensors launch ``csrc/mcop_sw.cu`` on the current stream (no
    synchronisation; outputs and scratch come from ``torch.empty``); CPU
    tensors run :func:`stoer_wagner_plain`.  Returns ``(min_cuts (B,)
    f32, local_masks (B, n) bool)``.  Dead/padded vertices must be
    encoded as pinned with zero weights and zero incident edges.
    Raises ``ValueError`` for ``n > SW_MAX_N``.
    """
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
        grid, threads, in_smem, smem_bytes, scratch = _plan(
            lib.repro_torch_sw_plan, n, b, dev
        )
        err = lib.repro_torch_sw_solve(
            adj.data_ptr(), w_local.data_ptr(), w_cloud.data_ptr(),
            pinned.data_ptr(), cuts.data_ptr(), masks.data_ptr(),
            scratch.data_ptr(), b, n, grid, threads, in_smem, smem_bytes,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise KernelError(
            f"mcop_sw kernel launch refused (CUDA error {err}; B={b}, n={n}, "
            f"grid={grid}, threads={threads}, smem={smem_bytes})"
        )
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
        grid, threads, in_smem, smem_bytes, scratch = _plan(
            lib.repro_torch_fused_plan, n, k, dev
        )
        err = lib.repro_torch_fused_solve(
            t_local.data_ptr(), data_in.data_ptr(), data_out.data_ptr(),
            pinned.data_ptr(), env.data_ptr(), cuts.data_ptr(), masks.data_ptr(),
            scratch.data_ptr(), k, n, FUSED_MODEL_KINDS.index(kind), float(omega),
            grid, threads, in_smem, smem_bytes,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise KernelError(
            f"mcop_fused kernel launch refused (CUDA error {err}; K={k}, n={n}, "
            f"grid={grid}, threads={threads}, smem={smem_bytes})"
        )
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
    synchronising; a CPU ``adj`` runs ``kernels.ref.mcop_phase_plain``.
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
    threads = min(256, max(32, (n + 31) // 32 * 32))
    with torch.cuda.device(dev):
        err = lib.repro_torch_phase_solve(
            adj.data_ptr(), gains.data_ptr(), alive.data_ptr(), src, ctot, n,
            threads, out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise KernelError(
            f"mcop_phase kernel launch refused (CUDA error {err}; n={n}, "
            f"threads={threads})"
        )
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
