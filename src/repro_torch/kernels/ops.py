"""The kernels as their callers use them.

The model code keeps its ``(B, S, H, hd)`` layout; the first two functions
hand the kernels head-major *views* of it (the kernels take strides), so
the only copy made there is the scan's cast to float32.  Each runs on its
inputs' device: the kernel on a CUDA tensor, its plain version on a CPU
tensor (see the kernel modules).  Both are differentiable: on a CUDA tensor
through an ``autograd.Function`` whose backward is the kernel's backward
kernel (``FlashAttentionFn``, ``MambaScanFn``), on a CPU tensor through
autograd of the plain version.

``flash_attention``   — ``models.attention.chunked_attention`` is this.
``mamba_chunk_scan``  — the scan core of ``models.ssm.mamba2_forward``.
``mcop_min_cut``      — MCOP with one phase-kernel launch per MinCutPhase,
                        each merging after its phase on the card.

A DTensor q/k/v (a model whose parameters ``runtime.sharding`` placed on a
mesh) runs ``flash_attention`` on each rank's own shard: batch over the
data axes, heads over ``"model"`` (``sharded_attention``, which the naive
core of ``models.attention`` takes too); so does
a DTensor scan (``_mamba_chunk_scan_sharded``), from a state in any
layout.  Their callers: the sharded training step, and the serving cells'
prefill (``launch.specs.build_cell``), whose k/v and final state are then
written into the cache's own layout by ``models.common.cache_write`` /
``cache_set``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.kernels.flash_attention import FlashAttentionFn, flash_attention_kernel
from repro_torch.kernels.mamba_scan import MambaScanFn, mamba_chunk_scan_kernel
from repro_torch.kernels.mcop_phase import (
    PHASE_MAX_N, LoopState, mcop_phase_step, require_device,
)
from repro_torch.models.common import local_shape_offset
from repro_torch.obs import trace

__all__ = ["flash_attention", "gqa_local_kv", "mamba_chunk_scan", "mcop_min_cut",
           "sharded_attention"]


def flash_attention(
    q: torch.Tensor,   # (B, S, H, hd) — model layout
    k: torch.Tensor,   # (B, S, Hkv, hd)
    v: torch.Tensor,   # (B, S, Hkv, hd_v)
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Returns (B, Sq, H, hd_v) in q's dtype (contiguous when q is).

    DTensors run the same call on each rank's local shard
    (:func:`sharded_attention`)."""
    if isinstance(q, DTensor):
        def core(ql, kl, vl):
            return flash_attention(ql, kl, vl, causal=causal, window=window, scale=scale)
        return sharded_attention(core, q, k, v)
    qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if q.device.type == "cuda":
        trace.annotate("model.attention", route="b4")
        out = FlashAttentionFn.apply(qh, kh, vh, causal, window, scale)
    else:
        trace.annotate("model.attention", route="chunked")
        out = flash_attention_kernel(qh, kh, vh, causal=causal, window=window, scale=scale)
    return out.transpose(1, 2)


def sharded_attention(core, q: DTensor, k: DTensor, v: DTensor) -> DTensor:
    """Attention of DTensors (model layout, ``(B, S, H, hd)``), on local
    shards: ``core(ql, kl, vl)`` on each rank's shard of whole sequences
    and whole heads.  ``core`` is :func:`flash_attention` (B4) or
    ``models.attention.naive_attention``, with their options.

    Attention is independent across the batch and across heads, so a shard
    of whole sequences and whole heads is a smaller call of the same
    function.  q's layout decides: each mesh dimension keeps ``Shard(0)``
    (batch) or ``Shard(2)`` (heads) or is ``Replicate()``; a ``Partial``
    is reduced first.  A sharded sequence or head width is refused: the
    scores of one row would span ranks.  Callers: training (B4 above 4096
    tokens, the naive core at or below), and a prefill above 4096 tokens
    into an empty cache (the empty-cache route of ``models.attention``),
    whose fresh k/v it attends before they are written into the
    sequence-sharded cache.

    When the head-sharding axes divide both the query and the kv heads,
    k and v are brought to q's layout: query heads shard in contiguous
    blocks and so do the kv heads, so GQA's head ``h`` -> kv head ``h //
    rep`` holds on each shard by local index.  Otherwise
    (:func:`_attention_gqa_uneven`) q's heads are chunked over those
    axes and over ``"model"`` where q is whole (unevenly, as ``torch.chunk``
    splits them), k and v are replicated over them, and each rank takes the
    kv heads its query heads need by global index."""
    mesh = q.device_mesh
    heads, kv_heads = q.shape[2], k.shape[2]
    layout, split = [], 1
    for i, p in enumerate(q.placements):
        if isinstance(p, Partial):
            p = Replicate()
        elif isinstance(p, Shard) and p.dim not in (0, 2):
            raise ValueError(
                f"attention: q's dimension {p.dim} (the sequence or head width) is "
                f"sharded over {mesh.mesh_dim_names[i]!r}; gather it first")
        elif isinstance(p, Shard) and p.dim == 2:
            split *= mesh.size(i)
        layout.append(p)
    names = mesh.mesh_dim_names or ()
    whole_over_model = ("model" in names and mesh.size(names.index("model")) > 1
                        and layout[names.index("model")] == Replicate())
    if heads % split or kv_heads % split or whole_over_model:
        return _attention_gqa_uneven(core, q, k, v, layout)
    layout = tuple(layout)
    q, k, v = (t.redistribute(mesh, layout) for t in (q, k, v))

    def local(ql, kl, vl):
        return (_dense_core(core, ql, kl, vl),)

    return local_map(local, out_placements=(layout,), in_placements=(layout, layout, layout),
                     device_mesh=mesh)(q, k, v)[0]


def _attention_gqa_uneven(core, q: DTensor, k: DTensor, v: DTensor, layout: list) -> DTensor:
    """GQA whose heads the head-sharding axes do not split into whole groups
    (qwen2-7b's 28 query / 4 kv heads over ``model = 16``).

    q's heads are chunked over the head axes (``torch.chunk``'s uneven
    split: 28 over 16 ranks is 2 a rank on 14 ranks and 0 on the last 2); k
    and v are replicated over them, and their gradients are the sum of the
    ranks' parts (``Partial``).  A rank holding query heads ``h0 .. h1 - 1``
    needs kv heads ``h // rep`` for each: a contiguous range when every kv
    head in it serves the same number of the rank's heads (a view, with
    that number as the local ``rep``), else the heads gathered one per
    query head (``rep`` 1).  A rank with no head launches nothing; its
    output, empty, still depends on its inputs, so that every rank runs the
    same backward."""
    mesh = q.device_mesh
    names = mesh.mesh_dim_names or ()
    q_pl = list(layout)
    if "model" in names and q_pl[names.index("model")] == Replicate():
        q_pl[names.index("model")] = Shard(2)
    q_pl = tuple(q_pl)
    kv_pl = tuple(Replicate() if p == Shard(2) else p for p in q_pl)
    kv_grad = tuple(Partial() if p == Shard(2) else p for p in q_pl)
    heads, kv_heads = q.shape[2], k.shape[2]
    if heads % kv_heads:
        raise ValueError(f"attention: {heads} query heads over {kv_heads} kv heads")
    rep = heads // kv_heads
    q = q.redistribute(mesh, q_pl)
    k, v = k.redistribute(mesh, kv_pl), v.redistribute(mesh, kv_pl)
    local_shape, offset = local_shape_offset(q.shape, mesh, q_pl)
    h0, nh = offset[2], local_shape[2]
    ql = q.to_local()
    kl, vl = k.to_local(grad_placements=kv_grad), v.to_local(grad_placements=kv_grad)
    b, sq = ql.shape[0], ql.shape[1]
    if nh == 0:
        zero = (kl.sum() + vl.sum()) * 0 + ql.sum()
        out = zero.to(ql.dtype).expand(b, sq, 0, vl.shape[-1])
    else:
        kl, vl = gqa_local_kv(kl, vl, h0, nh, rep)
        out = _dense_core(core, ql, kl, vl)
    shape = (q.shape[0], q.shape[1], heads, v.shape[-1])
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(out, mesh, q_pl, run_check=False, shape=torch.Size(shape),
                              stride=stride)


class _DenseGrad(torch.autograd.Function):
    """``t`` itself, its gradient made contiguous."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _dense_core(core, ql, kl, vl):
    """``core`` on local shards, its output and its inputs' gradients
    contiguous: DTensor views a shard as it lies, and a view of a
    transposed shard (the naive core's einsums give them) fails."""
    return core(*(_DenseGrad.apply(t) for t in (ql, kl, vl))).contiguous()


def gqa_local_kv(k: torch.Tensor, v: torch.Tensor, h0: int, nh: int,
                 rep: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The kv heads (model layout, ``(B, S, Hkv, hd)``) that query heads
    ``h0 .. h0 + nh - 1`` of a GQA of ``rep`` query heads a kv head need,
    so that B4 over the local query heads and these reads the same keys:
    a contiguous range when each kv head in it serves the same number of
    the local heads (a view; that number is the local ``rep``), else one kv
    head per query head (``rep`` 1, a copy)."""
    idx = (h0 + np.arange(nh)) // rep
    counts = np.bincount(idx - idx[0])
    if (counts == counts[0]).all():
        sel = slice(int(idx[0]), int(idx[-1]) + 1)
        return k[:, :, sel], v[:, :, sel]
    at = torch.as_tensor(idx, device=k.device)
    return k.index_select(2, at), v.index_select(2, at)


def mamba_chunk_scan(
    x: torch.Tensor,    # (B, S, H, P)
    dt: torch.Tensor,   # (B, S, H)
    ld: torch.Tensor,   # (B, S, H) — log decay dt·a
    bm: torch.Tensor,   # (B, S, N)
    cm: torch.Tensor,   # (B, S, N)
    h0: torch.Tensor,   # (B, H, P, N)
    *,
    chunk: int = 256,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(y (B, S, H, P), h (B, H, P, N))``, float32.  ``S`` must be
    a multiple of ``min(chunk, S)``.

    DTensors run the same call on each rank's local shard
    (:func:`_mamba_chunk_scan_sharded`)."""
    if isinstance(x, DTensor):
        return _mamba_chunk_scan_sharded(x, dt, ld, bm, cm, h0, chunk=chunk)
    b, s, h, p = x.shape
    n = bm.shape[-1]
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"sequence length {s} is not a multiple of the chunk {q}")
    nc = s // q
    f32 = torch.float32
    args = (
        x.to(f32).reshape(b, nc, q, h, p).permute(0, 3, 1, 2, 4),
        dt.to(f32).reshape(b, nc, q, h).permute(0, 3, 1, 2),
        ld.to(f32).reshape(b, nc, q, h).permute(0, 3, 1, 2),
        bm.to(f32).reshape(b, nc, q, n),
        cm.to(f32).reshape(b, nc, q, n),
        h0.to(f32).contiguous(),
    )
    if x.device.type == "cuda":
        y, h_final = MambaScanFn.apply(*args)
    else:
        y, h_final = mamba_chunk_scan_kernel(*args)
    return y.permute(0, 2, 3, 1, 4).reshape(b, s, h, p), h_final


def _mamba_chunk_scan_sharded(x: DTensor, dt: DTensor, ld: DTensor, bm: DTensor,
                              cm: DTensor, h0: DTensor, *, chunk: int):
    """:func:`mamba_chunk_scan` of DTensors, on local shards.

    The scan is independent across the batch and across heads, and every
    head reads all of B and C.  x's layout decides: each mesh dimension
    keeps ``Shard(0)`` (batch) or ``Shard(2)`` (heads) or is
    ``Replicate()``; a sharded sequence or head width is refused (the
    recurrence would span ranks).  dt and the log decay take x's layout, B
    and C are whole over the head axes (their gradient the sum of the
    ranks' heads': ``Partial``), and the states ``h0`` and ``h`` are
    ``(B, H, P, N)`` sharded on H: ``h0`` arrives in any layout (a serving
    prefill passes the cache's, N over ``"model"``) and is brought to it.
    Each rank runs B5 (and B5-bwd) on its batch and heads.  Callers: the
    sharded training step (from zeros) and the serving prefill
    (``models.ssm._mamba2_forward_sharded``, from the cache's state)."""
    mesh = x.device_mesh
    layout = []
    for i, p in enumerate(x.placements):
        if isinstance(p, Partial):
            p = Replicate()
        elif isinstance(p, Shard) and p.dim not in (0, 2):
            raise ValueError(
                f"mamba_chunk_scan: x's dimension {p.dim} (the sequence or head width) is "
                f"sharded over {mesh.mesh_dim_names[i]!r}; gather it first")
        layout.append(p)
    x_pl = tuple(layout)
    bc_pl = tuple(Replicate() if p == Shard(2) else p for p in x_pl)
    bc_grad = tuple(Partial() if p == Shard(2) else p for p in x_pl)
    h_pl = tuple(Shard(1) if p == Shard(2) else p for p in x_pl)

    def local(xl, dtl, ldl, bl, cl, hl):
        return mamba_chunk_scan(xl, dtl, ldl, bl, cl, hl, chunk=chunk)

    args = [t.redistribute(mesh, pl) for t, pl in
            zip((x, dt, ld, bm, cm, h0), (x_pl, x_pl, x_pl, bc_pl, bc_pl, h_pl))]
    return local_map(local, out_placements=(x_pl, h_pl),
                     in_placements=(x_pl, x_pl, x_pl, bc_pl, bc_pl, h_pl),
                     in_grad_placements=(x_pl, x_pl, x_pl, bc_grad, bc_grad, h_pl),
                     device_mesh=mesh)(*args)


def mcop_min_cut(
    adj: np.ndarray,
    w_local: np.ndarray,
    w_cloud: np.ndarray,
    offloadable: np.ndarray,
    *,
    device: str | torch.device = "cuda",
) -> tuple[float, np.ndarray]:
    """MCOP with each MinCutPhase on ``device``: one launch of the phase
    kernel's step (``kernels.mcop_phase.mcop_phase_step``) per phase.
    Returns ``(min_cut, local_mask over the original vertices)``.

    The same loop as the JAX package's ``kernels.ops.mcop_min_cut``.  The
    pinned vertices are folded into the first of them (the anchor; vertex
    0 if none) on the host, in the reference's order and f32 arithmetic;
    that leaves ``alive − 1`` phases, a number known before the first one.
    The folded graph goes to the device once, as the packed upper triangle
    of its matrix with the merged weights, labels and anchor
    (``LoopState``).  Each launch then runs one phase and, in the same
    kernel, everything the host loop did after it: a strictly smaller cut
    takes ``t``'s members as the cloud side, ``t`` is merged into ``s``
    (row and column add, ``adj[s, s] = 0``, row and column ``t`` zeroed,
    in f32), ``wl``/``wc`` follow, and the anchor follows a merged source.
    The host issues the launches and reads nothing back until the end,
    where one copy returns the best cut and its cloud mask.
    ``device="cpu"`` runs the same loop on the plain version of the step;
    the default needs a GPU and raises ``KernelError`` without one.
    ``n <= PHASE_MAX_N``.

    Any ``(n, n)`` adjacency is answered, as by the JAX package's loop: an
    exactly symmetric one with a zero diagonal (what a WCG usually holds)
    goes up as its packed upper triangle; any other (a WCG is symmetric
    only to ``np.allclose``) goes up whole, and each launch reads full rows
    (staged in shared memory up to n = 241, from L2 above) and merges rows
    and columns as the reference does.
    """
    cut, mask, _ = _min_cut_run(adj, w_local, w_cloud, offloadable, device=device)
    return cut, mask


def _min_cut_run(adj, w_local, w_cloud, offloadable, *, device="cuda",
                 rows: str = "staged") -> tuple[float, np.ndarray, LoopState | None]:
    """:func:`mcop_min_cut`, also returning its ``LoopState`` (``None``
    when no phase runs), whose ``read_log()`` gives each phase's
    ``(cut, s, t)`` to the checks and tests; ``rows`` is the step
    kernel's row strategy."""
    state, c_total = _min_cut_state(adj, w_local, w_cloud, offloadable, device=device)
    if state is None:
        return np.inf, np.ones(len(w_local), bool), None
    for phase in range(state.phases):
        mcop_phase_step(state, phase, c_total, rows=rows)
    best_cut, cloud = state.result()
    return best_cut, ~cloud, state


def _min_cut_state(adj, w_local, w_cloud, offloadable, *,
                   device="cuda") -> tuple[LoopState | None, float]:
    """The loop's state on ``device`` after the pinned fold (``None`` when
    it leaves fewer than two vertices) and ``C_local``."""
    dev = require_device(device)
    adj = np.array(adj, np.float32)
    w_local = np.array(w_local, np.float32)
    w_cloud = np.array(w_cloud, np.float32)
    n = w_local.shape[0]
    if adj.shape != (n, n):
        raise ValueError(f"adj must be ({n}, {n}), got {adj.shape}")
    if n > PHASE_MAX_N:
        raise ValueError(
            f"mcop_phase_kernel takes graphs of at most {PHASE_MAX_N} vertices, got n={n}")
    # the packed layout holds the upper triangle only
    full = not (np.array_equal(adj, adj.T) and not np.diag(adj).any())
    alive = np.ones(n, bool)
    label = np.arange(n, dtype=np.int32)  # the surviving vertex each original vertex merged into
    c_total = float(w_local.sum())

    # fold the unoffloadable vertices into the anchor: the reference's merges
    pinned = np.nonzero(~np.asarray(offloadable, bool))[0]
    src = int(pinned[0]) if pinned.size else 0
    for t in pinned[1:]:
        adj[src, :] += adj[t, :]
        adj[:, src] += adj[:, t]
        adj[src, src] = 0.0
        adj[t, :] = 0.0
        adj[:, t] = 0.0
        w_local[src] += w_local[t]
        w_cloud[src] += w_cloud[t]
        label[label == t] = src
        alive[t] = False

    phases = int(alive.sum()) - 1
    if phases < 1:
        return None, c_total
    state = LoopState(adj, w_local, w_cloud, alive, label, src, phases, dev, full=full)
    return state, c_total
