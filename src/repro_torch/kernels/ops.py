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
data axes, heads over ``"model"`` (``_flash_attention_sharded``).
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

__all__ = ["flash_attention", "mamba_chunk_scan", "mcop_min_cut"]


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
    (:func:`_flash_attention_sharded`)."""
    if isinstance(q, DTensor):
        return _flash_attention_sharded(q, k, v, causal=causal, window=window, scale=scale)
    qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if q.device.type == "cuda":
        out = FlashAttentionFn.apply(qh, kh, vh, causal, window, scale)
    else:
        out = flash_attention_kernel(qh, kh, vh, causal=causal, window=window, scale=scale)
    return out.transpose(1, 2)


def _flash_attention_sharded(q: DTensor, k: DTensor, v: DTensor, *, causal: bool,
                             window: int | None, scale: float | None) -> DTensor:
    """:func:`flash_attention` of DTensors, on local shards.

    Attention is independent across the batch and across heads, so a shard
    of whole sequences and whole heads is a smaller call of the same
    function.  q's layout decides: each mesh dimension keeps ``Shard(0)``
    (batch) or ``Shard(2)`` (heads) or is ``Replicate()``; a ``Partial``
    is reduced first.  A sharded sequence or head width is refused: the
    scores of one row would span ranks.  k and v are brought to q's
    layout.  Query heads shard in contiguous blocks, and so do the kv heads,
    so GQA's head ``h`` → kv head ``h // rep`` holds on each shard by local
    index as long as the head-sharding axes divide the kv heads; otherwise
    it is refused (a kv head split across ranks)."""
    mesh = q.device_mesh
    heads, kv_heads = q.shape[2], k.shape[2]
    layout, split = [], 1
    for i, p in enumerate(q.placements):
        if isinstance(p, Partial):
            p = Replicate()
        elif isinstance(p, Shard) and p.dim not in (0, 2):
            raise ValueError(
                f"flash_attention: q's dimension {p.dim} (the sequence or head width) is "
                f"sharded over {mesh.mesh_dim_names[i]!r}; gather it first")
        elif isinstance(p, Shard) and p.dim == 2:
            split *= mesh.size(i)
        layout.append(p)
    if heads % split or kv_heads % split:
        raise ValueError(f"flash_attention: {heads} query and {kv_heads} kv heads do not "
                         f"split into {split} shards of whole GQA groups")
    layout = tuple(layout)
    q, k, v = (t.redistribute(mesh, layout) for t in (q, k, v))

    def local(ql, kl, vl):
        return (flash_attention(ql, kl, vl, causal=causal, window=window, scale=scale),)

    return local_map(local, out_placements=(layout,), in_placements=(layout, layout, layout),
                     device_mesh=mesh)(q, k, v)[0]


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
    a multiple of ``min(chunk, S)``."""
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
