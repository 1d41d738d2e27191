"""The kernels as their callers use them.

The model code keeps its ``(B, S, H, hd)`` layout; the first two functions
hand the kernels head-major *views* of it (the kernels take strides), so
the only copy made there is the scan's cast to float32.  Each runs on its
inputs' device: the kernel on a CUDA tensor, its plain version on a CPU
tensor (see the kernel modules).

``flash_attention``   — ``models.attention.chunked_attention`` is this.
``mamba_chunk_scan``  — the scan core of ``models.ssm.mamba2_forward``.
``mcop_min_cut``      — MCOP with one phase-kernel launch per MinCutPhase
                        and the Algorithm-1 merges between them.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.flash_attention import flash_attention_kernel
from repro_torch.kernels.mamba_scan import mamba_chunk_scan_kernel
from repro_torch.kernels.mcop_phase import mcop_phase_packed, phase_result, require_device

__all__ = ["flash_attention", "mamba_chunk_scan", "mcop_min_cut"]


def flash_attention(
    q: torch.Tensor,   # (B, S, H, hd) — model layout
    k: torch.Tensor,   # (B, S, Hkv, hd)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Returns (B, Sq, H, hd) in q's dtype (contiguous when q is)."""
    out = flash_attention_kernel(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, window=window, scale=scale,
    )
    return out.transpose(1, 2)


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
    y, h_final = mamba_chunk_scan_kernel(
        x.to(f32).reshape(b, nc, q, h, p).permute(0, 3, 1, 2, 4),
        dt.to(f32).reshape(b, nc, q, h).permute(0, 3, 1, 2),
        ld.to(f32).reshape(b, nc, q, h).permute(0, 3, 1, 2),
        bm.to(f32).reshape(b, nc, q, n),
        cm.to(f32).reshape(b, nc, q, n),
        h0.to(f32).contiguous(),
    )
    return y.permute(0, 2, 3, 1, 4).reshape(b, s, h, p), h_final


def mcop_min_cut(
    adj: np.ndarray,
    w_local: np.ndarray,
    w_cloud: np.ndarray,
    offloadable: np.ndarray,
    *,
    device: str | torch.device = "cuda",
) -> tuple[float, np.ndarray]:
    """MCOP with each MinCutPhase on ``device``: one
    :func:`~repro_torch.kernels.mcop_phase.mcop_phase_kernel` launch per
    phase.  Returns ``(min_cut, local_mask over the original vertices)``.

    The same loop as the JAX package's ``kernels.ops.mcop_min_cut``: the
    pinned vertices are folded into the first of them (the anchor; vertex
    0 if none), then while more than one vertex is alive a phase yields
    ``(cut, s, t)``, a strictly smaller cut takes ``t``'s members as the
    cloud side, and ``t`` is merged into ``s`` (the anchor follows a merged
    source).  The adjacency is uploaded once and merged in place on the
    device, the pinned fold included, in the reference's order and f32
    arithmetic (row add, column add, ``adj[s, s] = 0``, row and column
    ``t`` zeroed); per phase only the gains go up and ``(cut, s, t)`` come
    back.  ``device="cpu"`` runs the
    same loop on the plain version; the default needs a GPU and raises
    ``KernelError`` without one.
    """
    dev = require_device(device)
    w_local = np.array(w_local, np.float32)
    w_cloud = np.array(w_cloud, np.float32)
    n = w_local.shape[0]
    adj_d = torch.from_numpy(np.array(adj, np.float32)).to(dev)
    alive_d = torch.ones(n, dtype=torch.bool, device=dev)
    alive = np.ones(n, bool)
    label = np.arange(n)  # the surviving vertex each original vertex merged into
    c_total = float(w_local.sum())

    def merge(s: int, t: int) -> None:
        adj_d[s, :] += adj_d[t, :]
        adj_d[:, s] += adj_d[:, t]
        adj_d[s, s] = 0.0
        adj_d[t, :] = 0.0
        adj_d[:, t] = 0.0
        alive_d[t] = False
        w_local[s] += w_local[t]
        w_cloud[s] += w_cloud[t]
        label[label == t] = s
        alive[t] = False

    # fold the unoffloadable vertices into the anchor
    pinned = np.nonzero(~np.asarray(offloadable, bool))[0]
    src = int(pinned[0]) if pinned.size else 0
    for other in pinned[1:]:
        merge(src, int(other))

    best_cut, best_cloud = np.inf, np.zeros(n, bool)
    while alive.sum() > 1:
        gains = torch.from_numpy(w_local - w_cloud).to(dev)
        cut, s, t = phase_result(mcop_phase_packed(adj_d, gains, alive_d, src, c_total))
        if cut < best_cut:
            best_cut = cut
            best_cloud = label == t
        if s == t:  # degenerate single-alive-vertex phase
            break
        merge(s, t)
        if t == src:
            src = s
    return best_cut, ~best_cloud
