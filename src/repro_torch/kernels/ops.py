"""The attention and Mamba2-scan kernels in the model's layout.

The model code keeps its ``(B, S, H, hd)`` layout; these functions hand
the kernels head-major *views* of it (the kernels take strides), so the
only copy made here is the scan's cast to float32.  Each runs on its
inputs' device: the kernel on a CUDA tensor, its plain version on a CPU
tensor (see the kernel modules).

``flash_attention``   — ``models.attention.chunked_attention`` is this.
``mamba_chunk_scan``  — the scan core of ``models.ssm.mamba2_forward``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention_kernel
from repro_torch.kernels.mamba_scan import mamba_chunk_scan_kernel

__all__ = ["flash_attention", "mamba_chunk_scan"]


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
