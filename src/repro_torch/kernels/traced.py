"""The model kernels traced by shape: B4, B4-bwd, B5 and B5-bwd as
``torch.library`` custom ops that only a fake tensor reaches.

The dry run (``launch.dryrun``) runs a cell's step on DTensors whose local
shards are ``FakeTensorMode`` tensors: shapes and dtypes, no storage.  A
kernel wrapper given a fake CUDA tensor cannot launch (there is no memory
to hand the kernel), so it calls the op here instead; the op's fake
implementation returns outputs of the kernel's shapes, dtypes and strides,
and its FLOP formula (``torch.utils.flop_counter``) is the count that
PERF.md's bound for the kernel uses.  Nothing else calls these ops: a real
CUDA tensor still launches the kernel (or raises ``KernelError``) and a
CPU tensor, fake or not, still takes the plain version.  A real tensor
that reaches an op raises ``KernelError``.  No launch counter moves.

B1-B3 (the MCOP solves) lie on no dry-run cell and have no op here.
"""

from __future__ import annotations

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.build import KernelError
from repro_torch.kernels.ref import attention_output_like

__all__ = [
    "KERNEL_OPS",
    "attention_pairs",
    "flash_attention",
    "flash_attention_bwd",
    "is_fake",
    "mamba_scan",
    "mamba_scan_bwd",
]


def is_fake(t: torch.Tensor) -> bool:
    """``t`` is a ``FakeTensorMode`` tensor (shapes only, no storage)."""
    return isinstance(t, FakeTensor)


def _refuse(name: str):
    raise KernelError(f"{name} is traced by shape only; a real tensor launches the kernel")


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                    window: int | None, scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """B4 by shape: ``(out (B, H, Sq, hd_v) in q's dtype, L (B, H, Sq) f32)``."""
    _refuse("flash_attention")


@flash_attention.register_fake
def _(q, k, v, causal, window, scale):
    b, h, sq, _ = q.shape
    return (attention_output_like(q, v.shape[3]),
            q.new_empty((b, h, sq), dtype=torch.float32))


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=())
def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                        dout: torch.Tensor, lse: torch.Tensor, causal: bool,
                        window: int | None, scale: float
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B4-bwd by shape: ``(dq, dk, dv)``, each like its input."""
    _refuse("flash_attention_bwd")


@flash_attention_bwd.register_fake
def _(q, k, v, out, dout, lse, causal, window, scale):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


@torch.library.custom_op("repro_torch::mamba_scan", mutates_args=())
def mamba_scan(x: torch.Tensor, dt: torch.Tensor, ld: torch.Tensor, bm: torch.Tensor,
               cm: torch.Tensor, h0: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B5 by shape: ``(y like x, h like h0, the state entering each chunk
    (B, H, NC, P, N) f32)``."""
    _refuse("mamba_scan")


@mamba_scan.register_fake
def _(x, dt, ld, bm, cm, h0):
    b, h, nc, _, p = x.shape
    return (torch.empty_like(x), torch.empty_like(h0),
            x.new_empty((b, h, nc, p, bm.shape[-1]), dtype=torch.float32))


@torch.library.custom_op("repro_torch::mamba_scan_bwd", mutates_args=())
def mamba_scan_bwd(x: torch.Tensor, dt: torch.Tensor, ld: torch.Tensor, bm: torch.Tensor,
                   cm: torch.Tensor, states: torch.Tensor, dy: torch.Tensor, dh: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor, torch.Tensor]:
    """B5-bwd by shape: ``(dx, ddt, dld, dbm, dcm, dh0)``, contiguous f32."""
    _refuse("mamba_scan_bwd")


@mamba_scan_bwd.register_fake
def _(x, dt, ld, bm, cm, states, dy, dh):
    return tuple(torch.empty(t.shape, dtype=torch.float32, device=t.device)
                 for t in (x, dt, ld, bm, cm, dh))


def attention_pairs(sq: int, sk: int, causal: bool, window: int | None) -> int:
    """(query, key) pairs the masks leave, per (batch, head): key ``j`` is
    seen by query ``i`` iff ``j <= i`` (causal) and ``j > i - window``."""
    i = np.arange(sq, dtype=np.int64)
    hi = np.minimum(sk, i + 1) if causal else np.full(sq, sk)
    lo = np.maximum(0, i - window + 1) if window is not None else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo, 0).sum())


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_flops(q, k, v, causal, window, scale, *, out_shape=None, **kw) -> int:
    # S = q k^T (hd) and P v (hd_v), a visible pair
    b, h, sq, hd = q
    return 2 * (hd + v[3]) * attention_pairs(sq, k[2], causal, window) * b * h


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def _flash_bwd_flops(q, k, v, out, dout, lse, causal, window, scale, *, out_shape=None,
                     **kw) -> int:
    # S again (hd), dP = dout v^T (hd_v), dv (hd_v), dq and dk (hd each)
    b, h, sq, hd = q
    return 2 * (3 * hd + 2 * v[3]) * attention_pairs(sq, k[2], causal, window) * b * h


@register_flop_formula(torch.ops.repro_torch.mamba_scan)
def _mamba_flops(x, dt, ld, bm, cm, h0, *, out_shape=None, **kw) -> int:
    # C B^T once per (batch, chunk); per (batch, head, chunk) the triangular
    # W x product, the C h^T read-out and the state update
    b, h, nc, q, p = x
    n, pairs = bm[-1], q * (q + 1) // 2
    return 2 * b * nc * pairs * n + 2 * b * h * nc * (pairs * p + 2 * q * p * n)


@register_flop_formula(torch.ops.repro_torch.mamba_scan_bwd)
def _mamba_bwd_flops(x, dt, ld, bm, cm, states, dy, dh, *, out_shape=None, **kw) -> int:
    # C B^T once per (batch, chunk); per (batch, head, chunk) four triangular
    # products and five state products
    b, h, nc, q, p = x
    n, pairs = bm[-1], q * (q + 1) // 2
    return 2 * b * nc * pairs * n + 2 * b * h * nc * (pairs * (2 * p + 2 * n) + 5 * q * p * n)


# the ops by the smoke's kernel names
KERNEL_OPS = {
    "flash_attention_kernel": torch.ops.repro_torch.flash_attention.default,
    "flash_attention_bwd_kernel": torch.ops.repro_torch.flash_attention_bwd.default,
    "mamba_chunk_scan_kernel": torch.ops.repro_torch.mamba_scan.default,
    "mamba_chunk_scan_bwd_kernel": torch.ops.repro_torch.mamba_scan_bwd.default,
}
