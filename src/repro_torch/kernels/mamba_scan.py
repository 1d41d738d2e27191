"""Mamba2 SSD chunked scan for an NVIDIA GPU (``csrc/mamba_scan.cu``), with
its plain PyTorch version.

:func:`mamba_chunk_scan_kernel` is the counterpart of the JAX package's
Pallas kernel of the same name.  Where the TPU kernel walks the chunks of
one (batch, head) in order with the ``P × N`` state kept on chip, the CUDA
version is four chunk-parallel passes (``C·Bᵀ`` once per (batch, chunk);
each chunk's own state contribution; the carry of the state across chunks;
the output), with every product on the tensor cores as 3xTF32.  One call of
the wrapper launches the four passes and counts once in ``LAUNCHES``.
``x``, ``dt``, ``ld``, ``Bm`` and ``Cm`` may be views (the kernel takes
their strides; the last dim of ``x``, ``Bm`` and ``Cm`` contiguous), so the
model's step-major ``(B, S, H, P)`` tensors go in without head-major copies.
A CUDA tensor launches the kernel or raises ``kernels.build.KernelError``;
a CPU tensor runs :func:`~repro_torch.kernels.ref.mamba_chunk_scan_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import KernelError
from repro_torch.kernels.mcop_phase import _require
from repro_torch.kernels.ref import mamba_chunk_scan_plain

__all__ = [
    "mamba_chunk_scan_kernel",
    "mamba_chunk_scan_plain",
    "MAMBA_MAX_CHUNK",
    "MAMBA_MAX_WIDTH",
    "LAUNCHES",
    "reset_launches",
]

# the kernel's own limits (csrc/mamba_scan.cu: a chunk's cumsum is one warp
# of 8 steps a lane; head width P and state width N are padded to one
# 64-wide tile)
MAMBA_MAX_CHUNK = 256
MAMBA_MAX_WIDTH = 64

# calls that launched the kernel since the last reset_launches(); the wrapper
# adds one exactly where it launches the four passes, and nowhere else
LAUNCHES = {"mamba_chunk_scan_kernel": 0}


def reset_launches() -> None:
    LAUNCHES["mamba_chunk_scan_kernel"] = 0


def _library():
    from repro_torch.kernels import build

    lib = build.load("mamba_scan")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.repro_torch_mamba_scan.argtypes = (
        [P] * 11 + [I] * 7 + [ctypes.POINTER(ctypes.c_longlong), P])
    return lib  # restype: ctypes' default c_int, the CUDA error code


def mamba_chunk_scan_kernel(
    x: torch.Tensor,    # (B, H, NC, Q, P) f32
    dt: torch.Tensor,   # (B, H, NC, Q)    f32
    ld: torch.Tensor,   # (B, H, NC, Q)    f32, log decay dt·a
    bm: torch.Tensor,   # (B, NC, Q, N)    f32
    cm: torch.Tensor,   # (B, NC, Q, N)    f32
    h0: torch.Tensor,   # (B, H, P, N)     f32
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked scan on the inputs' device: ``(y (B, H, NC, Q, P), h (B, H,
    P, N))``, float32.  Inputs are float32; ``h0`` is contiguous, ``x``,
    ``bm`` and ``cm`` have a contiguous last dim, ``dt`` and ``ld`` any
    strides.  ``y`` has x's strides where x is dense.  On a CUDA tensor
    ``Q <= MAMBA_MAX_CHUNK`` and ``P, N <= MAMBA_MAX_WIDTH``."""
    if x.ndim != 5 or bm.ndim != 4:
        raise ValueError(f"expected x (B,H,NC,Q,P) and bm (B,NC,Q,N), got "
                         f"{tuple(x.shape)}, {tuple(bm.shape)}")
    b, h, nc, q, p = (int(d) for d in x.shape)
    n = int(bm.shape[-1])
    dev = x.device
    f32 = torch.float32
    _require(x, "x", (b, h, nc, q, p), f32, dev, layout="rows")
    _require(dt, "dt", (b, h, nc, q), f32, dev, layout="any")
    _require(ld, "ld", (b, h, nc, q), f32, dev, layout="any")
    _require(bm, "bm", (b, nc, q, n), f32, dev, layout="rows")
    _require(cm, "cm", (b, nc, q, n), f32, dev, layout="rows")
    _require(h0, "h0", (b, h, p, n), f32, dev)
    if dev.type == "cpu":
        return mamba_chunk_scan_plain(x, dt, ld, bm, cm, h0)
    if dev.type != "cuda":
        raise ValueError(f"no Mamba scan kernel for device {dev}")
    if not (1 <= q <= MAMBA_MAX_CHUNK and p <= MAMBA_MAX_WIDTH and n <= MAMBA_MAX_WIDTH):
        raise ValueError(
            f"mamba_chunk_scan_kernel takes Q <= {MAMBA_MAX_CHUNK} and P, N <= "
            f"{MAMBA_MAX_WIDTH}, got Q={q}, P={p}, N={n}"
        )
    y = torch.empty_like(x)
    h_out = torch.empty_like(h0)
    if b * h * nc == 0:
        return y, h_out
    # scratch of the passes: C·Bᵀ per (batch, chunk) in 64-step tiles, the
    # per-chunk states (S_c, then the state entering chunk c), cum_end
    qg = -(-q // 64) * 64
    gram = torch.empty((b, nc, qg, qg), dtype=f32, device=dev)
    states = torch.empty((b, h, nc, p, n), dtype=f32, device=dev)
    cum_end = torch.empty((b, nc, h), dtype=f32, device=dev)
    vec4 = p % 4 == 0 and n % 4 == 0 and all(
        t.data_ptr() % 16 == 0 and all(st % 4 == 0 for st in t.stride()[:-1])
        for t in (x, bm, cm))
    strides = (ctypes.c_longlong * 22)(
        *x.stride()[:4], *dt.stride(), *ld.stride(), *bm.stride()[:3],
        *cm.stride()[:3], *y.stride()[:4])
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.repro_torch_mamba_scan(
            x.data_ptr(), dt.data_ptr(), ld.data_ptr(), bm.data_ptr(),
            cm.data_ptr(), h0.data_ptr(), y.data_ptr(), h_out.data_ptr(),
            gram.data_ptr(), states.data_ptr(), cum_end.data_ptr(),
            b, h, nc, q, p, n, int(vec4), strides,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise KernelError(
            f"mamba_scan kernel launch refused (CUDA error {err}; "
            f"x={tuple(x.shape)}, N={n})"
        )
    LAUNCHES["mamba_chunk_scan_kernel"] += 1
    return y, h_out
