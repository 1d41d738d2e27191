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
a CPU tensor runs :func:`~repro_torch.kernels.ref.mamba_chunk_scan_plain`;
a fake CUDA tensor (the dry run's) takes the kernel by shape
(``kernels.traced``) and launches nothing.

:func:`mamba_chunk_scan_bwd_kernel` is the backward (``csrc/mamba_scan_bwd.cu``,
no TPU counterpart: the JAX package autodiffs its ``lax.scan`` over
chunks): the gradients of ``x``, ``dt``, ``ld``, ``Bm``, ``Cm`` and ``h0``
from the inputs, the forward's states entering each chunk and the output
gradients, every product on the tensor cores as 3xTF32 like the forward's,
deterministic (no atomics); six launches a call (``C·Bᵀ`` once per (batch,
chunk); each chunk's part of the state gradient; its reverse carry; one
pass per (batch, chunk, step tile) that walks the heads in order; d ld;
dCm), counted once in ``BWD_LAUNCHES``.
A CPU tensor takes autograd through the plain version
(:func:`~repro_torch.kernels.ref.mamba_chunk_scan_bwd_plain`).
:class:`MambaScanFn` joins the two (the forward keeps its states scratch
for the backward); ``kernels.ops.mamba_chunk_scan`` applies it to CUDA
tensors.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import KernelError
from repro_torch.kernels import traced
from repro_torch.kernels.mcop_phase import _require
from repro_torch.kernels.ref import mamba_chunk_scan_bwd_plain, mamba_chunk_scan_plain

__all__ = [
    "MambaScanFn",
    "mamba_chunk_scan_kernel",
    "mamba_chunk_scan_bwd_kernel",
    "mamba_chunk_scan_bwd_plain",
    "mamba_chunk_scan_plain",
    "BWD_LAUNCHES",
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
# calls of the backward kernel (six launches each), counted the same way
BWD_LAUNCHES = {"mamba_chunk_scan_bwd_kernel": 0}


def reset_launches() -> None:
    LAUNCHES["mamba_chunk_scan_kernel"] = 0
    BWD_LAUNCHES["mamba_chunk_scan_bwd_kernel"] = 0


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
    y, h_out, _ = _scan(x, dt, ld, bm, cm, h0)
    return y, h_out


def _scan(x, dt, ld, bm, cm, h0):
    """:func:`mamba_chunk_scan_kernel`, also returning the state entering
    each chunk ``(B, H, NC, P, N)`` (the kernel's scratch; ``None`` on the
    CPU)."""
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
        return (*mamba_chunk_scan_plain(x, dt, ld, bm, cm, h0), None)
    if dev.type != "cuda":
        raise ValueError(f"no Mamba scan kernel for device {dev}")
    if not (1 <= q <= MAMBA_MAX_CHUNK and p <= MAMBA_MAX_WIDTH and n <= MAMBA_MAX_WIDTH):
        raise ValueError(
            f"mamba_chunk_scan_kernel takes Q <= {MAMBA_MAX_CHUNK} and P, N <= "
            f"{MAMBA_MAX_WIDTH}, got Q={q}, P={p}, N={n}"
        )
    if traced.is_fake(x):   # the dry run: the kernel by shape, nothing launched
        return traced.mamba_scan(x, dt, ld, bm, cm, h0)
    y = torch.empty_like(x)
    h_out = torch.empty_like(h0)
    if b * h * nc == 0:
        return y, h_out, torch.empty((b, h, nc, p, n), dtype=f32, device=dev)
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
    return y, h_out, states


def _bwd_library():
    from repro_torch.kernels import build

    lib = build.load("mamba_scan_bwd")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.repro_torch_mamba_scan_bwd.argtypes = (
        [P] * 21 + [I] * 7 + [ctypes.POINTER(ctypes.c_longlong), P])
    return lib  # restype: ctypes' default c_int, the CUDA error code


def mamba_chunk_scan_bwd_kernel(
    x: torch.Tensor,       # (B, H, NC, Q, P) f32
    dt: torch.Tensor,      # (B, H, NC, Q)    f32
    ld: torch.Tensor,      # (B, H, NC, Q)    f32
    bm: torch.Tensor,      # (B, NC, Q, N)    f32
    cm: torch.Tensor,      # (B, NC, Q, N)    f32
    states: torch.Tensor,  # (B, H, NC, P, N) f32: the state entering each chunk
    dy: torch.Tensor,      # (B, H, NC, Q, P) f32: the gradient of y
    dh: torch.Tensor | None = None,  # (B, H, P, N): of the final state (None: 0)
) -> tuple[torch.Tensor, ...]:
    """``(dx, ddt, dld, dbm, dcm, dh0)`` of :func:`mamba_chunk_scan_kernel`'s
    function on the inputs' device, contiguous float32.  ``states[:, :, 0]``
    is ``h0``; the forward's scratch gives the rest (on the CPU only
    ``h0`` is read).  Same layouts and limits as the forward; ``dy`` in
    any layout (copied to contiguous rows where its last dim is not)."""
    b, h, nc, q, p = (int(d) for d in x.shape)
    n = int(bm.shape[-1])
    dev = x.device
    f32 = torch.float32
    dy = dy if dy.shape[-1] <= 1 or dy.stride(-1) == 1 else dy.contiguous()
    dh = torch.zeros((b, h, p, n), dtype=f32, device=dev) if dh is None else dh.contiguous()
    _require(x, "x", (b, h, nc, q, p), f32, dev, layout="rows")
    _require(dt, "dt", (b, h, nc, q), f32, dev, layout="any")
    _require(ld, "ld", (b, h, nc, q), f32, dev, layout="any")
    _require(bm, "bm", (b, nc, q, n), f32, dev, layout="rows")
    _require(cm, "cm", (b, nc, q, n), f32, dev, layout="rows")
    _require(states, "states", (b, h, nc, p, n), f32, dev, layout="any")
    _require(dy, "dy", (b, h, nc, q, p), f32, dev, layout="rows")
    _require(dh, "dh", (b, h, p, n), f32, dev)
    if dev.type == "cpu":
        return mamba_chunk_scan_bwd_plain(x, dt, ld, bm, cm, states[:, :, 0], dy, dh)
    if dev.type != "cuda":
        raise ValueError(f"no Mamba scan backward kernel for device {dev}")
    if not (1 <= q <= MAMBA_MAX_CHUNK and p <= MAMBA_MAX_WIDTH and n <= MAMBA_MAX_WIDTH):
        raise ValueError(
            f"mamba_chunk_scan_bwd_kernel takes Q <= {MAMBA_MAX_CHUNK} and P, N <= "
            f"{MAMBA_MAX_WIDTH}, got Q={q}, P={p}, N={n}"
        )
    if traced.is_fake(x):   # the dry run: the kernel by shape, nothing launched
        return traced.mamba_scan_bwd(x, dt, ld, bm, cm, states, dy, dh)
    states = states.contiguous()
    outs = (torch.empty((b, h, nc, q, p), dtype=f32, device=dev),
            torch.empty((b, h, nc, q), dtype=f32, device=dev),
            torch.empty((b, h, nc, q), dtype=f32, device=dev),
            torch.empty((b, nc, q, n), dtype=f32, device=dev),
            torch.empty((b, nc, q, n), dtype=f32, device=dev),
            torch.empty((b, h, p, n), dtype=f32, device=dev))
    if b * h == 0:
        return outs
    # scratch: C·Bᵀ in 64-step tiles, the state gradient leaving each chunk,
    # cum_end, d cum's parts (each s tile's own rows; the M row sums of each
    # s tile; each s tile's sum of T), and each s tile's part of dCm, summed
    # over the heads
    n_tiles = -(-q // 64)
    qg = n_tiles * 64
    scratch = (torch.empty((b, nc, qg, qg), dtype=f32, device=dev),
               torch.empty((b, h, nc, p, n), dtype=f32, device=dev),
               torch.empty((b, h, nc), dtype=f32, device=dev),
               torch.empty((b, h, nc, q), dtype=f32, device=dev),
               torch.empty((b, h, nc, n_tiles, q), dtype=f32, device=dev),
               torch.empty((b, h, nc, n_tiles), dtype=f32, device=dev),
               torch.empty((b, nc, n_tiles, q, n), dtype=f32, device=dev))
    vec4 = p % 4 == 0 and n % 4 == 0 and all(
        t.data_ptr() % 16 == 0 and all(st % 4 == 0 for st in t.stride()[:-1])
        for t in (x, bm, cm, dy))
    strides = (ctypes.c_longlong * 22)(
        *x.stride()[:4], *dt.stride(), *ld.stride(), *bm.stride()[:3],
        *cm.stride()[:3], *dy.stride()[:4])
    lib = _bwd_library()
    with torch.cuda.device(dev):
        err = lib.repro_torch_mamba_scan_bwd(
            *(t.data_ptr() for t in (x, dt, ld, bm, cm, dy, states, dh, *outs, *scratch)),
            b, h, nc, q, p, n, int(vec4), strides, torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise KernelError(
            f"mamba_scan_bwd kernel launch refused (CUDA error {err}; "
            f"x={tuple(x.shape)}, N={n})"
        )
    BWD_LAUNCHES["mamba_chunk_scan_bwd_kernel"] += 1
    return outs


class MambaScanFn(torch.autograd.Function):
    """The chunked scan whose forward is :func:`mamba_chunk_scan_kernel` and
    whose backward is :func:`mamba_chunk_scan_bwd_kernel`.  Saves the inputs
    and the forward's states entering each chunk ((B, H, NC, P, N) f32: 67 MB
    a layer at zamba2-1.2b's 2 x 8192 tokens), so nothing is recomputed."""

    @staticmethod
    def forward(ctx, x, dt, ld, bm, cm, h0):
        y, h_out, states = _scan(x, dt, ld, bm, cm, h0)
        ctx.save_for_backward(x, dt, ld, bm, cm, states)
        return y, h_out

    @staticmethod
    def backward(ctx, dy, dh):
        x, dt, ld, bm, cm, states = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        return mamba_chunk_scan_bwd_kernel(x, dt, ld, bm, cm, states, dy, dh)
