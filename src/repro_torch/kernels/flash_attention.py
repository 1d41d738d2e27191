"""Flash attention for an NVIDIA GPU (``csrc/flash_attention.cu``), with its
plain PyTorch version.

:func:`flash_attention_kernel` is the counterpart of the JAX package's
Pallas kernel of the same name: online-softmax attention, head-major
``(B, H, Sq, hd) × (B, Hkv, Sk, hd)`` with values ``(B, Hkv, Sk, hd_v)``,
causal or full, optional sliding window, GQA by index.  ``hd_v`` may be
narrower than ``hd``: MLA attends with q/k heads of 192 and value heads of
128 (the Pallas kernel takes one ``hd``; the JAX package's chunked core
cannot take MLA's heads at all).  Each tensor may be any view whose last dim is
contiguous (the kernel takes the batch, head and row strides), so the
model's ``(B, S, H, hd)`` tensors go in as ``transpose(1, 2)`` views.  A CUDA
tensor launches the kernel or raises ``kernels.build.KernelError``; a CPU
tensor runs :func:`~repro_torch.kernels.ref.flash_attention_plain`; a fake
CUDA tensor (the dry run's) takes the kernel by shape
(``kernels.traced``) and launches nothing.

The kernel has two variants behind one C entry point, chosen by
:func:`flash_variant` from the dtype and head widths alone: bfloat16 at
``(hd, hd_v)`` (64, 64), (128, 128) and (192, 128) runs on the tensor cores
(``wgmma``, with P split into two bf16 parts, and ``cp.async`` staging),
float32 and the narrow bfloat16 heads on the CUDA cores.  ``LAUNCHES`` counts kernel launches, one per call whichever
the variant; ``VARIANT_LAUNCHES`` counts them by variant.

With ``return_lse=True`` the forward also returns each row's log-sum-exp
``L`` of the scaled scores, ``(B, H, Sq)`` float32 in base e (0 for a row
with no visible key), which the kernel writes beside the output.

:func:`flash_attention_bwd_kernel` is the backward (``csrc/flash_attention_bwd.cu``,
no TPU counterpart: the JAX package autodiffs its jnp attention): ``dq``,
``dk``, ``dv`` from the forward's inputs, its output, its ``L`` and the
output's gradient, deterministic (no atomics).  It has two variants too,
chosen by :func:`flash_bwd_variant`: bfloat16 at (64, 64), (128, 128) and
(192, 128) on the tensor cores (``wgmma``), the rest on the CUDA cores.  A CPU
tensor takes autograd through the plain version
(:func:`~repro_torch.kernels.ref.flash_attention_bwd_plain`).
:class:`FlashAttentionFn` joins the two: its forward is the kernel above
(keeping ``L``), its backward this one; ``kernels.ops.flash_attention``
applies it to CUDA tensors.  ``BWD_LAUNCHES`` counts its calls (three
launches each, counted once), ``BWD_VARIANT_LAUNCHES`` by variant.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.build import KernelError
from repro_torch.kernels import traced
from repro_torch.kernels.mcop_phase import _require
from repro_torch.kernels.ref import (
    attention_output_like, flash_attention_bwd_plain, flash_attention_lse_plain,
    flash_attention_plain,
)

__all__ = [
    "FlashAttentionFn",
    "flash_attention_kernel",
    "flash_attention_bwd_kernel",
    "flash_attention_bwd_plain",
    "flash_attention_lse_plain",
    "flash_attention_plain",
    "BWD_LAUNCHES",
    "BWD_VARIANT_LAUNCHES",
    "FLASH_HEAD_DIMS",
    "LAUNCHES",
    "TENSOR_CORE_HEAD_DIMS",
    "VARIANT_LAUNCHES",
    "flash_bwd_variant",
    "flash_variant",
    "reset_launches",
]

# (hd, hd_v) pairs the kernel is instantiated for: equal widths, MLA's
# (192, 128), and (24, 16), MLA's pair at the configs' reduced widths
FLASH_HEAD_DIMS = ((8, 8), (16, 16), (32, 32), (64, 64), (128, 128), (24, 16), (192, 128))
# bfloat16 (hd, hd_v) pairs the tensor-core variant is instantiated for
TENSOR_CORE_HEAD_DIMS = ((64, 64), (128, 128), (192, 128))
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_VARIANT_CODES = {"cuda_cores": 0, "tensor_cores": 1}

# launches since the last reset_launches(); the wrapper adds one exactly
# where it launches its kernel, and nowhere else
LAUNCHES = {"flash_attention_kernel": 0}
VARIANT_LAUNCHES = {variant: 0 for variant in _VARIANT_CODES}
# calls of the backward kernel, counted the same way, and by its variant
BWD_LAUNCHES = {"flash_attention_bwd_kernel": 0}
BWD_VARIANT_LAUNCHES = {variant: 0 for variant in _VARIANT_CODES}


def reset_launches() -> None:
    LAUNCHES["flash_attention_kernel"] = 0
    BWD_LAUNCHES["flash_attention_bwd_kernel"] = 0
    for counts in (VARIANT_LAUNCHES, BWD_VARIANT_LAUNCHES):
        for variant in counts:
            counts[variant] = 0


def flash_variant(dtype: torch.dtype, hd: int, hd_v: int | None = None) -> str:
    """The kernel variant that takes inputs of ``dtype``, q/k head width
    ``hd`` and value head width ``hd_v`` (default ``hd``):
    ``"tensor_cores"`` for bfloat16 at a pair of ``TENSOR_CORE_HEAD_DIMS``,
    else ``"cuda_cores"``.  Nothing else decides it."""
    pair = (hd, hd if hd_v is None else hd_v)
    return ("tensor_cores" if dtype == torch.bfloat16 and pair in TENSOR_CORE_HEAD_DIMS
            else "cuda_cores")


# The backward kernel's variant for dtype and (hd, hd_v): its tensor-core
# variant is instantiated at the forward's pairs, so the forward's table.
flash_bwd_variant = flash_variant


def _rows_aligned(t: torch.Tensor) -> bool:
    """Every row of ``t`` (B, H, S, hd) in bf16 starts on a 16-byte boundary."""
    return t.data_ptr() % 16 == 0 and all(
        st % 8 == 0 for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1)


def _library():
    from repro_torch.kernels import build

    lib = build.load("flash_attention")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.repro_torch_flash_attention.argtypes = (
        [P] * 5 + [I] * 9 + [ctypes.c_float, I, I, ctypes.POINTER(ctypes.c_longlong), P]
    )
    return lib  # restype: ctypes' default c_int, the CUDA error code


def flash_attention_kernel(
    q: torch.Tensor,   # (B, H, Sq, hd)
    k: torch.Tensor,   # (B, Hkv, Sk, hd)
    v: torch.Tensor,   # (B, Hkv, Sk, hd_v)
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
    return_lse: bool = False,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """Attention on the inputs' device; returns (B, H, Sq, hd_v) in q's dtype,
    and with ``return_lse`` also each row's log-sum-exp ``L`` (B, H, Sq)
    float32, base e, 0 for a row with no visible key.

    Inputs are float32 or bfloat16, all of one dtype, each with a
    contiguous last dim; ``H`` is a multiple of ``Hkv``; ``window`` (if
    given) is ``>= 0``; ``scale`` defaults to ``1/sqrt(hd)``.  On a CUDA
    tensor ``(hd, hd_v)`` must be one of ``FLASH_HEAD_DIMS``, and where the
    tensor-core variant takes the inputs their rows are 16-byte aligned
    (each tensor's address and its batch, head and row strides).  The
    output has q's strides where q is dense and ``hd_v == hd`` (a
    ``transpose(1, 2)`` view of a contiguous tensor gives one back); with a
    narrower ``hd_v`` it is laid out in q's order of dims."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"expected 4-D q, k and v, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, sq, hd = (int(d) for d in q.shape)
    hkv, sk = int(k.shape[1]), int(k.shape[2])
    hd_v = int(v.shape[3])
    if hkv == 0 or h % hkv:
        raise ValueError(f"query heads {h} are not a multiple of KV heads {hkv}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if window is not None and window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    dev = q.device
    _require(q, "q", (b, h, sq, hd), q.dtype, dev, layout="rows")
    _require(k, "k", (b, hkv, sk, hd), q.dtype, dev, layout="rows")
    _require(v, "v", (b, hkv, sk, hd_v), q.dtype, dev, layout="rows")
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    if dev.type == "cpu":
        out = flash_attention_plain(q, k, v, causal=causal, window=window, scale=scale)
        if return_lse:
            return out, flash_attention_lse_plain(q, k, causal=causal, window=window,
                                                  scale=scale)
        return out
    if dev.type != "cuda":
        raise ValueError(f"no flash-attention kernel for device {dev}")
    if (hd, hd_v) not in FLASH_HEAD_DIMS:
        raise ValueError(f"flash_attention_kernel takes (hd, hd_v) in {FLASH_HEAD_DIMS}, "
                         f"got {(hd, hd_v)}")
    if traced.is_fake(q):   # the dry run: the kernel by shape, nothing launched
        out, lse = traced.flash_attention(q, k, v, causal, window, scale)
        return (out, lse) if return_lse else out
    variant = flash_variant(q.dtype, hd, hd_v)
    out = attention_output_like(q, hd_v)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev) if return_lse else None
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    tensors = (q, k, v, out)
    strides = [st for t in tensors for st in t.stride()[:3]]
    if variant == "tensor_cores" and not all(_rows_aligned(t) for t in tensors):
        raise ValueError("the tensor-core flash-attention kernel takes rows that are "
                         f"16-byte aligned; got strides {strides}")
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.repro_torch_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            b, h, hkv, sq, sk, hd, hd_v, int(causal),
            -1 if window is None else min(int(window), 2**30),
            float(scale), _DTYPE_CODES[q.dtype], _VARIANT_CODES[variant],
            (ctypes.c_longlong * 12)(*strides),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise KernelError(
            f"flash_attention kernel launch refused (CUDA error {err}; "
            f"q={tuple(q.shape)}, k={tuple(k.shape)}, {q.dtype})"
        )
    LAUNCHES["flash_attention_kernel"] += 1
    VARIANT_LAUNCHES[variant] += 1
    return (out, lse) if return_lse else out


def _bwd_library():
    from repro_torch.kernels import build

    lib = build.load("flash_attention_bwd")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.repro_torch_flash_attention_bwd.argtypes = (
        [P] * 10 + [I] * 9 + [ctypes.c_float, I, I, ctypes.POINTER(ctypes.c_longlong), P]
    )
    return lib  # restype: ctypes' default c_int, the CUDA error code


def _rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` with a contiguous last dim (a copy only where it has none)."""
    return t if t.shape[-1] <= 1 or t.stride(-1) == 1 else t.contiguous()


def flash_attention_bwd_kernel(
    q: torch.Tensor,     # (B, H, Sq, hd)
    k: torch.Tensor,     # (B, Hkv, Sk, hd)
    v: torch.Tensor,     # (B, Hkv, Sk, hd_v)
    out: torch.Tensor,   # (B, H, Sq, hd_v): the forward's output
    dout: torch.Tensor,  # (B, H, Sq, hd_v): its gradient
    lse: torch.Tensor,   # (B, H, Sq) f32: the forward's log-sum-exp (return_lse)
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of :func:`flash_attention_kernel`'s function on the
    inputs' device, each in q's dtype and its input's layout where that is
    dense.  ``dk``/``dv`` sum over the query heads of each KV head.  Same
    arguments and limits as the forward; ``out`` and ``dout`` are taken in
    any layout (copied to contiguous rows where their last dim is not);
    ``lse`` is what the forward returned with ``return_lse`` (the CPU's
    plain backward does not read it)."""
    b, h, sq, hd = (int(d) for d in q.shape)
    hkv, sk = int(k.shape[1]), int(k.shape[2])
    hd_v = int(v.shape[3])
    if hkv == 0 or h % hkv:
        raise ValueError(f"query heads {h} are not a multiple of KV heads {hkv}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if window is not None and window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    dev = q.device
    out, dout = _rows(out.to(q.dtype)), _rows(dout.to(q.dtype))
    _require(q, "q", (b, h, sq, hd), q.dtype, dev, layout="rows")
    _require(k, "k", (b, hkv, sk, hd), q.dtype, dev, layout="rows")
    _require(v, "v", (b, hkv, sk, hd_v), q.dtype, dev, layout="rows")
    _require(out, "out", (b, h, sq, hd_v), q.dtype, dev, layout="rows")
    _require(dout, "dout", (b, h, sq, hd_v), q.dtype, dev, layout="rows")
    _require(lse, "lse", (b, h, sq), torch.float32, dev)
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    if dev.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, dout, causal=causal, window=window,
                                         scale=scale)
    if dev.type != "cuda":
        raise ValueError(f"no flash-attention backward kernel for device {dev}")
    if (hd, hd_v) not in FLASH_HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd_kernel takes (hd, hd_v) in "
                         f"{FLASH_HEAD_DIMS}, got {(hd, hd_v)}")
    if traced.is_fake(q):   # the dry run: the kernel by shape, nothing launched
        return traced.flash_attention_bwd(q, k, v, out, dout, lse, causal, window, scale)
    variant = flash_bwd_variant(q.dtype, hd, hd_v)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if b * h == 0:
        return dq, dk, dv
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=dev)  # D = rowsum(dout o)
    tensors = (q, k, v, out, dout, dq, dk, dv)
    strides = [st for t in tensors for st in t.stride()[:3]]
    if variant == "tensor_cores" and not all(_rows_aligned(t) for t in tensors):
        raise ValueError("the tensor-core flash-attention backward takes rows that are "
                         f"16-byte aligned; got strides {strides}")
    lib = _bwd_library()
    with torch.cuda.device(dev):
        err = lib.repro_torch_flash_attention_bwd(
            *(t.data_ptr() for t in tensors), lse.data_ptr(), delta.data_ptr(),
            b, h, hkv, sq, sk, hd, hd_v, int(causal),
            -1 if window is None else min(int(window), 2**30),
            float(scale), _DTYPE_CODES[q.dtype], _VARIANT_CODES[variant],
            (ctypes.c_longlong * 24)(*strides),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise KernelError(
            f"flash_attention_bwd kernel launch refused (CUDA error {err}; "
            f"q={tuple(q.shape)}, k={tuple(k.shape)}, {q.dtype})"
        )
    BWD_LAUNCHES["flash_attention_bwd_kernel"] += 1
    BWD_VARIANT_LAUNCHES[variant] += 1
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Attention whose forward is :func:`flash_attention_kernel` and whose
    backward is :func:`flash_attention_bwd_kernel`, head-major views in,
    as those take them.  Saves q, k, v, the output and its row log-sum-exp
    ``L`` ((B, H, Sq) float32: 2 MB a layer at zamba2-1.2b's 2 x 8192
    tokens), so the backward walks the keys once."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int | None, scale: float | None):
        out, lse = flash_attention_kernel(q, k, v, causal=causal, window=window, scale=scale,
                                          return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = {"causal": causal, "window": window, "scale": scale}
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_kernel(q, k, v, out, dout, lse, **ctx.opts)
        return dq, dk, dv, None, None, None
