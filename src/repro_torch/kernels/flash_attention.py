"""Flash attention for an NVIDIA GPU (``csrc/flash_attention.cu``), with its
plain PyTorch version.

:func:`flash_attention_kernel` is the counterpart of the JAX package's
Pallas kernel of the same name: online-softmax attention, head-major
``(B, H, Sq, hd) × (B, Hkv, Sk, hd)``, causal or full, optional sliding
window, GQA by index.  Each tensor may be any view whose last dim is
contiguous (the kernel takes the batch, head and row strides), so the
model's ``(B, S, H, hd)`` tensors go in as ``transpose(1, 2)`` views.  A CUDA tensor launches the kernel or raises
``kernels.build.KernelError``; a CPU tensor runs
:func:`~repro_torch.kernels.ref.flash_attention_plain`.  ``LAUNCHES``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.build import KernelError
from repro_torch.kernels.mcop_phase import _require
from repro_torch.kernels.ref import flash_attention_plain

__all__ = [
    "flash_attention_kernel",
    "flash_attention_plain",
    "FLASH_HEAD_DIMS",
    "LAUNCHES",
    "reset_launches",
]

# head widths the kernel is instantiated for
FLASH_HEAD_DIMS = (8, 16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# launches since the last reset_launches(); the wrapper adds one exactly
# where it launches its kernel, and nowhere else
LAUNCHES = {"flash_attention_kernel": 0}


def reset_launches() -> None:
    LAUNCHES["flash_attention_kernel"] = 0


def _library():
    from repro_torch.kernels import build

    lib = build.load("flash_attention")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.repro_torch_flash_attention.argtypes = (
        [P] * 4 + [I] * 8 + [ctypes.c_float, I, ctypes.POINTER(ctypes.c_longlong), P]
    )
    return lib  # restype: ctypes' default c_int, the CUDA error code


def flash_attention_kernel(
    q: torch.Tensor,   # (B, H, Sq, hd)
    k: torch.Tensor,   # (B, Hkv, Sk, hd)
    v: torch.Tensor,   # (B, Hkv, Sk, hd)
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Attention on the inputs' device; returns (B, H, Sq, hd) in q's dtype.

    Inputs are float32 or bfloat16, all of one dtype, each with a
    contiguous last dim; ``H`` is a multiple of ``Hkv``; ``window`` (if
    given) is ``>= 0``.  On a CUDA tensor ``hd`` must be one of
    ``FLASH_HEAD_DIMS``.  The output has q's strides where q is dense (a
    ``transpose(1, 2)`` view of a contiguous tensor gives one back)."""
    if q.ndim != 4 or k.ndim != 4:
        raise ValueError(f"expected 4-D q and k, got {tuple(q.shape)}, {tuple(k.shape)}")
    b, h, sq, hd = (int(d) for d in q.shape)
    hkv, sk = int(k.shape[1]), int(k.shape[2])
    if hkv == 0 or h % hkv:
        raise ValueError(f"query heads {h} are not a multiple of KV heads {hkv}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if window is not None and window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    dev = q.device
    _require(q, "q", (b, h, sq, hd), q.dtype, dev, layout="rows")
    _require(k, "k", (b, hkv, sk, hd), q.dtype, dev, layout="rows")
    _require(v, "v", (b, hkv, sk, hd), q.dtype, dev, layout="rows")
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window, scale=scale)
    if dev.type != "cuda":
        raise ValueError(f"no flash-attention kernel for device {dev}")
    if hd not in FLASH_HEAD_DIMS:
        raise ValueError(f"flash_attention_kernel takes hd in {FLASH_HEAD_DIMS}, got {hd}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 12)(
        *(st for t in (q, k, v, out) for st in t.stride()[:3]))
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.repro_torch_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, hkv, sq, sk, hd, int(causal),
            -1 if window is None else min(int(window), 2**30),
            float(scale), _DTYPE_CODES[q.dtype], strides,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise KernelError(
            f"flash_attention kernel launch refused (CUDA error {err}; "
            f"q={tuple(q.shape)}, k={tuple(k.shape)}, {q.dtype})"
        )
    LAUNCHES["flash_attention_kernel"] += 1
    return out
