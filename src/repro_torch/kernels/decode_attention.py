"""B6, attention of a few queries over a plain KV cache for an NVIDIA GPU
(``csrc/decode_attention.cu``), with its plain PyTorch version.

:func:`decode_attention_kernel` computes what
``models.attention.decode_attention`` computes for one key part over a KV
cache whose slot ``j`` holds position ``j``: queries ``(B, Sq, H, hd)`` at
positions ``q_pos`` ``(Sq,)`` over the cache's k and v ``(B, S, Hkv, hd)``
as stored (query head ``h`` reads kv head ``h // (H / Hkv)``), a slot seen
where it is at most the query's position and, with ``window``, above the
position less the window; scores ``scale q . k`` and the softmax in float32,
``P V`` with P in float32; ``(B, Sq, H, hd)`` in q's dtype.  It replaces no
TPU kernel (the JAX package's ``_flash_decode_attention`` is two jnp einsums):
it was written for the port's decode step, whose attention read the cache
as ~44 eager launches a layer and two float32 copies of it
(``models.attention._decode_local``).

A CUDA tensor launches the kernel, two launches a call (the slot splits,
then their combine), or raises :class:`~repro_torch.kernels.build.KernelError`
on what it does not take (:func:`takes`; k's and v's rows 16-byte aligned);
a CPU tensor runs :func:`decode_attention_plain`.  The split count is
:func:`decode_splits` of the card's resident blocks.  ``LAUNCHES`` counts
calls that launch.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import KernelError
from repro_torch.kernels.flash_attention import _rows_aligned
from repro_torch.kernels.mcop_phase import _require

__all__ = [
    "HEAD_DIMS",
    "LAUNCHES",
    "MAX_ROWS",
    "MAX_TILES",
    "TILE",
    "decode_attention_kernel",
    "decode_attention_plain",
    "decode_splits",
    "reset_launches",
    "takes",
]

HEAD_DIMS = (64, 128)   # hd (of q, k and v) the kernel is instantiated for
MAX_ROWS = 8            # query rows a block: (H / Hkv) x Sq
TILE = 64               # slots a tile (csrc's kT)
MAX_TILES = 16          # tiles a block takes at most (csrc's kMaxTiles)

# calls that launched the kernel since the last reset_launches()
LAUNCHES = {"decode_attention_kernel": 0}
_RESIDENT: dict = {}    # (device index, hd, rows) -> blocks resident on the card


def reset_launches() -> None:
    LAUNCHES["decode_attention_kernel"] = 0


def takes(q, k, v, window: int | None) -> bool:
    """The kernel takes queries ``q`` (B, Sq, H, hd) over ``k`` and ``v``
    (B, S, Hkv, hd) with ``window``: all bfloat16; hd in ``HEAD_DIMS``, v's
    the same; ``(H / Hkv) Sq <= MAX_ROWS``; no window or a positive one.
    Reads only dtypes and shapes."""
    if len(q.shape) != 4 or len(k.shape) != 4 or len(v.shape) != 4:
        return False
    _, sq, h, hd = q.shape
    hkv = k.shape[2]
    return (q.dtype == k.dtype == v.dtype == torch.bfloat16
            and hd in HEAD_DIMS and k.shape[3] == hd and v.shape[3] == hd
            and hkv > 0 and h % hkv == 0 and h // hkv * sq <= MAX_ROWS
            and (window is None or window > 0))


def decode_splits(pairs: int, slots: int, resident: int) -> int:
    """Blocks a (batch, kv head) pair: the ``resident`` blocks the card holds
    at once shared among the ``pairs``, at most one a tile of the ``slots``,
    and enough that none takes more than ``MAX_TILES`` tiles (the visible
    slots lie on the device; the cache's length bounds them)."""
    tiles = max(1, -(-slots // TILE))
    return max(1, -(-tiles // MAX_TILES), min(tiles, resident // max(pairs, 1)))


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           q_pos: torch.Tensor, *, scale: float,
                           window: int | None = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch, in float32 over every slot
    at once; a row that sees no slot is 0, as in the kernel."""
    b, sq, h, hd = q.shape
    s, hkv = k.shape[1], k.shape[2]
    f32 = torch.float32
    qg = q.reshape(b, sq, hkv, h // hkv, hd).to(f32)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k.to(f32)) * scale   # (B, kv, g, Sq, S)
    j = torch.arange(s, device=q.device)
    qp = q_pos.to(q.device)[:, None]
    seen = j[None, :] <= qp
    if window is not None:
        seen = seen & (j[None, :] > qp - window)
    m = torch.where(seen, scores, float("-inf")).amax(dim=-1, keepdim=True)
    p = torch.where(seen, torch.exp(scores - torch.where(seen.any(-1, keepdim=True), m, 0.0)),
                    0.0)
    den = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgqs,bskd->bkgqd", p, v.to(f32))
    out = torch.where(den > 0, out / den, 0.0).permute(0, 3, 1, 2, 4)     # (B, Sq, kv, g, hd)
    return out.reshape(b, sq, h, hd).to(q.dtype)


def _library():
    from repro_torch.kernels import build

    lib = build.load("decode_attention")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.repro_torch_decode_attention.argtypes = (
        [P] * 7 + [I] * 7 + [ctypes.c_float, I, ctypes.POINTER(ctypes.c_longlong), P]
    )
    lib.repro_torch_decode_attention_resident.argtypes = [I, I, ctypes.POINTER(I)]
    return lib  # restype: ctypes' default c_int, the CUDA error code


def _resident(dev: torch.device, hd: int, rows: int) -> int:
    """Blocks of the kernel for (hd, rows) the card holds at once."""
    key = (dev.index, hd, rows)
    if key not in _RESIDENT:
        per_sm = ctypes.c_int(0)
        with torch.cuda.device(dev):
            err = _library().repro_torch_decode_attention_resident(hd, rows,
                                                                   ctypes.byref(per_sm))
        if err != 0 or per_sm.value <= 0:
            raise KernelError(f"decode_attention kernel cannot be resident (CUDA error {err}; "
                              f"hd {hd}, {rows} rows)")
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        _RESIDENT[key] = sms * per_sm.value
    return _RESIDENT[key]


def decode_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            q_pos: torch.Tensor, *, scale: float,
                            window: int | None = None) -> torch.Tensor:
    """Attention of ``q`` (B, Sq, H, hd) at positions ``q_pos`` (Sq,) over
    the KV cache ``k``, ``v`` (B, S, Hkv, hd), slot ``j`` at position ``j``;
    returns (B, Sq, H, hd) in q's dtype, contiguous.  Each tensor has a
    contiguous last dim (the kernel takes the other strides); ``H`` is a
    multiple of ``Hkv``; ``window``, if given, is positive."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"expected 4-D q, k and v, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, hd = (int(d) for d in q.shape)
    s, hkv = int(k.shape[1]), int(k.shape[2])
    if hkv == 0 or h % hkv:
        raise ValueError(f"query heads {h} are not a multiple of KV heads {hkv}")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    dev = q.device
    _require(q, "q", (b, sq, h, hd), q.dtype, dev, layout="rows")
    _require(k, "k", (b, s, hkv, hd), q.dtype, dev, layout="rows")
    _require(v, "v", (b, s, hkv, hd), q.dtype, dev, layout="rows")
    if tuple(q_pos.shape) != (sq,) or q_pos.is_floating_point():
        raise ValueError(f"q_pos must hold {sq} integer positions, got {tuple(q_pos.shape)} "
                         f"{q_pos.dtype}")
    if dev.type == "cpu":
        return decode_attention_plain(q, k, v, q_pos, scale=scale, window=window)
    if dev.type != "cuda":
        raise ValueError(f"no decode-attention kernel for device {dev}")
    if not takes(q, k, v, window):
        raise KernelError(f"decode_attention_kernel takes bf16 at hd {HEAD_DIMS} with "
                          f"(H / Hkv) Sq <= {MAX_ROWS}; got {q.dtype}, q {tuple(q.shape)}, "
                          f"k {tuple(k.shape)}")
    if not (_rows_aligned(k) and _rows_aligned(v)):
        raise KernelError("decode_attention_kernel takes k and v rows that are 16-byte "
                          f"aligned; got strides {k.stride()}, {v.stride()}")
    out = torch.empty((b, sq, h, hd), dtype=q.dtype, device=dev)
    if out.numel() == 0:
        return out
    rows = h // hkv * sq
    pairs = b * hkv
    splits = decode_splits(pairs, s, _resident(dev, hd, rows))
    part_ml = torch.empty((pairs, splits, rows, 2), dtype=torch.float32, device=dev)
    part_o = torch.empty((pairs, splits, rows, hd), dtype=torch.float32, device=dev)
    qp = q_pos.to(device=dev, dtype=torch.int64).contiguous()
    strides = [st for t in (q, k, v) for st in t.stride()[:3]]
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.repro_torch_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), qp.data_ptr(), out.data_ptr(),
            part_ml.data_ptr(), part_o.data_ptr(), b, sq, h, hkv, s, hd,
            -1 if window is None else min(int(window), 2**30), float(scale), splits,
            (ctypes.c_longlong * 9)(*strides),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise KernelError(f"decode_attention kernel launch refused (CUDA error {err}; "
                          f"q={tuple(q.shape)}, k={tuple(k.shape)}, {q.dtype})")
    LAUNCHES["decode_attention_kernel"] += 1
    return out
