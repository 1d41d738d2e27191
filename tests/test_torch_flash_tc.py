"""The arithmetic of B4's tensor-core variant (``flash_attention_kernel_tc``
in ``csrc/flash_attention.cu``), emulated in PyTorch on the CPU, against the
JAX package's attention (``ref.flash_reference`` and the Pallas kernel in
interpret mode).

The emulation follows the kernel's decomposition: query tiles of 64 NWG rows
(NWG warpgroups: 2 at hd 64, 4 at hd 128), key tiles of 64, only the key
tiles the causal/window band reaches; S = Q K^T from bf16 operands with f32
sums (products of two bf16 values are exact in f32); the row max taken on
the raw scores and scaled by log2(e) scale, p = exp2(s log2(e) scale - m) as
one fused multiply-add, the running max and sum in f32; the mask applied
only on the tiles the band's edge crosses; P V as P_hi V + P_lo V with P_hi
= bf16(P) and P_lo = bf16(P - P_hi); output o (1 / l) rounded to bf16.  The
CUDA kernel itself is held to the plain version on the card by
``chip_smoke.py``.

Tolerance: ``chip_smoke.FLASH_TOL``'s bf16 entry, atol 1e-5 + 2^-7 |o| (one
bf16 step of the output: both sides round an f32 result to bf16)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as j_ref
from repro.kernels.flash_attention import flash_attention_kernel as j_flash_kernel
from repro_torch.kernels import flash_attention as t_flash

ATOL, RTOL = 1e-5, 2.0**-7   # chip_smoke.FLASH_TOL["bfloat16"]
LOG2E = 1.4426950408889634
NEG_INF = -2.0**30
BK = 64                      # keys per tile

TC_CASES = [
    # (B, H, Hkv, S, hd, causal, window)
    (1, 4, 2, 320, 64, True, 200),     # GQA, causal with a window, ragged last tile
    (1, 4, 1, 256, 128, True, 100),    # GQA 4:1 at hd 128
    (2, 2, 2, 200, 64, False, 70),     # full attention with a window
]


def _bf16_pair(rng, shape):
    """The same bf16 values as a JAX array and a torch tensor."""
    a = jnp.asarray(rng.normal(size=shape), jnp.bfloat16)
    return a, torch.from_numpy(np.asarray(a.astype(jnp.float32))).bfloat16()


def _inputs(case, seed):
    b, h, hkv, s, hd, _, _ = case
    rng = np.random.default_rng(seed)
    return [_bf16_pair(rng, (b, heads, s, hd)) for heads in (h, hkv, hkv)]


def edge_tile(q0, bq, k0, sq, sk, causal, window) -> bool:
    """The kernel's test of whether the band's edge crosses a tile."""
    return (k0 + BK > sk or q0 + bq > sq or (causal and k0 + BK - 1 > q0)
            or (window is not None and k0 <= q0 + bq - 1 - window))


def emulate_tc(q, k, v, *, causal, window, split=True):
    """B4's tensor-core arithmetic on bf16 (B, H, S, hd) tensors; v's head
    width may be narrower (MLA's (192, 128))."""
    b, h, sq, hd = q.shape
    hkv, sk, hd_v = k.shape[1], k.shape[2], v.shape[3]
    bq = 128 if hd == 64 else 256
    f32 = torch.float32
    scale_log2 = torch.tensor(1.0 / math.sqrt(hd), dtype=f32) * torch.tensor(LOG2E, dtype=f32)
    qf = q.to(f32)
    kf = k.to(f32).repeat_interleave(h // hkv, dim=1)   # KV head h // (H / Hkv)
    vf = v.to(f32).repeat_interleave(h // hkv, dim=1)
    out = torch.zeros((b, h, sq, hd_v), dtype=f32)
    for q0 in range(0, sq, bq):
        rows = torch.arange(q0, min(q0 + bq, sq))
        q_last = int(rows[-1])
        k_hi = min(sk, q_last + 1) if causal else sk
        k_lo = max(0, q0 - window + 1) if window is not None else 0
        m = torch.full((b, h, len(rows)), NEG_INF, dtype=f32)
        l = torch.zeros((b, h, len(rows)), dtype=f32)
        o = torch.zeros((b, h, len(rows), hd_v), dtype=f32)
        for k0 in range(k_lo // BK * BK, k_hi if k_hi > k_lo else 0, BK):
            keys = torch.arange(k0, min(k0 + BK, sk))
            s = qf[:, :, rows] @ kf[:, :, keys].transpose(-1, -2)
            mask = torch.ones((len(rows), len(keys)), dtype=torch.bool)
            if causal:
                mask &= keys[None, :] <= rows[:, None]
            if window is not None:
                mask &= keys[None, :] > rows[:, None] - window
            if not edge_tile(q0, bq, k0, sq, sk, causal, window):
                assert mask.all() and len(keys) == BK   # the kernel skips the mask here
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1) * scale_log2)
            corr = torch.exp2(m - m_new)
            # fmaf(s, scale_log2, -m): one rounding, as float64 then float32
            arg = (s.double() * scale_log2.double() - m_new.double()[..., None]).to(f32)
            p = torch.where(s == NEG_INF, 0.0, torch.exp2(arg))
            l = l * corr + p.sum(dim=-1)
            if split:
                p_hi = p.bfloat16().to(f32)
                p_lo = (p - p_hi).bfloat16().to(f32)
                pv = p_lo @ vf[:, :, keys] + p_hi @ vf[:, :, keys]
            else:
                pv = p.bfloat16().to(f32) @ vf[:, :, keys]
            o = o * corr[..., None] + pv
            m = m_new
        out[:, :, rows] = o * (1.0 / l.clamp_min(1e-30))[..., None]
    return out.bfloat16()


def _outside(got: torch.Tensor, want) -> tuple[float, float]:
    """(worst error over the tolerance, share of outputs outside it)."""
    want = torch.from_numpy(np.asarray(jnp.asarray(want).astype(jnp.float32)))
    err = (got.to(torch.float32) - want).abs()
    over = err / (ATOL + RTOL * want.abs())
    return float(over.max()), float((over > 1.0).to(torch.float32).mean())


@pytest.mark.parametrize("idx", range(len(TC_CASES)))
def test_tensor_core_arithmetic_matches_jax_reference_and_pallas(idx):
    case = TC_CASES[idx]
    _, _, _, s, hd, causal, window = case
    (qj, qt), (kj, kt), (vj, vt) = _inputs(case, 300 + idx)
    got = emulate_tc(qt, kt, vt, causal=causal, window=window)
    ref = j_ref.flash_reference(qj, kj, vj, causal=causal, window=window)
    pallas = j_flash_kernel(qj, kj, vj, causal=causal, window=window,
                            block_q=64, block_k=64)
    for want in (ref, pallas):
        worst, share = _outside(got, want)
        assert worst <= 1.0, (worst, share)


def test_p_rounded_to_bf16_alone_leaves_outputs_outside_the_tolerance():
    """At the first case's inputs, P V with P rounded to bf16 (what usual
    flash kernels do) puts outputs more than one bf16 step off; the split
    P_hi + P_lo does not."""
    case = TC_CASES[0]
    _, _, _, _, _, causal, window = case
    (qj, qt), (kj, kt), (vj, vt) = _inputs(case, 300)
    want = j_ref.flash_reference(qj, kj, vj, causal=causal, window=window)
    worst_split, _ = _outside(emulate_tc(qt, kt, vt, causal=causal, window=window), want)
    worst_bf16, share_bf16 = _outside(
        emulate_tc(qt, kt, vt, causal=causal, window=window, split=False), want)
    assert worst_split <= 1.0
    assert worst_bf16 > 1.0 and share_bf16 > 0.0, (worst_bf16, share_bf16)


@pytest.mark.parametrize("sq,sk,causal,window", [
    (1024, 1024, True, 300), (1000, 1337, False, 300), (500, 500, True, None),
    (130, 63, False, 16),
])
def test_kernel_visits_the_band_and_masks_exactly_its_edge(sq, sk, causal, window):
    """By brute force over every (query tile, key tile) of 128 x 64: the
    kernel's key range [k_lo, k_hi) visits exactly the tiles that hold a
    visible pair, its edge test holds exactly where a tile is partly masked,
    and (causal) a later query tile visits at least as many key tiles as an
    earlier one, so launching the last tiles first puts the heaviest first."""
    bq = 128
    q_pos = torch.arange(sq)[:, None]
    k_pos = torch.arange(sk)[None, :]
    band = torch.ones((sq, sk), dtype=torch.bool)
    if causal:
        band &= k_pos <= q_pos
    if window is not None:
        band &= k_pos > q_pos - window
    visited = []
    for q0 in range(0, sq, bq):
        q_last = min(q0 + bq, sq) - 1
        k_hi = min(sk, q_last + 1) if causal else sk
        k_lo = max(0, q0 - window + 1) if window is not None else 0
        tiles = range(k_lo // BK, (k_hi - 1) // BK + 1 if k_hi > k_lo else 0)
        visited.append(len(tiles))
        for kt in range(-(-sk // BK)):
            block = band[q0:q0 + bq, kt * BK:kt * BK + BK]
            assert block.any() == (kt in tiles)
            if kt in tiles:
                full = bool(block.all()) and block.shape == (bq, BK)
                assert edge_tile(q0, bq, kt * BK, sq, sk, causal, window) == (not full)
    if causal:
        assert visited == sorted(visited)


@pytest.mark.parametrize("dtype,hd,variant", [
    (torch.bfloat16, 64, "tensor_cores"),
    (torch.bfloat16, 128, "tensor_cores"),
    (torch.bfloat16, 8, "cuda_cores"),
    (torch.bfloat16, 16, "cuda_cores"),
    (torch.bfloat16, 32, "cuda_cores"),
    (torch.float32, 64, "cuda_cores"),
    (torch.float32, 128, "cuda_cores"),
    (torch.float32, 8, "cuda_cores"),
])
def test_variant_is_fixed_by_dtype_and_head_width(dtype, hd, variant):
    assert t_flash.flash_variant(dtype, hd) == variant


def test_launch_counts_one_per_call_and_none_on_the_cpu():
    """A CPU call runs the plain version and counts nothing in either
    counter; ``reset_launches`` zeroes the call count and every variant's."""
    assert set(t_flash.VARIANT_LAUNCHES) == {"tensor_cores", "cuda_cores"}
    t_flash.LAUNCHES["flash_attention_kernel"] = 3
    t_flash.VARIANT_LAUNCHES["tensor_cores"] = 2
    t_flash.VARIANT_LAUNCHES["cuda_cores"] = 1
    t_flash.reset_launches()
    assert t_flash.LAUNCHES == {"flash_attention_kernel": 0}
    assert set(t_flash.VARIANT_LAUNCHES.values()) == {0}
    q = torch.zeros(1, 2, 8, 64, dtype=torch.bfloat16)
    out = t_flash.flash_attention_kernel(q, q, q)
    assert out.shape == q.shape and out.dtype == q.dtype
    assert t_flash.LAUNCHES["flash_attention_kernel"] == 0
    assert set(t_flash.VARIANT_LAUNCHES.values()) == {0}


def test_rows_aligned_is_what_the_tensor_core_variant_takes():
    base = torch.zeros(2, 40, 4, 64, dtype=torch.bfloat16)          # (B, S, H, hd)
    assert t_flash._rows_aligned(base.transpose(1, 2))
    odd = torch.zeros(2, 40, 4 * 64 + 4, dtype=torch.bfloat16)[..., :256]
    assert not t_flash._rows_aligned(odd.reshape(2, 40, 4, 64).transpose(1, 2))
    assert not t_flash._rows_aligned(base.flatten()[4:4 + 8 * 64].view(8, 64)[None, None])
    # a dimension of size 1 may have any stride
    assert t_flash._rows_aligned(torch.zeros(1, 1, 8, 64, dtype=torch.bfloat16)
                                 .as_strided((1, 1, 8, 64), (7, 3, 64, 1)))
