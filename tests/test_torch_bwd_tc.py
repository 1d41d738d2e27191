"""The arithmetic of the backward kernels' tensor-core variants, emulated in
PyTorch on the CPU, against ``jax.vjp`` of the JAX package's references.

* B4-bwd's tensor-core variant (``csrc/flash_attention_bwd.cu``, bf16 at
  (64, 64), (128, 128) and (192, 128)): the passes of ``tests/_torch_bwd_passes.py``
  in float32 on bf16 inputs (products of two bf16 values are exact in
  f32), L as B4's tensor-core forward writes it (the running max in units
  of log2, exp2, L = ln 2 (m + log2 l)), P = exp2(S scale log2(e) - L
  log2(e)) as one fused multiply-add, P and dS rounded to bf16 where they
  enter a product, every sum f32, the GQA sum in head order, each gradient
  rounded to bf16.  Held against ``jax.vjp`` of ``repro.kernels.ref.
  flash_reference`` at ``chip_smoke.FLASH_BWD_TOL["bfloat16"]``: 2^-7 of the
  largest gradient.  A second test pins the rounding decision: P and dS in
  bf16 alone stay well inside that (a hi + lo split, as the forward's P V
  takes, is not needed here).
* B5-bwd (``csrc/mamba_scan_bwd.cu``): the same passes with every product as
  3xTF32 (each f32 operand split into its top 10 mantissa bits and the top
  10 of the rest, by truncation; a_hi b_hi + a_hi b_lo + a_lo b_hi with f32
  sums; each product summed on its own and added in f32), C B^T once per
  (batch, chunk), D once per tile pair, dBm summed over the heads in order.
  Held against ``jax.vjp`` of ``repro.kernels.ref.mamba_chunk_scan_reference``
  at ``chip_smoke.MAMBA_RTOL``: 1e-4 x max(1, max |grad|).

Also here: the row log-sum-exp both B4 variants write (and the CPU
wrapper's ``return_lse``) against ``torch.logsumexp``, and
``flash_bwd_variant``'s table.  The CUDA kernels themselves are held to
their plain versions on the card by ``chip_smoke.py``.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bwd_passes import (
    LOG2E, NEG_INF, flash_bwd_passes, key_tiles, mamba_bwd_passes, visible,
)
from repro.kernels.ref import flash_reference, mamba_chunk_scan_reference
from repro_torch.kernels import flash_attention as t_flash
from repro_torch.kernels.ref import flash_attention_plain, mamba_chunk_scan_plain

F32 = torch.float32
FLASH_BWD_TOL = 2.0**-7   # chip_smoke.FLASH_BWD_TOL["bfloat16"]
MAMBA_RTOL = 1e-4         # chip_smoke.MAMBA_RTOL
LSE_TOL = 1e-5            # f32 sums of exponentials in another order, relative to max(1, |L|)

# ---------------------------------------------------------------------------
# B4: the row log-sum-exp L of the forward
# ---------------------------------------------------------------------------


def lse_tensor_cores(q, k, *, causal, window):
    """L as ``flash_attention_kernel_tc`` writes it: query tiles of 64 NWG
    rows (2 warpgroups at hd 64, 4 above), the running max of the raw scores
    scaled by log2(e) scale, exp2, the sum in f32; L = ln 2 (m + log2 l), 0
    for a row with no visible key."""
    b, h, sq, hd = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    bq = 128 if hd == 64 else 256
    scale_log2 = torch.tensor(1.0 / math.sqrt(hd), dtype=F32) * torch.tensor(LOG2E, dtype=F32)
    qf, kf = q.to(F32), k.to(F32).repeat_interleave(h // hkv, 1)
    lse = torch.zeros((b, h, sq), dtype=F32)
    for q0 in range(0, sq, bq):
        rows = torch.arange(q0, min(q0 + bq, sq))
        m = torch.full((b, h, len(rows)), NEG_INF, dtype=F32)
        l = torch.zeros((b, h, len(rows)), dtype=F32)
        for kt in key_tiles(q0, bq, sq, sk, causal, window):
            keys = torch.arange(kt * 64, min(kt * 64 + 64, sk))
            ok = visible(rows, keys, sq, sk, causal, window)
            s = torch.where(ok, qf[:, :, rows] @ kf[:, :, keys].transpose(-1, -2), NEG_INF)
            m_new = torch.maximum(m, s.amax(-1) * scale_log2)
            arg = (s.double() * scale_log2.double() - m_new.double()[..., None]).to(F32)
            p = torch.where(ok, torch.exp2(arg), 0.0)
            l = l * torch.exp2(m - m_new) + p.sum(-1)
            m = m_new
        lse[:, :, rows] = torch.where(l > 0, (m + torch.log2(l.clamp_min(1e-30)))
                                      * math.log(2.0), 0.0)
    return lse


def lse_reference(q, k, *, causal, window):
    """torch.logsumexp of the scaled scores over the visible keys, 0 where
    a row sees none."""
    sq, sk = q.shape[2], k.shape[2]
    kq = k.to(F32).repeat_interleave(q.shape[1] // k.shape[1], 1)
    s = q.to(F32) @ kq.transpose(-1, -2) / math.sqrt(q.shape[3])
    ok = visible(torch.arange(sq), torch.arange(sk), sq, sk, causal, window)
    out = torch.logsumexp(torch.where(ok, s, -math.inf), -1)
    return torch.where(ok.any(-1), out, 0.0)


# (B, H, Hkv, Sq, Sk, hd, causal, window): rows from 78 on of the last case see no key
LSE_CASES = [
    (1, 4, 2, 200, 200, 64, True, 70),
    (1, 2, 1, 150, 150, 128, True, None),
    (2, 2, 2, 130, 90, 64, False, 40),
    (1, 2, 2, 120, 63, 64, False, 16),
]


@pytest.mark.parametrize("case", LSE_CASES, ids=[str(c) for c in LSE_CASES])
def test_forward_lse_matches_logsumexp(case):
    """Both variants' L (the tensor-core arithmetic emulated here, the
    CUDA-core one by the CPU wrapper's plain ``return_lse``) against
    torch.logsumexp; a row with no visible key gets 0."""
    b, h, hkv, sq, sk, hd, causal, window = case
    rng = np.random.default_rng(sum(case[:6]))
    q, k, v = (torch.from_numpy(rng.standard_normal(sh)).bfloat16()
               for sh in ((b, h, sq, hd), (b, hkv, sk, hd), (b, hkv, sk, hd)))
    want = lse_reference(q, k, causal=causal, window=window)
    for got in (lse_tensor_cores(q, k, causal=causal, window=window),
                t_flash.flash_attention_kernel(q, k, v, causal=causal, window=window,
                                               return_lse=True)[1]):
        assert got.shape == (b, h, sq) and got.dtype == F32
        assert float(((got - want).abs() / want.abs().clamp_min(1.0)).max()) <= LSE_TOL
    if window is not None and not causal and sk + window - 1 < sq:
        assert bool((want[:, :, sk + window - 1:] == 0).all())


def test_cpu_return_lse_leaves_the_output_alone():
    q = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 2, 70, 16))).float()
    out, lse = t_flash.flash_attention_kernel(q, q, q, window=9, return_lse=True)
    assert torch.equal(out, t_flash.flash_attention_kernel(q, q, q, window=9))
    assert lse.shape == (1, 2, 70)


# ---------------------------------------------------------------------------
# B4-bwd: the tensor-core variant's arithmetic
# ---------------------------------------------------------------------------


def _bf16(t):
    return t.bfloat16().to(F32)


def _hi_lo(t):
    hi = _bf16(t)
    return hi + _bf16(t - hi)


def probs_tensor_cores(s, lse, scale):
    """P = exp2(fma(S, scale log2(e), -L log2(e))), f32, one rounding for the fma."""
    c = torch.tensor(scale, dtype=F32) * torch.tensor(LOG2E, dtype=F32)
    l2 = lse * torch.tensor(LOG2E, dtype=F32)
    return torch.exp2((s.double() * c.double() - l2.double()).to(F32))


def flash_bwd_tensor_cores(q, k, v, o, lse, dout, *, causal, window, operand=_bf16):
    """B4-bwd's tensor-core arithmetic on bf16 tensors: f32 gradients
    before their rounding to bf16."""
    return flash_bwd_passes(q, k, v, o, lse, dout, causal=causal, window=window,
                            scale=1.0 / math.sqrt(q.shape[3]), probs=probs_tensor_cores,
                            operand=operand, dtype=F32)


# (B, H, Hkv, S, hd, causal, window)
BWD_CASES = [
    (1, 4, 2, 200, 64, True, 70),      # GQA, a window, a ragged last tile
    (1, 4, 1, 150, 128, True, None),   # GQA 4:1 at (128, 128)
    (2, 2, 2, 130, 64, False, 40),     # full attention with a window
    (1, 2, 2, 140, 192, True, 50),     # MLA's (192, 128)
]


def _bwd_inputs(case, seed):
    b, h, hkv, s, hd, causal, window = case
    rng = np.random.default_rng(seed)
    q, k, v, dout = (torch.from_numpy(rng.standard_normal(sh)).bfloat16()
                     for sh in ((b, h, s, hd), (b, hkv, s, hd), (b, hkv, s, hd), (b, h, s, hd)))
    o = flash_attention_plain(q, k, v, causal=causal, window=window)   # bf16, as B4 writes it
    lse = lse_tensor_cores(q, k, causal=causal, window=window)
    return q, k, v, o, lse, dout


def _jax_grads(q, k, v, dout, *, causal, window):
    """``jax.vjp`` of ``flash_reference`` in float32 on the same bf16 values."""
    arrays = [jnp.asarray(t.to(F32).numpy()) for t in (q, k, v)]
    _, vjp = jax.vjp(lambda q_, k_, v_: flash_reference(q_, k_, v_, causal=causal,
                                                        window=window), *arrays)
    return [torch.from_numpy(np.array(g)) for g in vjp(jnp.asarray(dout.to(F32).numpy()))]


def _over_tol(got, want) -> float:
    """Worst error over 2^-7 of the largest gradient, across dq, dk, dv."""
    return max(float((g.to(F32) - w).abs().max()) / (FLASH_BWD_TOL * float(w.abs().max()))
               for g, w in zip(got, want))


@pytest.mark.parametrize("idx", range(len(BWD_CASES)))
def test_flash_bwd_tensor_core_arithmetic_matches_jax_vjp(idx):
    case = BWD_CASES[idx]
    causal, window = case[5], case[6]
    q, k, v, o, lse, dout = _bwd_inputs(case, 400 + idx)
    got = flash_bwd_tensor_cores(q, k, v, o, lse, dout, causal=causal, window=window)
    want = _jax_grads(q, k, v, dout, causal=causal, window=window)
    # the kernel writes each gradient in bf16
    assert _over_tol([g.bfloat16() for g in got], want) <= 1.0


def test_p_and_ds_in_bf16_alone_stay_well_inside_the_tolerance():
    """The rounding decision, at the first case's inputs: with P and dS
    rounded to bf16 as operands the gradients, before their own rounding to
    bf16, are within half of 2^-7 of the largest gradient; that rounding
    adds at most half a bf16 step (2^-9 of the largest, a quarter of the
    tolerance), so the kernel stays inside it without a hi + lo split.  The
    rounding of P and dS is measurable: the exact operands and the split
    are closer (their error is D's, which reads the bf16 output)."""
    case = BWD_CASES[0]
    causal, window = case[5], case[6]
    q, k, v, o, lse, dout = _bwd_inputs(case, 400)
    want = _jax_grads(q, k, v, dout, causal=causal, window=window)
    over = {name: _over_tol(flash_bwd_tensor_cores(q, k, v, o, lse, dout, causal=causal,
                                                   window=window, operand=op), want)
            for name, op in (("bf16", _bf16), ("hi_lo", _hi_lo), ("exact", lambda t: t))}
    assert over["bf16"] <= 0.5, over
    assert over["hi_lo"] < over["bf16"] and over["exact"] < over["bf16"], over


@pytest.mark.parametrize("dtype,hd,hd_v,variant", [
    (torch.bfloat16, 64, 64, "tensor_cores"),
    (torch.bfloat16, 128, 128, "tensor_cores"),
    (torch.bfloat16, 192, 128, "tensor_cores"),
    (torch.bfloat16, 24, 16, "cuda_cores"),
    (torch.bfloat16, 32, 32, "cuda_cores"),
    (torch.bfloat16, 8, 8, "cuda_cores"),
    (torch.float32, 64, 64, "cuda_cores"),
    (torch.float32, 128, 128, "cuda_cores"),
])
def test_bwd_variant_is_fixed_by_dtype_and_widths(dtype, hd, hd_v, variant):
    assert t_flash.flash_bwd_variant(dtype, hd, hd_v) == variant


def test_bwd_variant_counts_reset_with_the_rest():
    assert set(t_flash.BWD_VARIANT_LAUNCHES) == {"tensor_cores", "cuda_cores"}
    t_flash.BWD_VARIANT_LAUNCHES["tensor_cores"] = 5
    t_flash.reset_launches()
    assert set(t_flash.BWD_VARIANT_LAUNCHES.values()) == {0}


# ---------------------------------------------------------------------------
# B5-bwd: 3xTF32
# ---------------------------------------------------------------------------


def tf32_split(a: torch.Tensor):
    """a = hi + lo + rest: hi keeps a's top 10 mantissa bits, lo the top 10
    of what is left (truncation, as ``split_tf32`` masks the bits)."""
    hi = (a.contiguous().view(torch.int32) & -8192).view(F32)
    lo = ((a - hi).contiguous().view(torch.int32) & -8192).view(F32)
    return hi, lo


def mm_3xtf32(a, b):
    """a @ b as the kernel's 3xTF32 mma.sync: a_lo b_hi + a_hi b_lo + a_hi b_hi."""
    ah, al = tf32_split(a.to(F32))
    bh, bl = tf32_split(b.to(F32))
    return (al @ bh + ah @ bl) + ah @ bh


# (B, H, NC, Q, P, N, real steps of the last chunk): two 64-step tiles a
# chunk with a padded tail, a ragged last tile, one tile
MAMBA_CASES = [
    (1, 3, 2, 128, 16, 8, 100),
    (2, 2, 2, 96, 8, 16, 96),
    (1, 2, 3, 48, 12, 12, 30),
]


@pytest.mark.parametrize("case", MAMBA_CASES, ids=[str(c) for c in MAMBA_CASES])
def test_mamba_bwd_3xtf32_matches_jax_vjp(case):
    b, h, nc, q, p, n, last = case
    rng = np.random.default_rng(sum(case))
    dt = rng.uniform(0.05, 1.0, (b, h, nc, q)).astype(np.float32)
    dt[:, :, -1, last:] = 0.0   # padded steps, as mamba2_forward pads
    ld = (-rng.uniform(0.01, 0.8, (b, h, nc, q)) * dt).astype(np.float32)
    x, bm, cm, h0, dy, dh = (rng.standard_normal(sh).astype(np.float32) for sh in
                             ((b, h, nc, q, p), (b, nc, q, n), (b, nc, q, n), (b, h, p, n),
                              (b, h, nc, q, p), (b, h, p, n)))
    _, vjp = jax.vjp(mamba_chunk_scan_reference, x, dt, ld, bm, cm, h0)
    want = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    t = [torch.from_numpy(a) for a in (x, dt, ld, bm, cm, h0, dy, dh)]
    # the forward's states entering each chunk, as B5's carry pass leaves them
    states = torch.empty((b, h, nc, p, n), dtype=F32)
    hc = t[5]
    for c in range(nc):
        states[:, :, c] = hc
        _, hc = mamba_chunk_scan_plain(t[0][:, :, c:c + 1], t[1][:, :, c:c + 1],
                                       t[2][:, :, c:c + 1], t[3][:, c:c + 1],
                                       t[4][:, c:c + 1], hc)
    got = mamba_bwd_passes(t[0], t[1], t[2], t[3], t[4], states, t[6], t[7], mm=mm_3xtf32)
    for name, g, w in zip(("dx", "ddt", "dld", "dbm", "dcm", "dh0"), got, want):
        w = np.asarray(w)
        err = float(np.abs(g.numpy() - w).max())
        assert err <= MAMBA_RTOL * max(1.0, float(np.abs(w).max())), (name, err)


def test_tf32_split_keeps_ten_bits_each():
    a = torch.tensor([1.0 + 2.0**-5 + 2.0**-12 + 2.0**-23, -3.1415927], dtype=F32)
    hi, lo = tf32_split(a)
    for part in (hi, lo):
        assert bool(((part.view(torch.int32) & 8191) == 0).all())
    # 2^-23 is 2^-11 of lo's leading 2^-12: past lo's 10 bits, truncated away
    assert float(hi[0]) == 1.0 + 2.0**-5 and float(lo[0]) == 2.0**-12
    assert float((a - hi - lo).abs().max()) <= 2.0**-20 * float(a.abs().max())
