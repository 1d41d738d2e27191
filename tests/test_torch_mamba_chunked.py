"""The arithmetic of B5's chunk-parallel passes (``csrc/mamba_scan.cu``),
emulated in PyTorch on the CPU, against the JAX package's scan (the token
recurrence ``ref.mamba_chunk_scan_reference`` and the Pallas kernel in
interpret mode).

The emulation follows the kernel's decomposition: G = C B^T once per
(batch, chunk), shared by every head (pass 1); each chunk's own state
contribution S_c = (x exp(cum_end - cum) dt)^T B (pass 2); the state entering
each chunk, h_c = h_{c-1} exp(cum_end) + S_{c-1} from h0 (pass 3); and y =
(G o exp(cum_t - cum_s)[s <= t] dt_s) x + exp(cum_t) C h_c^T (pass 4).
Every product is 3xTF32 as on the tensor cores: each f32 operand is split
into hi (the low 13 mantissa bits cleared: TF32) and lo (the same of what
is left), a b = a_lo b_hi + a_hi b_lo + a_hi b_hi with f32 sums (products of
two TF32 values are exact in f32).  The kernel takes pass 4's decay by the
SFU's exp2 (within ~2^-22 of it), the emulation by ``torch.exp``.  The CUDA
kernel itself is held to the plain version on the card by
``chip_smoke.py``.

Tolerance: ``chip_smoke.MAMBA_RTOL`` = 1e-4 of the output's largest
magnitude (at least 1), as the kernel is held on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import mamba_chunk_scan as j_scan
from repro.kernels import ref as j_ref
from repro_torch.kernels import mamba_scan as t_scan

RTOL = 1e-4   # chip_smoke.MAMBA_RTOL

MAMBA_CASES = [
    # (B, S, H, P, N, chunk) — test_torch_mamba.MAMBA_CASES
    (1, 8, 1, 4, 2, 4),
    (2, 32, 3, 8, 4, 8),
    (1, 64, 2, 16, 16, 16),
    (2, 24, 4, 8, 8, 24),      # single chunk
    (1, 128, 1, 32, 8, 32),
]
# the hybrid model's widths (P = N = 64, chunk 256), cut to two chunks
WIDE_CASE = (1, 512, 2, 64, 64, 256)


def tf32(a: torch.Tensor) -> torch.Tensor:
    """``a`` with the low 13 of its 23 mantissa bits cleared."""
    return (a.view(torch.int32) & -8192).view(torch.float32)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a_hi, b_hi = tf32(a), tf32(b)
    a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def mm_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return tf32(a) @ tf32(b)


def emulate_chunked(x, dt, ld, bm, cm, h0, mm=mm_3xtf32):
    """B5's passes on head-major float32 tensors: x (B, H, NC, Q, P), dt and
    ld (B, H, NC, Q), bm and cm (B, NC, Q, N), h0 (B, H, P, N)."""
    nc, q = x.shape[2], x.shape[3]
    cum = torch.cumsum(ld, dim=-1)                              # (B, H, NC, Q)
    cum_end = cum[..., -1]                                      # (B, H, NC)
    # pass 1: G once per (batch, chunk); no head index
    gram = mm(cm, bm.transpose(-1, -2))                         # (B, NC, Q, Q)
    # pass 2: every chunk's own contribution, all chunks at once
    tail = torch.exp(cum_end[..., None] - cum) * dt             # (B, H, NC, Q)
    s_c = mm((x * tail[..., None]).transpose(-1, -2), bm[:, None])  # (B, H, NC, P, N)
    # pass 3: the state entering each chunk
    h_in = torch.empty_like(s_c)
    h = h0.clone()
    for c in range(nc):
        h_in[:, :, c] = h
        h = h * torch.exp(cum_end[:, :, c])[..., None, None] + s_c[:, :, c]
    # pass 4: the output, all chunks at once
    causal = torch.ones((q, q), dtype=torch.bool).tril()
    decay = torch.exp(torch.where(causal, cum[..., :, None] - cum[..., None, :], -torch.inf))
    w = gram[:, None] * decay * dt[..., None, :]                # (B, H, NC, Q, Q)
    inter = mm(cm[:, None], h_in.transpose(-1, -2))             # (B, H, NC, Q, P)
    y = torch.exp(cum)[..., None] * inter + mm(w, x)
    return y, h


def _inputs(case, seed):
    b, s, h, p, n, chunk = case
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.05, 1.0, size=(b, s, h)).astype(np.float32)
    ld = -rng.uniform(0.01, 0.8, size=(b, s, h)).astype(np.float32)
    bm = rng.normal(size=(b, s, n)).astype(np.float32)
    cm = rng.normal(size=(b, s, n)).astype(np.float32)
    h0 = rng.normal(size=(b, h, p, n)).astype(np.float32)
    return x, dt, ld, bm, cm, h0


def _head_major(case, x, dt, ld, bm, cm, h0):
    b, s, h, p, n, chunk = case
    q = min(chunk, s)
    nc = s // q
    return (x.reshape(b, nc, q, h, p).transpose(0, 3, 1, 2, 4),
            dt.reshape(b, nc, q, h).transpose(0, 3, 1, 2),
            ld.reshape(b, nc, q, h).transpose(0, 3, 1, 2),
            bm.reshape(b, nc, q, n), cm.reshape(b, nc, q, n), h0)


def _worst(got: torch.Tensor, want) -> float:
    """Largest error over the tolerance, RTOL x max(1, max |want|)."""
    want = np.asarray(want, np.float32)
    err = float(np.abs(got.numpy() - want).max())
    return err / (RTOL * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("idx", range(len(MAMBA_CASES)))
def test_chunk_parallel_passes_match_pallas_kernel_and_token_recurrence(idx):
    case = MAMBA_CASES[idx]
    b, s, h, p, n, chunk = case
    arrays = _inputs(case, 400 + idx)
    heads = _head_major(case, *arrays)
    y, h_t = emulate_chunked(*(torch.from_numpy(np.ascontiguousarray(a)) for a in heads))
    y = y.permute(0, 2, 3, 1, 4).reshape(b, s, h, p)

    y_k, h_k = j_scan(*map(jnp.asarray, arrays), chunk=chunk)
    y_r, h_r = j_ref.mamba_chunk_scan_reference(*map(jnp.asarray, heads))
    y_r = jnp.transpose(y_r, (0, 2, 3, 1, 4)).reshape(b, s, h, p)
    for got, want in ((y, y_k), (h_t, h_k), (y, y_r), (h_t, h_r)):
        assert _worst(got, want) <= 1.0


def test_3xtf32_meets_the_tolerance_where_one_tf32_product_does_not():
    """At the model's widths (P = N = 64, chunk 256): the same passes with
    every product one TF32 product (~2^-11 per operand) leave y more than
    1e-4 of its largest value off the token recurrence; 3xTF32 does not."""
    arrays = _inputs(WIDE_CASE, 500)
    heads = [torch.from_numpy(np.ascontiguousarray(a)) for a in _head_major(WIDE_CASE, *arrays)]
    y_r, h_r = j_ref.mamba_chunk_scan_reference(*(jnp.asarray(t.numpy()) for t in heads))
    y3, h3 = emulate_chunked(*heads)
    y1, h1 = emulate_chunked(*heads, mm=mm_tf32)
    assert _worst(y3, y_r) <= 1.0 and _worst(h3, h_r) <= 1.0
    assert _worst(y1, y_r) > 1.0


def test_gram_is_shared_by_every_head():
    """G = C B^T depends on (batch, chunk) only: the passes give each head
    what a scan of that head alone gives."""
    case = (2, 64, 3, 8, 8, 16)
    heads = [torch.from_numpy(np.ascontiguousarray(a))
             for a in _head_major(case, *_inputs(case, 7))]
    x, dt, ld, bm, cm, h0 = heads
    y, h = emulate_chunked(*heads)
    for i in range(3):
        one = slice(i, i + 1)
        y_i, h_i = emulate_chunked(x[:, one], dt[:, one], ld[:, one], bm, cm, h0[:, one])
        torch.testing.assert_close(y_i, y[:, one])
        torch.testing.assert_close(h_i, h[:, one])


def test_tf32_split_is_exact_to_twenty_bits():
    a = torch.from_numpy(np.random.default_rng(3).normal(size=4096).astype(np.float32))
    hi = tf32(a)
    lo = tf32(a - hi)
    assert ((hi.view(torch.int32) & 8191) == 0).all() and ((lo.view(torch.int32) & 8191) == 0).all()
    assert float(((a - hi - lo).abs() / a.abs()).max()) <= 2.0**-20
    assert float(((a - hi).abs() / a.abs()).max()) > 2.0**-12


def test_scan_counts_one_per_call_and_none_on_the_cpu():
    """``LAUNCHES`` counts calls of the wrapper (four passes are one call);
    a CPU call runs the plain version and counts nothing."""
    t_scan.LAUNCHES["mamba_chunk_scan_kernel"] = 5
    t_scan.reset_launches()
    assert t_scan.LAUNCHES == {"mamba_chunk_scan_kernel": 0}
    case = (1, 32, 2, 8, 4, 16)
    heads = [torch.from_numpy(np.ascontiguousarray(a)) for a in _head_major(case, *_inputs(case, 1))]
    y, h = t_scan.mamba_chunk_scan_kernel(*heads)
    assert y.shape == heads[0].shape and h.shape == heads[5].shape
    assert t_scan.LAUNCHES["mamba_chunk_scan_kernel"] == 0
