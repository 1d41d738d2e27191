"""CPU emulation of the two backward kernels' algorithms, held against
autograd of the plain versions.

``csrc/flash_attention_bwd.cu`` (B4-bwd) and ``csrc/mamba_scan_bwd.cu``
(B5-bwd) run only on a GPU.  Their passes are written out in torch in
``tests/_torch_bwd_passes.py``, pass for pass and tile for tile, so a fault
of the algorithm (a wrong term, a tile range, a mask, the order of the
reverse carry, a part of d cum left out) shows on the CPU before the card
sees the kernels:

* B4-bwd: the row log-sum-exp ``L`` as B4's forward writes it (its online
  walk over the key tiles); the ``D = rowsum(dout o o)`` pre-pass; the
  dk/dv launch over key tiles, walking the query heads of each KV head and
  the query tiles that can see the key tile; the dq launch over query
  tiles, one walk over their key tiles with ``L`` read, not rebuilt.
* B5-bwd: ``C·Bᵀ`` once per (batch, chunk), each chunk's part of the state
  gradient, the reverse carry across chunks, the pass per s tile that walks
  the heads in order (``du``, ``dB`` summed over the heads, each s tile's
  part of ``dC`` and of d cum, the state terms), ``d ld`` as the reverse
  cumulative sum of d cum's parts, and ``dCm`` as the sum of the parts.

The emulations run in float64; the plain versions compute in float32
whatever their inputs, so the two are held at 1e-5 relative to the largest
gradient (float32 rounding of the same function, ~1e-7 here): a missing or
wrong term is off by far more.  ``tests/test_torch_bwd_tc.py`` runs the same
passes with the tensor cores' rounding.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from _torch_bwd_passes import flash_bwd_passes, flash_lse_online, mamba_bwd_passes
from repro_torch.kernels.ref import (
    flash_attention_bwd_plain, flash_attention_plain, mamba_chunk_scan_bwd_plain,
    mamba_chunk_scan_plain,
)

F64 = torch.float64
TOL = 1e-5  # the plain versions' float32 rounding, relative to the largest gradient


# (B, H, Hkv, Sq, Sk, hd, hd_v, causal, window)
FLASH_CASES = (
    (2, 4, 2, 150, 150, 16, 16, True, None),
    (1, 2, 2, 200, 200, 8, 8, True, 70),
    (2, 4, 1, 100, 133, 16, 16, False, 40),
    (1, 3, 3, 77, 130, 24, 16, False, None),
    (1, 2, 1, 129, 129, 32, 32, True, 64),
)


@pytest.mark.parametrize("case", FLASH_CASES, ids=[str(c) for c in FLASH_CASES])
def test_flash_bwd_emulation_matches_autograd(case):
    b, h, hkv, sq, sk, hd, hd_v, causal, window = case
    rng = np.random.default_rng(sum(case[:7]))
    q, k, v = (torch.from_numpy(rng.standard_normal(s)) for s in
               ((b, h, sq, hd), (b, hkv, sk, hd), (b, hkv, sk, hd_v)))
    dout = torch.from_numpy(rng.standard_normal((b, h, sq, hd_v)))
    scale = 1.0 / math.sqrt(hd)
    o = flash_attention_plain(q, k, v, causal=causal, window=window, scale=scale)
    want = flash_attention_bwd_plain(q, k, v, dout, causal=causal, window=window, scale=scale)
    lse = flash_lse_online(q, k, causal=causal, window=window, scale=scale)
    got = flash_bwd_passes(q, k, v, o, lse, dout, causal=causal, window=window, scale=scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        err = float((g - w).abs().max())
        assert err <= TOL * max(1.0, float(w.abs().max())), (name, err)


# (B, H, NC, Q, P, N, tile, real steps of the last chunk)
MAMBA_CASES = (
    (2, 3, 4, 16, 8, 6, 16, 16),
    (1, 2, 3, 20, 5, 7, 8, 20),
    (2, 2, 2, 24, 4, 4, 8, 13),
    (1, 4, 1, 32, 6, 5, 64, 32),
)


@pytest.mark.parametrize("case", MAMBA_CASES, ids=[str(c) for c in MAMBA_CASES])
def test_mamba_bwd_emulation_matches_autograd(case):
    b, h, nc, q, p, n, tile, last = case
    rng = np.random.default_rng(sum(case))

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape))

    dt = torch.from_numpy(rng.uniform(0.05, 1.0, (b, h, nc, q)))
    ld = -torch.from_numpy(rng.uniform(0.01, 0.8, (b, h, nc, q))) * dt
    dt[:, :, -1, last:] = 0.0     # padded steps, as mamba2_forward pads
    ld[:, :, -1, last:] = 0.0
    x, bm, cm, h0 = draw(b, h, nc, q, p), draw(b, nc, q, n), draw(b, nc, q, n), draw(b, h, p, n)
    dy, dh = draw(b, h, nc, q, p), draw(b, h, p, n)
    want = mamba_chunk_scan_bwd_plain(x, dt, ld, bm, cm, h0, dy, dh)
    # the forward's states entering each chunk, as B5's carry pass leaves them
    states = torch.empty((b, h, nc, p, n), dtype=F64)
    hc = h0
    for c in range(nc):
        states[:, :, c] = hc
        _, hc = mamba_chunk_scan_plain(x[:, :, c:c + 1], dt[:, :, c:c + 1], ld[:, :, c:c + 1],
                                       bm[:, c:c + 1], cm[:, c:c + 1], hc)
    got = mamba_bwd_passes(x, dt, ld, bm, cm, states, dy, dh, tile=tile)
    for name, g, w in zip(("dx", "ddt", "dld", "dbm", "dcm", "dh0"), got, want):
        err = float((g - w).abs().max())
        assert err <= TOL * max(1.0, float(w.abs().max())), (name, err)
