"""CPU emulation of the two backward kernels' arithmetic, held against
autograd of the plain versions.

``csrc/flash_attention_bwd.cu`` (B4-bwd) and ``csrc/mamba_scan_bwd.cu``
(B5-bwd) run only on a GPU.  Their algorithms are written out here in
torch, pass for pass and tile for tile, so a fault of the algorithm (a
wrong term, a tile range, a mask, the order of the reverse carry) shows on
the CPU before the card sees the kernels:

* B4-bwd: the ``D = rowsum(dout o o)`` pre-pass; launch 1 over query tiles
  (a first walk over the visible key tiles for the row log-sum-exp ``L``,
  a second for ``dq``); launch 2 over key tiles, walking the query heads of
  each KV head and the query tiles that can see the key tile, for
  ``dk``/``dv``.
* B5-bwd: each chunk's part of the state gradient, the reverse carry
  across chunks, the per-tile ``rows_s``/``rows_t`` passes with their parts
  of ``d cum``, and ``d ld`` as the reverse cumulative sum of ``d cum``.

The emulations run in float64; the plain versions compute in float32
whatever their inputs, so the two are held at 1e-5 relative to the largest
gradient (float32 rounding of the same function, ~1e-7 here): a missing or
wrong term is off by far more.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.ref import (
    NEG_INF, flash_attention_bwd_plain, flash_attention_plain, mamba_chunk_scan_bwd_plain,
    mamba_chunk_scan_plain,
)

F64 = torch.float64
TOL = 1e-5  # the plain versions' float32 rounding, relative to the largest gradient


def _visible(q_pos, k_pos, sq, sk, causal, window):
    ok = (k_pos[None, :] < sk) & (q_pos[:, None] < sq)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        ok &= k_pos[None, :] > q_pos[:, None] - window
    return ok


def flash_bwd_emulated(q, k, v, o, dout, *, causal, window, scale, blk=64):
    """B4-bwd's two launches, tile by tile.  Head-major float64 tensors."""
    b, h, sq, hd = q.shape
    hkv, sk, hd_v = k.shape[1], k.shape[2], v.shape[3]
    rep = h // hkv
    delta = (dout * o).sum(-1)                                  # the D pre-pass
    lse = torch.zeros((b, h, sq), dtype=q.dtype)
    dq = torch.zeros_like(q)
    kq, vq = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
    # launch 1: one block per query tile
    for q0 in range(0, sq, blk):
        q_pos = torch.arange(q0, q0 + blk)
        rows = slice(q0, min(q0 + blk, sq))
        n = rows.stop - rows.start
        q_last = rows.stop - 1
        k_hi = min(sk, q_last + 1) if causal else sk
        k_lo = max(0, q0 - window + 1) if window is not None else 0
        tiles = range(k_lo // blk, (k_hi - 1) // blk + 1 if k_hi > k_lo else k_lo // blk)
        m = torch.full((b, h, n), NEG_INF, dtype=q.dtype)
        l = torch.zeros((b, h, n), dtype=q.dtype)
        for kt in tiles:
            k0 = kt * blk
            cols = slice(k0, min(k0 + blk, sk))
            ok = _visible(q_pos[:n], torch.arange(cols.start, cols.stop), sq, sk, causal, window)
            s = torch.where(ok, q[:, :, rows] @ kq[:, :, cols].transpose(-1, -2) * scale, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.where(ok, torch.exp(s - m_new[..., None]), 0.0)
            l = l * torch.exp(m - m_new) + p.sum(-1)
            m = m_new
        lr = torch.where(l > 0, m + torch.log(torch.where(l > 0, l, 1.0)), 0.0)
        lse[:, :, rows] = lr
        acc = torch.zeros((b, h, n, hd), dtype=q.dtype)
        for kt in tiles:
            k0 = kt * blk
            cols = slice(k0, min(k0 + blk, sk))
            ok = _visible(q_pos[:n], torch.arange(cols.start, cols.stop), sq, sk, causal, window)
            s = q[:, :, rows] @ kq[:, :, cols].transpose(-1, -2)
            p = torch.where(ok, torch.exp(s * scale - lr[..., None]), 0.0)
            dp = dout[:, :, rows] @ vq[:, :, cols].transpose(-1, -2)
            acc = acc + (p * (dp - delta[:, :, rows, None])) @ kq[:, :, cols]
        dq[:, :, rows] = acc * scale
    # launch 2: one block per (key tile, KV head), its group's heads in order
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for k0 in range(0, sk, blk):
        cols = slice(k0, min(k0 + blk, sk))
        k_last = cols.stop - 1
        q_lo = k0 if causal else 0
        q_hi = min(sq, k_last + window) if window is not None else sq
        tiles = range(q_lo // blk, (q_hi - 1) // blk + 1 if q_hi > q_lo else q_lo // blk)
        for g in range(hkv):
            adk = torch.zeros((b, cols.stop - k0, hd), dtype=q.dtype)
            adv = torch.zeros((b, cols.stop - k0, hd_v), dtype=q.dtype)
            for hh in range(rep):
                hq = g * rep + hh
                for qt in tiles:
                    rows = slice(qt * blk, min(qt * blk + blk, sq))
                    ok = _visible(torch.arange(rows.start, rows.stop),
                                  torch.arange(cols.start, cols.stop), sq, sk, causal, window)
                    s = q[:, hq, rows] @ k[:, g, cols].transpose(-1, -2)
                    p = torch.where(ok, torch.exp(s * scale - lse[:, hq, rows, None]), 0.0)
                    dp = dout[:, hq, rows] @ v[:, g, cols].transpose(-1, -2)
                    ds = p * (dp - delta[:, hq, rows, None])
                    adv = adv + p.transpose(-1, -2) @ dout[:, hq, rows]
                    adk = adk + ds.transpose(-1, -2) @ q[:, hq, rows]
            dk[:, g, cols] = adk * scale
            dv[:, g, cols] = adv
    return dq, dk, dv


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
    got = flash_bwd_emulated(q, k, v, o, dout, causal=causal, window=window, scale=scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        err = float((g - w).abs().max())
        assert err <= TOL * max(1.0, float(w.abs().max())), (name, err)


def mamba_bwd_emulated(x, dt, ld, bm, cm, states, dy, dh, *, tile=64):
    """B5-bwd's six launches, tile by tile.  Head-major float64 tensors;
    ``states[:, :, c]`` is the state entering chunk c."""
    b, h, nc, q, p = x.shape
    cum = torch.cumsum(ld, -1)
    # 1. dstate: each chunk's own part of the state gradient, and cum_end
    gout = torch.einsum("bhcq,bhcqp,bcqn->bhcpn", torch.exp(cum), dy, cm)
    cum_end = cum[..., -1]
    # 2. carry, in reverse chunk order: gout[c] becomes g_{c+1}
    g = dh.clone()
    for c in reversed(range(nc)):
        part = gout[:, :, c].clone()
        gout[:, :, c] = g
        g = g * torch.exp(cum_end[:, :, c])[..., None, None] + part
    dh0 = g
    dx, ddt = torch.zeros_like(x), torch.zeros_like(dt)
    dcum_a, dcum_b = torch.zeros_like(dt), torch.zeros_like(dt)
    n_tiles = -(-q // tile)
    tpart = torch.zeros((b, h, nc, n_tiles), dtype=x.dtype)
    dbp = torch.zeros((b, h, nc, q, bm.shape[-1]), dtype=x.dtype)
    dcp = torch.zeros_like(dbp)
    u = dt[..., None] * x
    bmh, cmh = bm[:, None], cm[:, None]
    gram = cmh @ bmh.transpose(-1, -2)                 # (b, 1, nc, t, s)

    def gate(t_sl, s_sl):
        tp, sp = torch.arange(t_sl.start, t_sl.stop), torch.arange(s_sl.start, s_sl.stop)
        ok = tp[:, None] >= sp[None, :]
        dec = cum[..., t_sl, None] - cum[..., None, s_sl]
        return torch.where(ok, torch.exp(torch.where(ok, dec, 0.0)), 0.0)

    def rows(i):
        return slice(i * tile, min(q, i * tile + tile))

    # 3. rows_s: one block per s tile, its t tiles in order
    es = torch.exp(cum_end[..., None] - cum)                                 # (b,h,nc,q)
    for st in range(n_tiles):
        s_sl = rows(st)
        du = 0.0
        db = 0.0
        msum = 0.0
        for tt in range(st, n_tiles):
            t_sl = rows(tt)
            a = gate(t_sl, s_sl)                                             # (b,h,nc,t,s)
            w = gram[..., t_sl, s_sl] * a
            d = dy[..., t_sl, :] @ u[..., s_sl, :].transpose(-1, -2)         # (b,h,nc,t,s)
            du = du + w.transpose(-1, -2) @ dy[..., t_sl, :]
            db = db + (d * a).transpose(-1, -2) @ cmh[..., t_sl, :]
            msum = msum + (w * d).sum(-2)
        gb = bmh[..., s_sl, :] @ gout.transpose(-1, -2)                      # (g B_s)
        du = du + es[..., s_sl, None] * gb
        db = db + es[..., s_sl, None] * (u[..., s_sl, :] @ gout)
        t_s = es[..., s_sl] * (u[..., s_sl, :] * gb).sum(-1)
        dx[..., s_sl, :] = dt[..., s_sl, None] * du
        ddt[..., s_sl] = (x[..., s_sl, :] * du).sum(-1)
        dbp[..., s_sl, :] = db
        dcum_a[..., s_sl] = -msum - t_s
        tpart[..., st] = t_s.sum(-1)
    # 4. rows_t: one block per t tile, its s tiles in order
    for tt in range(n_tiles):
        t_sl = rows(tt)
        dc = 0.0
        msum = 0.0
        for st in range(tt + 1):
            s_sl = rows(st)
            a = gate(t_sl, s_sl)
            d = dy[..., t_sl, :] @ u[..., s_sl, :].transpose(-1, -2)
            dc = dc + (d * a) @ bmh[..., s_sl, :]
            msum = msum + (gram[..., t_sl, s_sl] * a * d).sum(-1)
        et = torch.exp(cum[..., t_sl])
        dc = dc + et[..., None] * (dy[..., t_sl, :] @ states)
        r_t = et * (dy[..., t_sl, :] * (cmh[..., t_sl, :] @ states.transpose(-1, -2))).sum(-1)
        dcp[..., t_sl, :] = dc
        dcum_b[..., t_sl] = msum + r_t
    # 5. finish: d cum_end's state terms, then the reverse cumulative sum
    dcum = dcum_a + dcum_b
    dcum[..., -1] += tpart.sum(-1) + torch.exp(cum_end) * (gout * states).sum((-1, -2))
    dld = torch.flip(torch.cumsum(torch.flip(dcum, (-1,)), -1), (-1,))
    # 6. heads
    return dx, ddt, dld, dbp.sum(1), dcp.sum(1), dh0


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
    got = mamba_bwd_emulated(x, dt, ld, bm, cm, states, dy, dh, tile=tile)
    for name, g, w in zip(("dx", "ddt", "dld", "dbm", "dcm", "dh0"), got, want):
        err = float((g - w).abs().max())
        assert err <= TOL * max(1.0, float(w.abs().max())), (name, err)
