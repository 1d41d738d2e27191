"""The passes of the two backward kernels, written out in torch.

``csrc/flash_attention_bwd.cu`` (B4-bwd) and ``csrc/mamba_scan_bwd.cu``
(B5-bwd) run only on a GPU.  These functions follow them pass for pass and
tile for tile on the CPU, with the arithmetic left to the caller:
``tests/test_torch_bwd_emulation.py`` runs them in float64 against autograd
of the plain versions (is the algorithm right?), and
``tests/test_torch_bwd_tc.py`` with the tensor cores' arithmetic (bf16
operands for B4-bwd, 3xTF32 for B5-bwd) against ``jax.vjp`` of the JAX
package's references (is the rounding good enough?).
"""

from __future__ import annotations

import torch

NEG_INF = -2.0**30
LOG2E = 1.4426950408889634


def visible(q_pos, k_pos, sq, sk, causal, window):
    """B4's mask: key k is seen by query q (absolute indices)."""
    ok = (k_pos[None, :] < sk) & (q_pos[:, None] < sq)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        ok &= k_pos[None, :] > q_pos[:, None] - window
    return ok


def key_tiles(q0, rows, sq, sk, causal, window, blk=64):
    """The key tiles a query tile [q0, q0 + rows) can see (the kernels'
    ``key_tiles``)."""
    q_last = min(q0 + rows, sq) - 1
    k_hi = min(sk, q_last + 1) if causal else sk
    k_lo = max(0, q0 - window + 1) if window is not None else 0
    return range(k_lo // blk, (k_hi - 1) // blk + 1 if q0 < sq and k_hi > k_lo else k_lo // blk)


def query_tiles(k0, rows, sq, sk, causal, window, blk=64):
    """The query tiles that can see a key tile [k0, k0 + rows) (the kernels'
    ``query_tiles``)."""
    k_last = min(k0 + rows, sk) - 1
    q_lo = k0 if causal else 0
    q_hi = min(sq, k_last + window) if window is not None else sq
    return range(q_lo // blk, (q_hi - 1) // blk + 1 if k0 < sk and q_hi > q_lo else q_lo // blk)


def flash_lse_online(q, k, *, causal, window, scale, blk=64):
    """B4's forward as it writes L: the online walk over the key tiles, the
    running max and sum in q's dtype, L = m + log l (0 for a row with no
    visible key).  Head-major tensors; returns (B, H, Sq)."""
    b, h, sq, _ = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    kq = k.repeat_interleave(h // hkv, 1)
    lse = torch.zeros((b, h, sq), dtype=q.dtype)
    for q0 in range(0, sq, blk):
        rows = slice(q0, min(q0 + blk, sq))
        n = rows.stop - q0
        m = torch.full((b, h, n), NEG_INF, dtype=q.dtype)
        l = torch.zeros((b, h, n), dtype=q.dtype)
        for kt in key_tiles(q0, blk, sq, sk, causal, window, blk):
            cols = slice(kt * blk, min(kt * blk + blk, sk))
            ok = visible(torch.arange(q0, rows.stop), torch.arange(cols.start, cols.stop),
                         sq, sk, causal, window)
            s = torch.where(ok, q[:, :, rows] @ kq[:, :, cols].transpose(-1, -2) * scale, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.where(ok, torch.exp(s - m_new[..., None]), 0.0)
            l = l * torch.exp(m - m_new) + p.sum(-1)
            m = m_new
        lse[:, :, rows] = torch.where(l > 0, m + torch.log(torch.where(l > 0, l, 1.0)), 0.0)
    return lse


def _probs_exp(s, lse, scale):
    return torch.exp(s * scale - lse)


def flash_bwd_passes(q, k, v, o, lse, dout, *, causal, window, scale, blk=64,
                     probs=_probs_exp, operand=lambda t: t, dtype=None):
    """B4-bwd's three launches on head-major tensors: D = rowsum(dout o o);
    dk/dv per (64-key tile, KV head), the group's query heads in order and
    the query tiles that see the keys; dq per 64-query tile over its key
    tiles.  ``probs(s, lse, scale)`` gives P from the raw scores and L (both
    in the arithmetic's dtype), ``operand`` rounds P and dS where the kernel
    multiplies them on the tensor cores, ``dtype`` (default q's) is the
    arithmetic's.  Returns ``(dq, dk, dv)`` in that dtype, unrounded."""
    dtype = dtype or q.dtype
    q, k, v, o, dout, lse = (t.to(dtype) for t in (q, k, v, o, dout, lse))
    b, h, sq, hd = q.shape
    hkv, sk, hd_v = k.shape[1], k.shape[2], v.shape[3]
    rep = h // hkv
    delta = (dout * o).sum(-1)                                   # 1. D
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for k0 in range(0, sk, blk):                                  # 2. dk, dv
        cols = slice(k0, min(k0 + blk, sk))
        for g in range(hkv):
            adk = torch.zeros((b, cols.stop - k0, hd), dtype=dtype)
            adv = torch.zeros((b, cols.stop - k0, hd_v), dtype=dtype)
            for hq in range(g * rep, g * rep + rep):
                for qt in query_tiles(k0, blk, sq, sk, causal, window, blk):
                    rows = slice(qt * blk, min(qt * blk + blk, sq))
                    ok = visible(torch.arange(rows.start, rows.stop),
                                 torch.arange(k0, cols.stop), sq, sk, causal, window).T
                    st = k[:, g, cols] @ q[:, hq, rows].transpose(-1, -2)     # S^T
                    pt = torch.where(ok, probs(st, lse[:, hq, None, rows], scale), 0.0)
                    dpt = v[:, g, cols] @ dout[:, hq, rows].transpose(-1, -2)  # dP^T
                    dst = pt * (dpt - delta[:, hq, None, rows])
                    adv = adv + operand(pt) @ dout[:, hq, rows]
                    adk = adk + operand(dst) @ q[:, hq, rows]
            dk[:, g, cols] = adk * scale
            dv[:, g, cols] = adv
    dq = torch.zeros_like(q)
    kq, vq = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
    for q0 in range(0, sq, blk):                                  # 3. dq
        rows = slice(q0, min(q0 + blk, sq))
        acc = torch.zeros((b, h, rows.stop - q0, hd), dtype=dtype)
        for kt in key_tiles(q0, blk, sq, sk, causal, window, blk):
            cols = slice(kt * blk, min(kt * blk + blk, sk))
            ok = visible(torch.arange(q0, rows.stop), torch.arange(cols.start, cols.stop),
                         sq, sk, causal, window)
            s = q[:, :, rows] @ kq[:, :, cols].transpose(-1, -2)
            p = torch.where(ok, probs(s, lse[:, :, rows, None], scale), 0.0)
            dp = dout[:, :, rows] @ vq[:, :, cols].transpose(-1, -2)
            acc = acc + operand(p * (dp - delta[:, :, rows, None])) @ kq[:, :, cols]
        dq[:, :, rows] = acc * scale
    return dq, dk, dv


def _matmul(a, b):
    return a @ b


def mamba_bwd_passes(x, dt, ld, bm, cm, states, dy, dh, *, tile=64, mm=_matmul):
    """B5-bwd's six launches on head-major tensors in the inputs' dtype;
    ``states[:, :, c]`` is the state entering chunk c, ``mm`` takes every
    product.  Returns ``(dx, ddt, dld, dbm, dcm, dh0)``."""
    b, h, nc, q, p = x.shape
    n = bm.shape[-1]
    dtype = x.dtype
    nt = -(-q // tile)
    cum = torch.cumsum(ld, -1)
    cum_end = cum[..., -1]
    gram = mm(cm, bm.transpose(-1, -2))                                   # 1. G = C B^T
    gout = mm((dy * torch.exp(cum)[..., None]).transpose(-1, -2), cm[:, None])  # 2. dstate
    g = dh.clone()                                                        # 3. carry
    for c in reversed(range(nc)):
        part = gout[:, :, c].clone()
        gout[:, :, c] = g
        g = g * torch.exp(cum_end[:, :, c])[..., None, None] + part
    dh0 = g

    def rows(i):
        return slice(i * tile, min(q, i * tile + tile))

    dx, ddt, own = torch.zeros_like(x), torch.zeros_like(dt), torch.zeros_like(dt)
    mrow = torch.zeros((b, h, nc, nt, q), dtype=dtype)
    tpart = torch.zeros((b, h, nc, nt), dtype=dtype)
    dbm = torch.zeros((b, nc, q, n), dtype=dtype)
    dcp = torch.zeros((b, nc, nt, q, n), dtype=dtype)
    for i in range(nt):                                                   # 4. main
        s = rows(i)
        sp = torch.arange(s.start, s.stop)
        db = torch.zeros((b, nc, s.stop - s.start, n), dtype=dtype)
        dc = {j: 0.0 for j in range(i, nt)}
        for hh in range(h):                                               # heads in order
            xs, dts, gh, hc = x[:, hh, :, s], dt[:, hh, :, s], gout[:, hh], states[:, hh]
            es = torch.exp(cum_end[:, hh, :, None] - cum[:, hh, :, s])
            et = torch.exp(cum[:, hh, :, s])
            # the state terms (t tile j = i)
            gb = mm(es[..., None] * bm[:, :, s], gh.transpose(-1, -2))
            t_s = dts * (xs * gb).sum(-1)
            du = gb
            db = db + mm((es * dts)[..., None] * xs, gh)
            dc[i] = dc[i] + mm(et[..., None] * dy[:, hh, :, s], hc)
            r_t = et * (dy[:, hh, :, s] * mm(cm[:, :, s], hc.transpose(-1, -2))).sum(-1)
            mcol = 0.0
            for j in range(i, nt):
                t = rows(j)
                tp = torch.arange(t.start, t.stop)
                d = mm(dy[:, hh, :, t], xs.transpose(-1, -2)) * dts[..., None, :]   # D_ji
                ok = sp[None, :] <= tp[:, None]
                dec = cum[:, hh, :, t, None] - cum[:, hh, :, None, s]
                a = torch.where(ok, torch.exp(torch.where(ok, dec, 0.0)), 0.0)
                w, v_ = gram[:, :, t, s] * a, d * a
                m = w * d
                mrow[:, hh, :, i, t] = m.sum(-1)
                mcol = mcol + m.sum(-2)
                du = du + mm(w.transpose(-1, -2), dy[:, hh, :, t])
                db = db + mm(v_.transpose(-1, -2), cm[:, :, t])
                dc[j] = dc[j] + mm(v_, bm[:, :, s])
            dx[:, hh, :, s] = dts[..., None] * du
            ddt[:, hh, :, s] = (xs * du).sum(-1)
            own[:, hh, :, s] = r_t - t_s - mcol
            tpart[:, hh, :, i] = t_s.sum(-1)
        dbm[:, :, s] = db
        for j, part in dc.items():
            dcp[:, :, i, rows(j)] = part
    dcum = own.clone()                                                    # 5. finish
    for t in range(q):
        for i in range(t // tile + 1):
            dcum[..., t] = dcum[..., t] + mrow[..., i, t]
    extra = tpart.sum(-1) + torch.exp(cum_end) * (gout * states).sum((-1, -2))
    dld = extra[..., None] + torch.flip(torch.cumsum(torch.flip(dcum, (-1,)), -1), (-1,))
    dcm = torch.zeros_like(dbm)                                           # 6. dcsum
    for t in range(q):
        for i in range(t // tile + 1):
            dcm[:, :, t] = dcm[:, :, t] + dcp[:, :, i, t]
    return dx, ddt, dld, dbm, dcm, dh0
