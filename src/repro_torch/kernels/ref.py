"""Plain PyTorch versions of the attention and Mamba2-scan kernels.

Each computes, as ordinary tensor code on whatever device its inputs lie
on, the same function as its kernel (``csrc/flash_attention.cu``,
``csrc/mamba_scan.cu``):

* :func:`flash_attention_plain` — attention with the score rows of one
  query tile materialised in float32 at a time, masked by absolute index
  exactly as the kernel masks, fully-masked rows zeroed.  Counterpart of
  the JAX package's ``ref.flash_reference`` (which materialises all rows
  at once and does not zero fully-masked rows; no test shape has one).
* :func:`flash_attention_bwd_plain` — its backward: ``torch.autograd``
  through :func:`flash_attention_plain` (the plain version of
  ``csrc/flash_attention_bwd.cu``).
* :func:`mamba_chunk_scan_plain` — the Mamba2 SSD chunked scan, batched
  over (batch, head), walking the chunks in order.  Same function as the
  JAX package's token recurrence ``ref.mamba_chunk_scan_reference``,
  computed in the chunked form the kernel uses.
* :func:`mamba_chunk_scan_bwd_plain` — its backward, ``torch.autograd``
  through :func:`mamba_chunk_scan_plain` (the plain version of
  ``csrc/mamba_scan_bwd.cu``).
* :func:`mcop_phase_plain` — one MinCutPhase (the paper's Algorithm 3),
  the plain version of ``csrc/mcop_phase.cu``'s phase kernel.  Transcribes
  the JAX package's ``ref.mcop_phase_reference`` and the Pallas body it
  checks.
* :func:`mcop_phase_step_plain` — the plain version of its step kernel:
  one phase of ``kernels.ops.mcop_min_cut``'s loop on the loop's state
  (``kernels.mcop_phase.LoopState``) and the merge after it.

The kernel wrappers take these for CPU tensors; ``chip_smoke.py`` holds
each kernel against its plain version on the card.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.mcop_phase import NEG_INF as MCOP_NEG_INF
from repro_torch.kernels.mcop_phase import triangle_index, unpack_triangle

__all__ = ["NEG_INF", "attention_output_like", "flash_attention_bwd_plain",
           "flash_attention_lse_plain", "flash_attention_plain", "mamba_chunk_scan_bwd_plain", "mamba_chunk_scan_plain",
           "mcop_phase_plain", "mcop_phase_step_plain"]

NEG_INF = -2.0**30
_PLAIN_BLOCK_Q = 1024  # query rows scored at a time: bounds memory, not the result


def attention_output_like(q: torch.Tensor, hd_v: int) -> torch.Tensor:
    """An empty (B, H, Sq, hd_v) output: ``empty_like(q)`` at equal widths,
    else dense in q's order of the first three dims (model-layout ``(B, S,
    H, ·)`` storage for a ``transpose(1, 2)`` view)."""
    if hd_v == q.shape[3]:
        return torch.empty_like(q)
    b, h, sq, _ = q.shape
    if q.stride(1) < q.stride(2):
        return torch.empty((b, sq, h, hd_v), dtype=q.dtype, device=q.device).transpose(1, 2)
    return torch.empty((b, h, sq, hd_v), dtype=q.dtype, device=q.device)


def flash_attention_plain(
    q: torch.Tensor,   # (B, H, Sq, hd)
    k: torch.Tensor,   # (B, Hkv, Sk, hd)
    v: torch.Tensor,   # (B, Hkv, Sk, hd_v)
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Attention, head-major; returns (B, H, Sq, hd_v) in q's dtype (``hd_v``
    may differ from q's and k's ``hd``, as MLA's value heads do).

    Query head ``h`` reads KV head ``h // (H // Hkv)``.  A key ``k`` is
    seen by query ``q`` iff ``k <= q`` (causal) and ``k > q - window``
    (window), both absolute indices.  Products and the softmax are float32,
    one tile of query rows at a time."""
    b, h, sq, hd = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    rep = h // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)
    k_pos = torch.arange(sk, device=q.device)
    hd_v = v.shape[3]
    out = attention_output_like(q, hd_v)
    for q0 in range(0, sq, _PLAIN_BLOCK_Q):
        q1 = min(sq, q0 + _PLAIN_BLOCK_Q)
        bq = q1 - q0
        qf = q[:, :, q0:q1].to(torch.float32).reshape(b, hkv, rep * bq, hd)
        s = torch.matmul(qf, kf.transpose(-1, -2)).view(b, h, bq, sk) * scale
        q_pos = torch.arange(q0, q1, device=q.device)
        mask = torch.ones((bq, sk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= k_pos[None, :] <= q_pos[:, None]
        if window is not None:
            mask &= k_pos[None, :] > q_pos[:, None] - window
        s = torch.where(mask, s, NEG_INF)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        p = torch.where(mask, p, 0.0)  # a fully-masked row is zero, not uniform
        l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        o = torch.matmul(p.view(b, hkv, rep * bq, sk), vf).view(b, h, bq, hd_v)
        out[:, :, q0:q1] = (o / l).to(q.dtype)
    return out


def flash_attention_lse_plain(
    q: torch.Tensor,   # (B, H, Sq, hd)
    k: torch.Tensor,   # (B, Hkv, Sk, hd)
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Each row's log-sum-exp of the scaled scores over its visible keys,
    ``(B, H, Sq)`` float32 in base e, 0 for a row with no visible key: the
    ``L`` that B4 writes for its backward (``P = exp(scale q·k − L)``)."""
    b, h, sq, hd = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    rep = h // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    kf = k.to(torch.float32)
    k_pos = torch.arange(sk, device=q.device)
    out = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    for q0 in range(0, sq, _PLAIN_BLOCK_Q):
        q1 = min(sq, q0 + _PLAIN_BLOCK_Q)
        bq = q1 - q0
        qf = q[:, :, q0:q1].to(torch.float32).reshape(b, hkv, rep * bq, hd)
        s = torch.matmul(qf, kf.transpose(-1, -2)).view(b, h, bq, sk) * scale
        q_pos = torch.arange(q0, q1, device=q.device)
        mask = torch.ones((bq, sk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= k_pos[None, :] <= q_pos[:, None]
        if window is not None:
            mask &= k_pos[None, :] > q_pos[:, None] - window
        lse = torch.logsumexp(torch.where(mask, s, -math.inf), dim=-1)
        out[:, :, q0:q1] = torch.where(mask.any(-1), lse, 0.0)
    return out


def _grads(fn, inputs: tuple, outputs_grad: tuple) -> tuple:
    """The gradients of ``fn(*inputs)`` with respect to every input, for the
    given output gradients (``None`` for an output that has none), by
    ``torch.autograd`` on detached copies of the inputs."""
    with torch.enable_grad():
        leaves = tuple(t.detach().requires_grad_() for t in inputs)
        outs = fn(*leaves)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, g) for o, g in zip(outs, outputs_grad) if g is not None]
        grads = torch.autograd.grad([o for o, _ in pairs], leaves, [g for _, g in pairs],
                                    allow_unused=True)
    return tuple(torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads))


def flash_attention_bwd_plain(
    q: torch.Tensor,     # (B, H, Sq, hd)
    k: torch.Tensor,     # (B, Hkv, Sk, hd)
    v: torch.Tensor,     # (B, Hkv, Sk, hd_v)
    dout: torch.Tensor,  # (B, H, Sq, hd_v)
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of :func:`flash_attention_plain` for the output
    gradient ``dout``: autograd through the plain version."""
    return _grads(lambda q_, k_, v_: flash_attention_plain(
        q_, k_, v_, causal=causal, window=window, scale=scale), (q, k, v), (dout,))


def mamba_chunk_scan_bwd_plain(x, dt, ld, bm, cm, h0, dy, dh=None) -> tuple:
    """``(dx, ddt, dld, dbm, dcm, dh0)`` of :func:`mamba_chunk_scan_plain`
    for the gradients ``dy`` of ``y`` and ``dh`` of the final state (``None``:
    zero): autograd through the plain version."""
    return _grads(mamba_chunk_scan_plain, (x, dt, ld, bm, cm, h0), (dy, dh))


def mamba_chunk_scan_plain(
    x: torch.Tensor,    # (B, H, NC, Q, P)
    dt: torch.Tensor,   # (B, H, NC, Q)
    ld: torch.Tensor,   # (B, H, NC, Q)  log decay dt·a (a < 0)
    bm: torch.Tensor,   # (B, NC, Q, N)
    cm: torch.Tensor,   # (B, NC, Q, N)
    h0: torch.Tensor,   # (B, H, P, N)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD scan in float32: ``y (B, H, NC, Q, P)``, final ``h``.

    Per chunk, with ``cum`` the within-chunk cumulative sum of ``ld``:
    ``y_t = Σ_{s≤t} exp(cum_t − cum_s)·(C_t·B_s)·dt_s·x_s + exp(cum_t)·C_t·hᵀ``
    with ``h`` the state entering the chunk, then
    ``h ← h·exp(cum_end) + Σ_s exp(cum_end − cum_s)·dt_s·x_s ⊗ B_s``.
    The decay is exponentiated only where ``s ≤ t`` (there it is ≤ 0)."""
    x, dt, ld, bm, cm = (t.to(torch.float32) for t in (x, dt, ld, bm, cm))
    nc, q = x.shape[2], x.shape[3]
    cum = torch.cumsum(ld, dim=-1)                                   # (B,H,NC,Q)
    causal = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    y = torch.empty_like(x)
    h = h0.to(torch.float32).clone()
    for c in range(nc):
        cc = cum[:, :, c]                                            # (B,H,Q)
        decay = cc[..., :, None] - cc[..., None, :]                  # (B,H,Q,Q)
        gate = torch.exp(torch.where(causal, decay, -math.inf))
        scores = torch.matmul(cm[:, c], bm[:, c].transpose(-1, -2))  # (B,Q,Q)
        w = scores[:, None] * gate * dt[:, :, c][..., None, :]
        ch = torch.matmul(cm[:, c][:, None], h.transpose(-1, -2))    # (B,H,Q,P)
        y[:, :, c] = torch.matmul(w, x[:, :, c]) + torch.exp(cc)[..., None] * ch
        tail = torch.exp(cc[..., -1:] - cc) * dt[:, :, c]           # (B,H,Q)
        s_n = torch.matmul(x[:, :, c].transpose(-1, -2),
                           bm[:, c][:, None] * tail[..., None])      # (B,H,P,N)
        h = h * torch.exp(cc[..., -1])[..., None, None] + s_n
    return y, h


def mcop_phase_plain(
    adj: torch.Tensor,            # (n, n) f32 — current (possibly merged) graph
    gains: torch.Tensor,          # (n,) f32 — w_local − w_cloud
    alive: torch.Tensor,          # (n,) bool
    src: int,                     # anchor vertex
    c_local_total: float | torch.Tensor,  # C_local of the original graph
) -> tuple[torch.Tensor, int, int]:
    """One MinCutPhase in float32; returns ``(cut (), s, t)``.

    Starting from ``A = {src} ∩ alive`` and ``conn = adj[src]``, absorb
    exactly ``n_alive − 1`` vertices, each the first-index argmax of
    ``conn − gains`` over the alive vertices not yet in ``A`` (``NEG_INF``
    elsewhere), adding its row to ``conn``; ``(s, t)`` are the last two
    absorbed.  The cut is Eq. 10: ``C_local − gains[t] + Σ adj[t]·alive``.
    With one alive vertex ``s == t == src``."""
    f32 = torch.float32
    adj = adj.to(f32)
    gains = gains.to(f32)
    alive = alive.to(torch.bool)
    idx = torch.arange(adj.shape[0], device=adj.device)
    n_alive = int(alive.sum())
    in_a = alive & (idx == src)
    conn = adj[src]
    s = t = int(src)
    for _ in range(n_alive - 1):
        scores = torch.where(alive & ~in_a, conn - gains, MCOP_NEG_INF)
        v = int(scores.argmax())  # the first maximum wins ties
        in_a = in_a | (idx == v)
        conn = conn + adj[v]
        s, t = t, v
    comm = (adj[t] * alive.to(f32)).sum()
    ctot = torch.as_tensor(c_local_total, dtype=f32, device=adj.device)
    return ctot - gains[t] + comm, s, t


def mcop_phase_step_plain(state, phase: int, c_local_total: float) -> None:
    """Phase ``phase`` of ``mcop_min_cut``'s loop on a ``LoopState`` whose
    tensors lie on the CPU, in place: :func:`mcop_phase_plain` on the
    working matrix (unpacked, or the full one) from the state's anchor; a
    strictly smaller cut becomes the best, with the members of ``t``
    (``label == t``) as its cloud side; ``t`` is merged into ``s`` (on the
    packed matrix row ``s`` += row ``t`` off ``{s, t}`` and row ``t``
    zeroed, the full matrix's Algorithm 1 in the same f32 additions; on the
    full matrix also column ``s`` += column ``t``, ``adj[s, s] = 0`` and
    column ``t`` zeroed), ``wl``/``wc`` of ``t`` are added into ``s``,
    ``t``'s members are relabelled ``s``, the anchor follows a merged source,
    and ``(cut bits, s, t)`` go to row ``phase`` of the log."""
    n = state.n
    src = int(state.scal[0])
    full = state.packed[: n * n].view(n, n) if state.full else None
    cut, s, t = mcop_phase_plain(full if state.full else unpack_triangle(state.packed, n),
                                 state.wl - state.wc, state.alive.to(torch.bool), src,
                                 c_local_total)
    best = state.scal[1:2].view(torch.float32)
    if bool(cut < best[0]):
        best[0] = cut
        state.cloud[:] = (state.label == t).to(torch.uint8)
    idx = torch.arange(n)
    rest = (idx != s) & (idx != t)
    if state.full:
        full[s, rest] = full[s, rest] + full[t, rest]
        full[rest, s] = full[rest, s] + full[rest, t]
        full[s, s] = 0.0
        full[t, :] = 0.0
        full[:, t] = 0.0
    else:
        on_s, on_t = triangle_index(s, idx, n), triangle_index(t, idx, n)
        packed = state.packed
        packed[on_s[rest]] = packed[on_s[rest]] + packed[on_t[rest]]
        packed[on_t[idx != t]] = 0.0
    state.wl[s] += state.wl[t]
    state.wc[s] += state.wc[t]
    state.alive[t] = 0
    state.label[state.label == t] = s
    if t == src:
        state.scal[0] = s
    state.log[3 * phase] = cut.reshape(1).view(torch.int32)[0]
    state.log[3 * phase + 1] = s
    state.log[3 * phase + 2] = t
