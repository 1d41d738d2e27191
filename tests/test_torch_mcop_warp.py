"""The warp-per-graph MCOP kernels' arithmetic, emulated on the CPU.

``csrc/sw_common.cuh`` solves a graph with one warp: lane ``l`` owns
columns ``l + 32 k`` (``k < CPL``), an absorb step picks its vertex with
two ``redux.sync`` over an order-preserving ``uint32`` key of the f32
score (the largest key, then the smallest column among the lanes that
hold it), sums are a lane's columns in ascending order followed by a
butterfly over the lanes, and the adjacency is the packed upper triangle
of the symmetric matrix.  None of that runs here (no GPU), so this file
emulates it in torch and numpy and holds the emulation to what the kernels
must compute:

* the two-step argmax equals the first-index argmax of the plain versions
  (``torch.argmax``) on vectors with ties, ``±0.0``, sentinels and lanes
  that hold nothing but sentinels, at every columns-per-lane size;
* the packed index map (``kernels.mcop_phase.triangle_index``,
  ``pack_triangle``, ``unpack_triangle``) and the Algorithm-1 merge on
  packed storage equal the full-matrix merge of ``stoer_wagner_plain``
  after every merge, bit for bit;
* a solve over the packed layout in the kernel's order of operations gives
  the masks of JAX's ``mcop_stoer_wagner_kernel`` (interpret mode) and
  cuts within ``rel=1e-5`` of it (f32 sums in another order).
"""

import numpy as np
import pytest
import torch

from repro.kernels import mcop_phase as JK
import repro_torch.core as T
from repro_torch.kernels import mcop_phase as TK
from repro_torch.kernels.ref import mcop_phase_step_plain

NEG_INF = np.float32(TK.NEG_INF)
LANES = np.arange(32)
SIZES = (5, 32, 64, 200, 256, 335)


def warp_cpl(n: int) -> int:
    """Columns a lane holds (``sw_common.cuh:warp_cpl``)."""
    return next(c for bound, c in ((32, 1), (64, 2), (128, 4), (256, 8), (352, 11))
                if n <= bound)


def score_key(x: torch.Tensor) -> torch.Tensor:
    """``sw_common.cuh:score_key`` in int64: ``-0.0`` as ``+0.0``, then the
    sign-magnitude bits mapped to an order-preserving unsigned key."""
    u = x.to(torch.float32).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = torch.where(u == 0x80000000, 0, u)
    return torch.where(u >= 0x80000000, 0xFFFFFFFF - u, u | 0x80000000)


def lane_grid(vec: torch.Tensor, n: int, fill) -> torch.Tensor:
    """``(CPL, 32)`` with ``[k, lane]`` = column ``lane + 32 k`` (``fill``
    for the columns past ``n``)."""
    cpl = warp_cpl(n)
    out = torch.full((cpl * 32,), fill, dtype=vec.dtype)
    out[:n] = vec
    return out.view(cpl, 32)


def warp_argmax(scores: torch.Tensor, cand: torch.Tensor) -> int:
    """The kernel's absorb choice: each lane's first-index best over its
    columns (non-candidates and columns past n score the sentinel), then
    ``__reduce_max_sync`` of the keys and ``__reduce_min_sync`` of the
    columns of the lanes that hold the maximum."""
    n = scores.shape[0]
    keys = score_key(lane_grid(torch.where(cand, scores, torch.tensor(NEG_INF)), n, NEG_INF))
    k_best = keys.argmax(dim=0)  # first k: the lane's lowest column on ties
    lane_key = keys[k_best, torch.arange(32)]
    lane_idx = torch.arange(32) + 32 * k_best
    return int(lane_idx[lane_key == lane_key.max()].min())


def warp_sum(values: np.ndarray, take: np.ndarray) -> np.float32:
    """``sw_common.cuh:warp_sum`` over the lane partials: each lane adds its
    taken columns in ascending order, then the butterfly ``o = 16 .. 1``."""
    n = values.shape[0]
    part = np.zeros(32, np.float32)
    for k in range(warp_cpl(n)):
        j = LANES + 32 * k
        ok = j < n
        add = np.zeros(32, bool)
        add[ok] = take[j[ok]]
        part[add] = part[add] + values[j[add]].astype(np.float32)
    for o in (16, 8, 4, 2, 1):
        part = part + part[LANES ^ o]
    assert (part == part[0]).all()  # every lane holds the same bits
    return part[0]


# ---------------------------------------------------------------------------
# The two-step argmax
# ---------------------------------------------------------------------------


def _score_cases(n: int, seed: int):
    """(scores, candidates) vectors that stress the tie rules."""
    rng = np.random.default_rng(seed)
    ints = rng.integers(-3, 4, n).astype(np.float32)  # many exact ties
    yield "ties", ints, rng.random(n) < 0.7
    zeros = np.where(rng.random(n) < 0.5, np.float32(-0.0), np.float32(0.0))
    yield "signed_zeros", zeros, np.ones(n, bool)
    mixed = np.where(rng.random(n) < 0.3, np.float32(-0.0), ints)
    yield "zeros_and_negatives", np.minimum(mixed, 0).astype(np.float32), rng.random(n) < 0.8
    cont = rng.normal(0, 1e3, n).astype(np.float32)
    yield "continuous", cont, rng.random(n) < 0.5
    sparse = np.zeros(n, bool)  # one candidate: every other lane holds sentinels only
    sparse[rng.integers(0, n)] = True
    yield "one_candidate", ints, sparse
    yield "all_sentinel", ints, np.zeros(n, bool)
    yield "sentinel_valued", np.full(n, NEG_INF), rng.random(n) < 0.5
    late = np.full(n, -5.0, np.float32)  # the maximum tied in the last lanes only
    late[-1] = late[n // 2] = 7.0
    yield "late_tie", late, np.ones(n, bool)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("seed", range(3))
def test_two_step_argmax_is_the_first_index_argmax(n, seed):
    for name, scores, cand in _score_cases(n, seed):
        s, c = torch.from_numpy(scores), torch.from_numpy(cand)
        want = int(torch.where(c, s, torch.tensor(NEG_INF)).argmax())
        assert warp_argmax(s, c) == want, (name, n)


def test_score_key_orders_floats_and_merges_signed_zero():
    x = torch.tensor([-np.inf, -1e30, -2.5, -1e-38, -0.0, 0.0, 1e-45, 1.0, 1e30, np.inf],
                     dtype=torch.float32)
    k = score_key(x)
    assert k[4] == k[5]  # -0.0 == +0.0, as the float '>' has it
    distinct = torch.cat([k[:5], k[6:]])
    assert (distinct[1:] > distinct[:-1]).all()
    assert ((k >= 0) & (k <= 0xFFFFFFFF)).all()


@pytest.mark.parametrize("n", SIZES)
def test_lane_layout_covers_each_column_once(n):
    cols = lane_grid(torch.arange(n), n, -1)
    assert cols.shape == (warp_cpl(n), 32)
    assert sorted(cols[cols >= 0].tolist()) == list(range(n))
    assert (cols[cols >= 0] % 32 == torch.nonzero(cols >= 0)[:, 1]).all()


# ---------------------------------------------------------------------------
# The packed triangle and the merge on it
# ---------------------------------------------------------------------------


def tri_row(i: int, n: int) -> int:
    """``sw_common.cuh:tri_row``: element (i, j), i < j, at tri_row(i) + j."""
    return i * (2 * n - i - 1) // 2 - i - 1


def _symmetric(n: int, seed: int, ints: bool = False) -> np.ndarray:
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 4, (n, n)) if ints else rng.uniform(0, 10, (n, n))
    w = np.triu(w * (rng.random((n, n)) < 0.5), k=1)
    return (w + w.T).astype(np.float32)


@pytest.mark.parametrize("n", (2, 5, 33, 64, 257))
def test_triangle_index_map(n):
    iu = np.triu_indices(n, k=1)
    pos = TK.triangle_index(iu[0], iu[1], n)
    assert (pos == np.arange(n * (n - 1) // 2)).all()
    assert (TK.triangle_index(iu[1], iu[0], n) == pos).all()  # symmetric
    assert all(TK.triangle_index(i, j, n) == tri_row(i, n) + j for i, j in zip(*iu))
    adj = _symmetric(n, seed=n)
    packed = torch.from_numpy(TK.pack_triangle(adj))
    assert torch.equal(TK.pack_triangle(torch.from_numpy(adj)), packed)
    assert torch.equal(TK.unpack_triangle(packed, n), torch.from_numpy(adj))


def full_merge(adj: torch.Tensor, s: int, t: int) -> None:
    """The Algorithm-1 merge exactly as ``stoer_wagner_plain`` runs it on
    one lane of its batch (row add, column add, ``[s, s] = 0``, row and
    column ``t`` zeroed)."""
    a = adj[None]
    rows = torch.arange(1)
    s_reg, t_reg = torch.tensor([s]), torch.tensor([t])
    t_add = a[rows, t_reg]
    a[rows, s_reg, :] += t_add
    a[rows, :, s_reg] += t_add
    a[rows, s_reg, s_reg] = 0.0
    a[rows, t_reg, :] = 0.0
    a[rows, :, t_reg] = 0.0


def packed_merge(packed: torch.Tensor, n: int, s: int, t: int) -> None:
    """``sw_common.cuh:packed_merge``, column by column as the lanes run it."""
    for j in range(n):
        if j == t:
            continue
        et = TK.triangle_index(t, j, n)
        if j != s:
            es = TK.triangle_index(s, j, n)
            packed[es] = packed[es] + packed[et]
        packed[et] = 0.0


@pytest.mark.parametrize("n,ints", [(9, False), (16, True), (40, False), (70, True)])
def test_packed_merge_equals_full_merge_after_every_merge(n, ints):
    rng = np.random.default_rng(n)
    full = torch.from_numpy(_symmetric(n, seed=n + 1, ints=ints))
    packed = TK.pack_triangle(full).clone()
    alive = list(range(n))
    while len(alive) > 1:
        s, t = (int(v) for v in rng.choice(alive, 2, replace=False))
        full_merge(full, s, t)
        packed_merge(packed, n, s, t)
        alive.remove(t)
        assert torch.equal(TK.unpack_triangle(packed, n), full), (s, t)
    assert (full == 0).all()


@pytest.mark.parametrize("seed", range(4))
def test_plain_step_keeps_the_packed_matrix_equal_to_the_full_merge(seed):
    """``mcop_phase_step_plain`` (the plain version of the loop's step
    kernel) after each phase: its packed matrix unpacks to the reference's
    full-matrix merge of the phase's logged ``(s, t)``, its weights are
    the merged ones, and the log holds the phase."""
    g = T.random_wcg(12, rng=np.random.default_rng(seed))
    adj = np.asarray(g.adj, np.float32)
    wl, wc = np.asarray(g.w_local, np.float32), np.asarray(g.w_cloud, np.float32)
    n = g.n
    state = TK.LoopState(adj, wl, wc, np.ones(n, bool), np.arange(n, dtype=np.int32), 0,
                         n - 1, "cpu")
    full = torch.from_numpy(adj.copy())
    wl_ref, wc_ref = wl.copy(), wc.copy()
    for phase in range(n - 1):
        mcop_phase_step_plain(state, phase, float(wl.sum()))
        cut, s, t = state.read_log()[phase]
        full_merge(full, s, t)
        wl_ref[s] += wl_ref[t]
        wc_ref[s] += wc_ref[t]
        assert torch.equal(TK.unpack_triangle(state.packed, n), full)
        assert np.array_equal(state.wl.numpy()[state.alive.numpy() == 1],
                              wl_ref[state.alive.numpy() == 1])
        assert np.array_equal(state.wc.numpy()[state.alive.numpy() == 1],
                              wc_ref[state.alive.numpy() == 1])
    assert int(state.alive.sum()) == 1


# ---------------------------------------------------------------------------
# A solve over the packed layout, in the warp body's order of operations
# ---------------------------------------------------------------------------


def solve_packed(adj, wl, wc, pin):
    """``sw_common.cuh:solve_graph_warp`` for one graph in numpy f32: the
    fold into the anchor on the packed matrix, each phase's absorb chain
    by the two-step argmax, Eq. 10 with the lane-order sums, the strict-<
    best cut, and the merge on packed storage."""
    f32 = np.float32
    n = wl.shape[0]
    P = TK.pack_triangle(adj.astype(f32)).copy()
    wl, wc = wl.astype(f32).copy(), wc.astype(f32).copy()
    idx = np.arange(n)

    def at(i, j):
        return TK.triangle_index(i, j, n)

    valid = np.ones(n, bool)
    ctot = warp_sum(wl, valid)
    pin_l, pin_c = warp_sum(wl, pin), warp_sum(wc, pin)
    count_pin = int(pin.sum())
    src = int(np.argmax(pin)) if count_pin else 0
    wl_src = f32(pin_l + (f32(0) if count_pin else wl[src]))
    wc_src = f32(pin_c + (f32(0) if count_pin else wc[src]))
    other = pin & (idx != src)
    if count_pin > 1:
        fold = np.zeros(n, f32)
        for i in np.nonzero(other)[0]:  # rows in ascending order
            for j in range(n):
                if j != i:
                    fold[j] = fold[j] + P[at(i, j)]
        for i in range(n):
            for j in range(i + 1, n):
                if other[i] or other[j]:
                    P[at(i, j)] = 0.0
        for j in np.nonzero(~pin & (idx != src))[0]:
            P[at(src, j)] = P[at(src, j)] + fold[j]
    alive = ~other
    label = np.where(pin, src, idx)
    wl[other] = 0.0
    wc[other] = 0.0
    wl[src], wc[src] = wl_src, wc_src
    n_alive = n - (count_pin - 1 if count_pin else 0)
    best, cloud = f32(TK.POS_INF), np.zeros(n, bool)
    while n_alive > 1:
        gain = (wl - wc).astype(f32)
        in_a = idx == src
        conn = np.array([P[at(src, j)] if alive[j] and j != src else 0.0 for j in range(n)], f32)
        s = t = src
        for _ in range(n_alive - 1):
            cand = alive & ~in_a
            v = warp_argmax(torch.from_numpy(conn - gain), torch.from_numpy(cand))
            in_a[v] = True
            for j in np.nonzero(alive & ~in_a)[0]:
                conn[j] = conn[j] + P[at(v, j)]
            s, t = t, v
        row_t = np.array([P[at(t, j)] if j != t else 0.0 for j in range(n)], f32)
        cut = f32(f32(ctot - gain[t]) + warp_sum(row_t, alive & (idx != t)))
        if cut < best:
            best, cloud = cut, label == t
        for j in range(n):  # merge t into s on packed storage
            if j == t:
                continue
            if j != s:
                P[at(s, j)] = P[at(s, j)] + P[at(t, j)]
            P[at(t, j)] = 0.0
        wl[s], wc[s] = wl[s] + wl[t], wc[s] + wc[t]
        wl[t] = wc[t] = 0.0
        alive[t] = False
        label[label == t] = s
        src = s if t == src else src
        n_alive -= 1
    return best, ~cloud


def _batch(seed: int, b: int = 12, n: int = 12):
    """Seeded graphs padded to n: half with contested cloud costs, every
    third with small integer weights (exact ties), a quarter padded;
    padding is pinned with zero weights and edges."""
    rng = np.random.default_rng(seed)
    nv = np.where(np.arange(b) % 4 == 1, rng.integers(3, n, b), n)
    live = np.arange(n)[None, :] < nv[:, None]
    wl = rng.uniform(0, 20, (b, n)) * live
    wc = wl * np.where(np.arange(b)[:, None] % 2 == 1, rng.uniform(0.2, 1.8, (b, n)), 0.5)
    w = np.triu(rng.uniform(0, 10, (b, n, n)) * (rng.random((b, n, n)) < 0.4), k=1)
    ar = np.arange(n - 1)
    w[:, ar, ar + 1] = np.where(w[:, ar, ar + 1] > 0, w[:, ar, ar + 1], rng.uniform(0, 10, (b, n - 1)))
    w = w * (live[:, :, None] & live[:, None, :])
    adj = w + w.transpose(0, 2, 1)
    ints = np.arange(b) % 3 == 2
    wl[ints] = np.floor(wl[ints])
    wc[ints] = rng.integers(0, 20, (int(ints.sum()), n)) * live[ints]
    adj[ints] = np.floor(np.minimum(adj[ints], 3.9))
    pinned = ~live
    pinned[np.arange(b), rng.integers(0, nv)] = True
    pinned[np.arange(b) % 5 == 4, 0] = True  # a second pinned vertex: a real fold
    return adj.astype(np.float32), wl.astype(np.float32), wc.astype(np.float32), pinned


@pytest.fixture(scope="module")
def packed_solves():
    """JAX's B1 kernel (interpret mode, one compilation), the port's plain
    solver, and the packed emulation on the same batch."""
    adj, wl, wc, pinned = _batch(seed=5)
    jc, jm = JK.mcop_stoer_wagner_kernel(adj, wl, wc, pinned, interpret=True)
    pc, pm = TK.stoer_wagner_plain(*(torch.from_numpy(a) for a in (adj, wl, wc, pinned)))
    emu = [solve_packed(adj[i], wl[i], wc[i], pinned[i]) for i in range(adj.shape[0])]
    return (adj, wl, wc, pinned), (np.asarray(jc), np.asarray(jm)), (pc.numpy(), pm.numpy()), emu


@pytest.mark.parametrize("i", range(12))
def test_packed_solve_matches_pallas_kernel(packed_solves, i):
    (adj, wl, wc, pinned), (jc, jm), (pc, pm), emu = packed_solves
    cut, mask = emu[i]
    assert np.array_equal(mask, jm[i]) and np.array_equal(mask, pm[i])
    assert float(cut) == pytest.approx(float(jc[i]), rel=1e-5)
    assert float(cut) == pytest.approx(float(pc[i]), rel=1e-5)


def test_packed_inputs_have_folds_ties_and_padding(packed_solves):
    (adj, wl, wc, pinned), _, _, _ = packed_solves
    assert (pinned.sum(-1) > 1).any() and (pinned.sum(-1) == 1).any()  # folds and none
    assert (adj == np.floor(adj)).all(axis=(1, 2)).any()
    assert (~pinned).sum(-1).min() < adj.shape[-1] - 1
