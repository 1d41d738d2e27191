"""Adjacencies that ``WCG`` accepts as symmetric (``np.allclose``) but that
are not exactly symmetric.

B1's warp variant and B3's packed loop state hold the upper triangle only,
so on such a matrix they would answer for its mirror image.  The port
sends each graph of a bucket that is not exactly symmetric to B1's full-row
variant (``full_rows=True``, decided per graph on the bucket's device copy)
and runs
such a graph's ``mcop_min_cut`` loop on the full ``(n, n)`` matrix, reading
rows and merging rows and columns as the reference does.  Here, on the
CPU: the n = 5 input that separates the two answers, through every entry
point, against ``repro``; the routing decision itself; the staging of the
warp variant emulated (it would answer differently); and 200 perturbed
integer graphs against the f64 reference, where the only departures
allowed are f32-resolution ties that an f32 transcription of the
reference shares.  The kernels themselves are held on the card by
``chip_smoke.py`` (phase ``near_symmetric``).
"""

import importlib

import numpy as np
import pytest
import torch

import repro.core as J
from repro.kernels.ops import mcop_min_cut as jax_min_cut
import repro_torch.core as T
from repro_torch.kernels import mcop_min_cut
from repro_torch.kernels import mcop_phase as TK
from repro_torch.kernels.ops import _min_cut_run, _min_cut_state

from _torch_parity import wcg_pair

core_mcop = importlib.import_module("repro_torch.core.mcop")


def _queue_c_graph(pkg):
    """n = 5, vertex 0 pinned, integer weights; the lower triangle is the
    upper one times (1 +- 5e-6)."""
    adj = np.zeros((5, 5))
    for i, j, w in ((0, 2, 2), (0, 3, 3), (0, 4, 1), (1, 3, 1), (1, 4, 2), (2, 3, 1), (2, 4, 2)):
        adj[i, j] = w
    adj += adj.T
    for (i, j), v in {(2, 0): 2.00001, (3, 0): 2.999985, (3, 1): 1.000005,
                      (3, 2): 1.000005, (4, 0): 0.999995, (4, 1): 1.99999,
                      (4, 2): 1.99999}.items():
        adj[i, j] = v
    return pkg.WCG([5, 5, 5, 3, 3], [0, 1, 0, 2, 1], adj, np.arange(5) != 0)


def _perturbed(rng, n):
    up = np.triu(rng.integers(0, 4, (n, n)).astype(np.float64), 1)
    sign = rng.choice([-1.0, 1.0], (n, n))
    off = np.ones(n, bool)
    off[0] = False
    if rng.random() < 0.3:
        off[rng.integers(1, n)] = False
    return J.WCG(rng.integers(0, 6, n).astype(np.float64),
                 rng.integers(0, 3, n).astype(np.float64),
                 up + (up * (1 + sign * 5e-6)).T, off)


def _reference_f32(g):
    """Algorithms 1-3 as ``mcop_reference`` runs them, in f32: the cut
    each f32 solver should find, to the order of its sums."""
    adj = np.asarray(g.adj, np.float32).copy()
    wl = np.asarray(g.w_local, np.float32).copy()
    wc = np.asarray(g.w_cloud, np.float32).copy()
    n = adj.shape[0]
    alive = np.ones(n, bool)
    members = [{i} for i in range(n)]
    ctot = np.float32(np.asarray(g.w_local, np.float32).sum())

    def merge(s, t):
        adj[s, :] += adj[t, :]
        adj[:, s] += adj[:, t]
        adj[s, s] = 0
        adj[t, :] = 0
        adj[:, t] = 0
        wl[s] += wl[t]
        wc[s] += wc[t]
        members[s] |= members[t]
        alive[t] = False

    pinned = np.nonzero(~np.asarray(g.offloadable))[0]
    src = int(pinned[0]) if pinned.size else 0
    for o in pinned[1:]:
        merge(src, int(o))
    best, cloud = np.float32(1e30), set()
    while alive.sum() > 1:
        gains = wl - wc
        in_a = np.zeros(n, bool)
        in_a[src] = True
        conn, added = adj[src].copy(), [src]
        for _ in range(alive.sum() - 1):
            scores = np.where(alive & ~in_a, conn - gains, np.float32(-1e30))
            v = int(np.argmax(scores))
            in_a[v] = True
            conn += adj[v]
            added.append(v)
        s, t = added[-2], added[-1]
        cut = ctot - gains[t] + adj[t, alive].sum(dtype=np.float32)
        if cut < best:
            best, cloud = cut, set(members[t])
        merge(s, t)
        if t == src:
            src = s
    mask = np.ones(n, bool)
    mask[list(cloud)] = False
    return float(best), mask


def _mirrored_upper(g):
    """What the warp variant stages: the upper triangle, mirrored."""
    adj = torch.from_numpy(np.asarray(g.adj, np.float32))
    return T.WCG(g.w_local, g.w_cloud,
                 TK.unpack_triangle(TK.pack_triangle(adj), g.n).numpy(), g.offloadable)


# ---- the n = 5 input -------------------------------------------------------


def test_queue_c_input_min_cut_answers_like_repro():
    gj = _queue_c_graph(J)
    g = _queue_c_graph(T)
    cut, mask = mcop_min_cut(g.adj, g.w_local, g.w_cloud, g.offloadable, device="cpu")
    jcut, jmask = jax_min_cut(gj.adj, gj.w_local, gj.w_cloud, gj.offloadable, interpret=True)
    ref = J.mcop_reference(gj)
    assert mask.tolist() == jmask.tolist() == ref.local_mask.tolist() == [1, 0, 0, 0, 0]
    assert cut == pytest.approx(jcut, rel=1e-6) and cut == pytest.approx(ref.min_cut, rel=1e-6)


@pytest.mark.parametrize("entry", ["mcop_batch_torch", "mcop_batch_cuda", "mcop_cuda",
                                   "wcg_batch_cuda"])
def test_queue_c_input_through_the_batch_solvers(entry):
    g = _queue_c_graph(T)
    ref = T.mcop_reference(g)
    r = {
        "mcop_batch_torch": lambda: T.mcop_batch([g], backend="torch", device="cpu")[0],
        "mcop_batch_cuda": lambda: T.mcop_batch([g], backend="cuda", device="cpu")[0],
        "mcop_cuda": lambda: T.mcop(g, backend="cuda", device="cpu"),
        "wcg_batch_cuda": lambda: T.mcop_batch(T.WCGBatch.from_wcgs([g], m=16),
                                               backend="cuda", device="cpu")[0],
    }[entry]()
    assert r.local_mask.tolist() == ref.local_mask.tolist()
    assert r.min_cut == pytest.approx(ref.min_cut, rel=1e-6)


def test_warp_variant_staging_would_answer_differently():
    """The fault the routing repairs: the same solver on the mirrored upper
    triangle (what the warp variant stages) gives cut 15 and places vertex
    3 locally too, where the reference gives 14.99999 and only vertex 0."""
    g = _queue_c_graph(T)
    ref = T.mcop_reference(g)
    staged = T.mcop_batch([_mirrored_upper(g)], backend="torch", device="cpu")[0]
    assert staged.local_mask.tolist() == [1, 0, 0, 1, 0] != ref.local_mask.tolist()
    assert staged.min_cut == 15.0 and ref.min_cut == pytest.approx(14.99999)
    # mcop_min_cut's loop state holds the whole matrix, lower triangle too
    state = _min_cut_state(g.adj, g.w_local, g.w_cloud, g.offloadable, device="cpu")[0]
    assert state.full and state.packed[:25].view(5, 5)[2, 0] == np.float32(2.00001)


# ---- the routing decision --------------------------------------------------


def test_routing_exact_symmetry_keeps_the_warp_variant(monkeypatch):
    seen = []
    real = TK.mcop_stoer_wagner_kernel

    def spy(adj, *args, full_rows=False):
        seen.append((full_rows, int(adj.shape[0])))
        return real(adj, *args, full_rows=full_rows)

    monkeypatch.setattr(TK, "mcop_stoer_wagner_kernel", spy)
    sym = [T.random_wcg(n, rng=np.random.default_rng(n)) for n in (5, 9, 14)]
    near = _queue_c_graph(T)
    T.mcop_batch(sym, backend="cuda", device="cpu")
    mixed = [sym[0], near, sym[1], sym[2]]
    got = T.mcop_batch(mixed, backend="cuda", device="cpu")
    T.mcop_batch(T.WCGBatch.from_wcgs(sym, m=16), backend="cuda", device="cpu")
    T.mcop_batch(T.WCGBatch.from_wcgs([near], m=16), backend="cuda", device="cpu")
    # a bucket is split by graph: the exactly symmetric ones keep the warp
    # variant, only the near-symmetric one goes to the full-row variant
    assert seen == [(False, 3), (False, 3), (True, 1), (False, 3), (True, 1)]
    for g, r in zip(mixed, got):  # scattered back in input order
        ref = T.mcop_reference(g)
        assert r.local_mask.tolist() == ref.local_mask.tolist()
        assert r.min_cut == pytest.approx(ref.min_cut, rel=1e-6)
    T.mcop_batch(mixed, backend="torch", device="cpu")  # the plain solver: no kernel
    assert len(seen) == 5


def test_routing_helper_flags_each_graph():
    adj = np.zeros((3, 6, 6), np.float32)
    adj[0, :3, :3] = [[0, 1, 2], [1, 0, 3], [2, 3, 0]]
    adj[1, :4, :4] = np.triu(np.arange(16, dtype=np.float32).reshape(4, 4), 1)
    adj[1, :4, :4] += adj[1, :4, :4].T
    adj[2] = adj[1]
    assert core_mcop._symmetric_rows(torch.from_numpy(adj)).tolist() == [True] * 3
    adj[1, 3, 0] = np.nextafter(adj[1, 0, 3], np.float32(np.inf))
    assert core_mcop._symmetric_rows(torch.from_numpy(adj)).tolist() == [True, False, True]
    # a difference below f32 resolution is symmetric in the f32 bucket
    g = T.random_wcg(7, rng=np.random.default_rng(1))
    adj64 = g.adj.copy()
    adj64[1, 0] *= 1 + 1e-12
    packed = core_mcop._pack_bucket([T.WCG(g.w_local, g.w_cloud, adj64, g.offloadable)], 16,
                                    np.float32)
    assert core_mcop._symmetric_rows(torch.from_numpy(packed[0])).tolist() == [True]


@pytest.mark.parametrize("kind,full", [("symmetric", False), ("near", True),
                                       ("diagonal", True)])
def test_routing_of_the_min_cut_loop_state(kind, full):
    g = T.random_wcg(8, rng=np.random.default_rng(4))
    adj = g.adj.copy()
    if kind == "near":
        adj[5, 2] *= 1 + 5e-6
    elif kind == "diagonal":
        adj[3, 3] = 1.0
    state = _min_cut_run(adj, g.w_local, g.w_cloud, g.offloadable, device="cpu")[2]
    assert state.full == full
    assert state.packed.numel() * 4 >= (64 if full else 28) * 4


# ---- 200 perturbed integer graphs --------------------------------------------


@pytest.fixture(scope="module")
def perturbed():
    rng = np.random.default_rng(2024)
    graphs = [_perturbed(rng, int(rng.integers(4, 9))) for _ in range(200)]
    return graphs, [J.mcop_reference(gj) for gj in graphs]


@pytest.mark.parametrize("entry", ["mcop_batch", "mcop_min_cut"])
def test_perturbed_graphs_against_the_f64_reference(perturbed, entry):
    graphs, refs = perturbed
    ts = [wcg_pair(gj) for gj in graphs]
    if entry == "mcop_batch":
        got = [(r.min_cut, r.local_mask)
               for r in T.mcop_batch(ts, backend="cuda", device="cpu")]
    else:
        got = [mcop_min_cut(g.adj, g.w_local, g.w_cloud, g.offloadable, device="cpu")
               for g in ts]
    ties = 0
    for g, (cut, mask), ref in zip(ts, got, refs):
        if np.array_equal(mask, ref.local_mask):
            assert cut == pytest.approx(ref.min_cut, rel=1e-5)
            continue
        # f32 cannot resolve this one: the f32 transcription of the
        # reference lands where the port lands, or on an equal cut
        f32_cut, f32_mask = _reference_f32(g)
        assert np.array_equal(mask, f32_mask) or np.float32(cut) == np.float32(f32_cut)
        ties += 1
    assert ties <= 2


def test_perturbed_graphs_tell_the_mirrored_triangle_apart(perturbed):
    """On the same 200 graphs the mirrored upper triangle departs from the
    reference many times more often than the f32 ties do."""
    graphs, refs = perturbed
    mirrored = T.mcop_batch([_mirrored_upper(wcg_pair(gj)) for gj in graphs],
                            backend="torch", device="cpu")
    departs = sum(not np.array_equal(r.local_mask, ref.local_mask)
                  for r, ref in zip(mirrored, refs))
    assert departs >= 5
