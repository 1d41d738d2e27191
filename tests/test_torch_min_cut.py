"""The per-phase MCOP tier: one MinCutPhase and the host loop around it.

``repro_torch.kernels.ref.mcop_phase_plain`` (what the phase kernel's
wrapper runs for CPU tensors) against the JAX package's Pallas phase
kernel in interpret mode and its oracle ``ref.mcop_phase_reference``;
``repro_torch.kernels.mcop_min_cut(device="cpu")`` (the device loop's
state in CPU tensors, each phase and its merge by
``kernels.ref.mcop_phase_step_plain``) against the JAX package's
``mcop_min_cut`` and against ``mcop_reference``, phase by phase: the
port's log of ``(cut, s, t)`` against what JAX's phase kernel returned
on the same merged matrix inside JAX's loop.  ``(s, t)`` and masks must
be equal; cuts agree to ``rel=1e-5`` (f32 sums in another order, and the
oracle finishes its cut in f64).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro.kernels.ops as jops
from repro.kernels import ref as jref
from repro.kernels.mcop_phase import mcop_phase_kernel as jax_phase
from repro.kernels.ops import mcop_min_cut as jax_min_cut
import repro_torch.core as T
from repro_torch.kernels import mcop_min_cut, mcop_phase_kernel, mcop_phase_plain
from repro_torch.kernels.mcop_phase import (
    PHASE_MAX_N, LoopState, mcop_phase_packed, mcop_phase_step, phase_result,
)
from repro_torch.kernels.ops import _min_cut_run

MIN_CUT_CASES = [(5, 0), (8, 1), (12, 2), (15, 3), (10, 4)]


def _first_pinned(offloadable):
    pinned = np.nonzero(~np.asarray(offloadable, bool))[0]
    return int(pinned[0]) if pinned.size else 0


def _phase_inputs(g):
    """A whole graph's first phase, as the reference tests pose it."""
    adj = np.asarray(g.adj, np.float32)
    gains = (np.asarray(g.w_local) - np.asarray(g.w_cloud)).astype(np.float32)
    return adj, gains, np.ones(g.n, bool), _first_pinned(g.offloadable), float(
        np.asarray(g.w_local, np.float32).sum())


def _merged_state(adj, w_local, w_cloud, src, merges, rng):
    """The graph after ``merges`` Algorithm-1 merges of random alive pairs
    (f32, in the host loop's order): ``alive`` has holes and ``src`` has
    moved wherever it was merged away."""
    adj = adj.astype(np.float32).copy()
    wl, wc = w_local.astype(np.float32).copy(), w_cloud.astype(np.float32).copy()
    alive = np.ones(adj.shape[0], bool)
    for _ in range(merges):
        s, t = (int(v) for v in rng.choice(np.nonzero(alive)[0], 2, replace=False))
        adj[s, :] += adj[t, :]
        adj[:, s] += adj[:, t]
        adj[s, s] = 0.0
        adj[t, :] = 0.0
        adj[:, t] = 0.0
        wl[s] += wl[t]
        wc[s] += wc[t]
        alive[t] = False
        if t == src:
            src = s
    return adj, wl - wc, alive, src


def _graph(family, n, seed):
    """Seeded phase inputs: ``dense`` (random_wcg), ``sparse`` (about two
    edges per vertex), ``ties`` (small integer weights: equal scores)."""
    rng = np.random.default_rng(seed)
    if family == "dense":
        g = J.random_wcg(n, rng=rng)
        return np.asarray(g.adj), np.asarray(g.w_local), np.asarray(g.w_cloud), rng
    prob = 2.0 / n if family == "sparse" else 0.5
    upper = np.triu(rng.random((n, n)) < prob, k=1)
    upper[np.arange(n - 1), np.arange(1, n)] = True  # a chain keeps it connected
    if family == "ties":
        w = rng.integers(1, 4, (n, n)) * upper
        wl = rng.integers(0, 6, n).astype(np.float64)
        wc = rng.integers(0, 6, n).astype(np.float64)
    else:
        w = rng.uniform(0.0, 10.0, (n, n)) * upper
        wl = rng.uniform(0.0, 20.0, n)
        wc = wl * rng.uniform(0.2, 1.8, n)  # contested: either side may win
    return (w + w.T).astype(np.float64), wl, wc, rng


def _port_phase(adj, gains, alive, src, ctot):
    plain = mcop_phase_plain(torch.from_numpy(adj), torch.from_numpy(gains),
                             torch.from_numpy(alive), src, ctot)
    wrapped = phase_result(mcop_phase_packed(torch.from_numpy(adj), gains, alive, src, ctot))
    cut, s, t = mcop_phase_kernel(torch.from_numpy(adj), gains, alive, src, ctot)
    assert (cut.dtype, s.dtype, t.dtype) == (torch.float32, torch.int32, torch.int32)
    assert (float(plain[0]), plain[1], plain[2]) == wrapped == (float(cut), int(s), int(t))
    return wrapped


def _hold(got, jax_out, oracle):
    cut, s, t = got
    assert (s, t) == (int(jax_out[1]), int(jax_out[2])) == (oracle[1], oracle[2])
    assert cut == pytest.approx(float(jax_out[0]), rel=1e-5)
    assert cut == pytest.approx(oracle[0], rel=1e-5)


@pytest.mark.parametrize("seed", range(8))
def test_phase_matches_pallas_kernel_and_oracle(seed):
    g = J.random_wcg(9, rng=np.random.default_rng(seed))
    adj, gains, alive, src, ctot = _phase_inputs(g)
    jax_out = jax_phase(jnp.asarray(adj), gains, alive, src, ctot, interpret=True)
    oracle = jref.mcop_phase_reference(adj, gains, alive, src, ctot)
    _hold(_port_phase(adj, gains, alive, src, ctot), jax_out, oracle)


@pytest.mark.parametrize("family", ["dense", "sparse", "ties"])
@pytest.mark.parametrize("merges", [0, 3, 6])
def test_phase_with_holes_and_ties(family, merges):
    """Alive masks with holes after random merges, a source that moved,
    contested costs and exact integer ties (the lowest index absorbs)."""
    adj, wl, wc, rng = _graph(family, 9, seed=10 * merges + len(family))
    src = int(rng.integers(0, 9))
    adj, gains, alive, src = _merged_state(adj, wl, wc, src, merges, rng)
    ctot = float(wl.astype(np.float32).sum())
    jax_out = jax_phase(jnp.asarray(adj), gains, alive, src, ctot, interpret=True)
    oracle = jref.mcop_phase_reference(adj, gains, alive, src, ctot)
    _hold(_port_phase(adj, gains, alive, src, ctot), jax_out, oracle)


@pytest.mark.parametrize("n", [16, 40])
def test_phase_larger_graphs_match_oracle(n):
    adj, wl, wc, rng = _graph("ties", n, seed=n)
    adj, gains, alive, src = _merged_state(adj, wl, wc, 0, n // 4, rng)
    ctot = float(wl.astype(np.float32).sum())
    cut, s, t = _port_phase(adj, gains, alive, src, ctot)
    oracle = jref.mcop_phase_reference(adj, gains, alive, src, ctot)
    assert (s, t) == oracle[1:] and cut == pytest.approx(oracle[0], rel=1e-5)


def test_phase_with_one_alive_vertex_returns_its_source():
    adj, wl, wc, _ = _graph("dense", 6, seed=1)
    alive = np.zeros(6, bool)
    alive[4] = True
    cut, s, t = _port_phase(adj.astype(np.float32), (wl - wc).astype(np.float32),
                            alive, 4, float(wl.sum()))
    assert (s, t) == (4, 4)
    assert cut == pytest.approx(float(wl.sum()) - (wl[4] - wc[4]), rel=1e-5)


def test_phase_accepts_float_alive_and_tensor_scalars():
    g = J.random_wcg(7, rng=np.random.default_rng(3))
    adj, gains, alive, src, ctot = _phase_inputs(g)
    want = _port_phase(adj, gains, alive, src, ctot)
    got = phase_result(mcop_phase_packed(
        torch.from_numpy(adj), torch.from_numpy(gains), alive.astype(np.float32),
        torch.tensor(src), torch.tensor(ctot)))
    assert got == want


@pytest.fixture(scope="module")
def jax_min_cuts():
    """JAX's kernel-backed MCOP (interpret mode) at the reference test's
    five (n, seed), and the ``(cut, s, t)`` its phase kernel returned in
    each phase of its loop: one computation per module."""
    out, logs = {}, {}
    phase = jops.mcop_phase_kernel

    def recorded(*args, **kwargs):
        cut, s, t = phase(*args, **kwargs)
        logs[key].append((float(cut), int(s), int(t)))
        return cut, s, t

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jops, "mcop_phase_kernel", recorded)
        for n, seed in MIN_CUT_CASES:
            key = (n, seed)
            logs[key] = []
            g = J.random_wcg(n, rng=np.random.default_rng(seed + 100))
            out[key] = (g, jax_min_cut(g.adj, g.w_local, g.w_cloud, g.offloadable,
                                       interpret=True))
    return {key: (*out[key], logs[key]) for key in out}


@pytest.mark.parametrize("n,seed", MIN_CUT_CASES)
def test_min_cut_matches_pallas_loop_and_reference(jax_min_cuts, n, seed):
    g, (jax_cut, jax_mask), _ = jax_min_cuts[n, seed]
    cut, mask = mcop_min_cut(g.adj, g.w_local, g.w_cloud, g.offloadable, device="cpu")
    ref = J.mcop_reference(g)
    assert isinstance(cut, float) and mask.dtype == bool and mask.shape == (n,)
    assert (mask == jax_mask).all() and (mask == ref.local_mask).all()
    assert cut == pytest.approx(jax_cut, rel=1e-5)
    assert cut == pytest.approx(ref.min_cut, rel=1e-5)
    assert g.total_cost(mask) == pytest.approx(cut, rel=1e-5)


def test_min_cut_paper_example():
    g = T.paper_example_graph()
    cut, mask = mcop_min_cut(g.adj, g.w_local, g.w_cloud, g.offloadable, device="cpu")
    assert cut == 22.0
    assert {g.names[i] for i in np.nonzero(mask)[0]} == {"a", "c"}
    assert (mask == T.mcop_reference(g).local_mask).all()


@pytest.mark.parametrize("pinned", ["none", "all_but_one"])
def test_min_cut_anchor_conventions(pinned):
    """No pinned vertex: the anchor is vertex 0.  All but one pinned: the
    fold leaves two vertices and one phase."""
    rng = np.random.default_rng(7)
    g = J.random_wcg(8, rng=rng)
    off = np.ones(8, bool) if pinned == "none" else np.eye(8, dtype=bool)[5]
    g = J.WCG(g.w_local, g.w_cloud, g.adj, off)
    cut, mask = mcop_min_cut(g.adj, g.w_local, g.w_cloud, g.offloadable, device="cpu")
    jax_cut, jax_mask = jax_min_cut(g.adj, g.w_local, g.w_cloud, g.offloadable,
                                    interpret=True)
    ref = J.mcop_reference(g)
    assert (mask == jax_mask).all() and (mask == ref.local_mask).all()
    assert cut == pytest.approx(ref.min_cut, rel=1e-5)
    assert cut == pytest.approx(jax_cut, rel=1e-5)
    assert mask[~off].all()  # the pinned side stays local


def test_phase_refuses_graphs_above_the_reference_bound():
    big = torch.zeros((PHASE_MAX_N + 1, PHASE_MAX_N + 1))
    with pytest.raises(ValueError, match=f"n={PHASE_MAX_N + 1}"):
        mcop_phase_kernel(big, np.zeros(PHASE_MAX_N + 1, np.float32),
                          np.ones(PHASE_MAX_N + 1, bool), 0, 0.0)
    assert PHASE_MAX_N * PHASE_MAX_N * 4 <= 12 * 2**20 < (PHASE_MAX_N + 1) ** 2 * 4


@pytest.mark.parametrize("n,seed", MIN_CUT_CASES)
def test_min_cut_phase_log_matches_pallas_phases(jax_min_cuts, n, seed):
    """Each phase the device loop ran (its log, read back once at the end)
    against JAX's phase kernel on the same merged matrix inside JAX's
    loop: ``(s, t)`` equal, the cut to rounding, as many phases."""
    g, (jax_cut, _), jax_log = jax_min_cuts[n, seed]
    cut, mask, state = _min_cut_run(g.adj, g.w_local, g.w_cloud, g.offloadable, device="cpu")
    log = state.read_log()
    assert len(log) == len(jax_log) == state.phases
    assert [(s, t) for _, s, t in log] == [(s, t) for _, s, t in jax_log]
    for (c, _, _), (jc, _, _) in zip(log, jax_log):
        assert c == pytest.approx(jc, rel=1e-5)
    assert cut == min(c for c, _, _ in log)


def test_min_cut_log_replays_on_the_phase_kernel():
    """The loop's state after each phase is the reference's: replaying the
    logged merges on the full matrix in numpy and running the phase
    wrapper on it gives the next logged phase."""
    g = J.random_wcg(11, n_unoffloadable=3, rng=np.random.default_rng(4))
    _, _, state = _min_cut_run(g.adj, g.w_local, g.w_cloud, g.offloadable, device="cpu")
    adj = np.asarray(g.adj, np.float32).copy()
    wl, wc = np.asarray(g.w_local, np.float32).copy(), np.asarray(g.w_cloud, np.float32).copy()
    alive = np.ones(g.n, bool)
    pinned = np.nonzero(~np.asarray(g.offloadable, bool))[0]
    src = int(pinned[0])

    def merge(s, t):
        adj[s, :] += adj[t, :]
        adj[:, s] += adj[:, t]
        adj[s, s] = 0.0
        adj[t, :] = 0.0
        adj[:, t] = 0.0
        wl[s] += wl[t]
        wc[s] += wc[t]
        alive[t] = False

    for t in pinned[1:]:
        merge(src, int(t))
    for cut, s, t in state.read_log():
        got = _port_phase(adj, wl - wc, alive, src, float(np.asarray(g.w_local, np.float32).sum()))
        assert got == (cut, s, t)
        merge(s, t)
        src = s if t == src else src


def test_min_cut_with_no_phase_keeps_everything_local():
    """All vertices pinned: the fold leaves one, no phase runs, the cut is
    infinite and every vertex stays local, as in the JAX loop."""
    g = J.random_wcg(6, rng=np.random.default_rng(2))
    off = np.zeros(6, bool)
    cut, mask = mcop_min_cut(g.adj, g.w_local, g.w_cloud, off, device="cpu")
    jax_cut, jax_mask = jax_min_cut(g.adj, g.w_local, g.w_cloud, off, interpret=True)
    assert cut == jax_cut == np.inf
    assert mask.all() and (mask == jax_mask).all()


@pytest.mark.parametrize("bad", ["asymmetric", "diagonal"])
def test_min_cut_refuses_what_is_not_an_undirected_graph(bad):
    """A matrix that is not an undirected graph's is no longer refused: the
    JAX package's loop answers it, and so does the port's, on the full
    ``(n, n)`` matrix (rows read, rows and columns merged), with JAX's
    answer, phase by phase."""
    g = J.random_wcg(6, rng=np.random.default_rng(3))
    adj = np.array(g.adj)
    if bad == "asymmetric":
        adj[0, 1] += 1.0
    else:
        adj[2, 2] = 1.0
    cut, mask, state = _min_cut_run(adj, g.w_local, g.w_cloud, g.offloadable, device="cpu")
    assert state.full
    jax_cut, jax_mask = jax_min_cut(adj, g.w_local, g.w_cloud, g.offloadable, interpret=True)
    assert (mask == jax_mask).all()
    assert cut == pytest.approx(jax_cut, rel=1e-5)


def test_loop_state_layout_and_step_bounds():
    g = J.random_wcg(7, rng=np.random.default_rng(5))
    adj = np.asarray(g.adj, np.float32)
    state = LoopState(adj, np.asarray(g.w_local, np.float32), np.asarray(g.w_cloud, np.float32),
                      np.ones(7, bool), np.arange(7, dtype=np.int32), 3, 6, "cpu")
    assert state.packed.dtype == torch.float32 and state.packed.numel() % 4 == 0
    assert torch.equal(state.packed[:21], torch.from_numpy(adj[np.triu_indices(7, 1)]))
    assert int(state.scal[0]) == 3 and state.log.shape == (18,)
    best, cloud = state.result()
    assert best == np.inf and not cloud.any()
    for phase in (-1, 6):
        with pytest.raises(ValueError, match="outside"):
            mcop_phase_step(state, phase, 1.0)
