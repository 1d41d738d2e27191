"""``repro_torch`` MCOP solvers against ``repro`` on the CPU.

Small graphs only (n ≤ 16 wherever the JAX side runs a Pallas kernel in
interpret mode).  On the CPU the port's ``"cuda"`` / ``"cuda_fused"``
backends run their kernels' plain PyTorch versions, which is what these
tests hold against the JAX package; the kernels themselves are held
against those plain versions on the GPU by ``chip_smoke.py``.

Tolerances: masks must be equal; cuts ``rtol=1e-5`` (both sides are f32
and sum in different orders).
"""

import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.kernels import mcop_phase as JK
from repro_torch.kernels import mcop_phase as TK

from _torch_parity import env_pair, models, profile_pair, wcg_pair

RTOL = 1e-5


# ---- the reference solver: §5.5 phase by phase ------------------------


def test_reference_reproduces_the_paper_trace():
    g = T.paper_example_graph()
    r = T.mcop_reference(g)
    assert [p.cut_value for p in r.phases] == [40.0, 35.0, 29.0, 22.0, 27.0]
    assert r.phases[0].order == ["a", "c", "b", "e", "d", "f"]
    assert (r.phases[0].s, r.phases[0].t) == ("d", "f")
    assert r.phases[1].order == ["a", "c", "b", "e", "{df}"]
    assert r.phases[2].order == ["a", "c", "b", "{def}"]
    assert r.phases[3].order == ["a", "c", "{bdef}"]
    assert r.phases[4].order == ["a", "{bcdef}"]
    assert r.min_cut == 22.0
    assert {g.names[i] for i in r.local_indices} == {"a", "c"}
    assert {g.names[i] for i in r.cloud_indices} == {"b", "d", "e", "f"}


@pytest.mark.parametrize("seed", range(4))
def test_reference_equals_repro_reference(seed):
    gj = J.random_wcg(10, n_unoffloadable=2, rng=np.random.default_rng(seed))
    rj, rt = J.mcop_reference(gj), T.mcop_reference(wcg_pair(gj))
    assert rj.min_cut == rt.min_cut
    assert np.array_equal(rj.local_mask, rt.local_mask)
    assert [(p.order, p.s, p.t, p.cut_value, p.cloud_members) for p in rj.phases] == [
        (p.order, p.s, p.t, p.cut_value, p.cloud_members) for p in rt.phases
    ]


# ---- batched solvers ---------------------------------------------------


def _mixed_graphs(sizes, seed, copies=3):
    """Seeded graphs of the given sizes.  ``random_wcg`` alone makes the
    cloud twice as fast for every vertex, and the best cut then offloads
    nearly everything whatever the solver does in between; every second
    graph therefore draws each vertex's cloud cost between 0.2x and 1.8x
    its local cost, so the answer depends on the absorb order and the
    merges.  Every fourth graph has integer weights (exact ties)."""
    out = []
    for c in range(copies):
        for i, n in enumerate(sizes):
            rng = np.random.default_rng(seed + 17 * c + i)
            g = J.random_wcg(
                n, n_unoffloadable=1 + i % 3, edge_prob=0.3 + 0.1 * (i % 4), rng=rng
            )
            if (c + i) % 2:
                g.w_cloud = g.w_local * rng.uniform(0.2, 1.8, n)
            if (c + i) % 4 == 3:
                # small integers everywhere: scores and cuts tie exactly, so
                # the tie rules (lowest index, strict '<') decide the answer
                g.w_local = np.floor(g.w_local)
                g.w_cloud = rng.integers(0, 20, n).astype(np.float64)
                g.adj = np.floor(np.minimum(g.adj, 3.9))
            out.append(g)
    return out


def test_inputs_have_contested_cuts():
    """The parity inputs are not all of the offload-everything kind."""
    sizes = set()
    for g in _mixed_graphs((12, 16, 9, 14), seed=16):
        r = J.mcop_reference(g)
        sizes.add(len(r.cloud_indices) / max(1, int(g.offloadable.sum())))
    assert len(sizes) >= 5 and any(0.1 < x < 0.9 for x in sizes)


def _special_cases():
    g_all = J.random_wcg(5, rng=np.random.default_rng(1))
    g_all.offloadable[:] = False           # all pinned: nothing to cut
    g_free = J.random_wcg(6, rng=np.random.default_rng(2))
    g_free.offloadable[:] = True           # pin-free: anchor at vertex 0
    g_one = J.WCG([3.0], [1.0], [[0.0]], [False])  # n = 1
    return [g_all, g_free, g_one, J.paper_example_graph()]


def _assert_same(rj, rt, *, rtol=RTOL):
    assert len(rj) == len(rt)
    for a, b in zip(rj, rt):
        assert np.array_equal(a.local_mask, b.local_mask)
        assert b.min_cut == pytest.approx(a.min_cut, rel=rtol)


@pytest.mark.parametrize("bucket,sizes", [(16, (3, 9, 16, 12)), (64, (17, 40)), (256, (70,))])
def test_torch_backend_matches_jax_backend_per_bucket(bucket, sizes):
    gj = _mixed_graphs(sizes, seed=bucket)
    if bucket == 16:
        gj += _special_cases()
    gt = [wcg_pair(g) for g in gj]
    rj = J.mcop_batch(gj, backend="jax", mesh=False)
    rt = T.mcop_batch(gt, backend="torch", device="cpu")
    _assert_same(rj, rt)
    # and against the f64 oracle, to the looser f32-vs-f64 tolerance
    for g, r in zip(gt, rt):
        ref = T.mcop_reference(g)
        assert np.array_equal(ref.local_mask, r.local_mask)
        assert r.min_cut == pytest.approx(ref.min_cut, rel=1e-4)


def test_cuda_backend_on_cpu_matches_pallas_interpret():
    gj = _mixed_graphs((4, 9, 12, 7), seed=100) + _special_cases()
    gt = [wcg_pair(g) for g in gj]
    rj = J.mcop_batch(gj, backend="pallas", buckets=(12,), interpret=True, mesh=False)
    rt = T.mcop_batch(gt, backend="cuda", buckets=(12,), device="cpu")
    _assert_same(rj, rt)


def test_wcg_batch_entry_matches_list_entry():
    gt = [wcg_pair(g) for g in _mixed_graphs((5, 9, 7), seed=7)]
    batch = T.WCGBatch.from_wcgs(gt, m=16)
    for backend in ("reference", "torch", "cuda"):
        a = T.mcop_batch(gt, backend=backend, device="cpu")
        b = T.mcop_batch(batch, backend=backend, device="cpu")
        _assert_same(a, b, rtol=0)


def test_single_graph_front_door():
    g = T.paper_example_graph()
    for backend in ("reference", "torch", "cuda"):
        r = T.mcop(g, backend=backend, device="cpu")
        assert r.min_cut == 22.0 and r.local_indices == (0, 2)
    assert T.mcop_torch(g, device="cpu").min_cut == 22.0
    with pytest.raises(ValueError):
        T.mcop(g, backend="jax")


def test_large_weights_not_swallowed_by_sentinel():
    """Graphs priced in FLOPs/bytes (cuts ≫ 2³⁰) must not collapse into the
    best-cut sentinel."""
    gj = J.random_wcg(8, edge_prob=0.5, rng=np.random.default_rng(42))
    gj.w_local *= 1e12
    gj.w_cloud *= 1e12
    gj.adj *= 1e12
    ref = J.mcop_reference(gj)
    for backend in ("torch", "cuda"):
        res = T.mcop_batch([wcg_pair(gj)], backend=backend, buckets=(8,), device="cpu")[0]
        assert res.min_cut == pytest.approx(ref.min_cut, rel=1e-4)
        assert np.array_equal(res.local_mask, ref.local_mask)


# ---- the kernel module: plain versions and wrappers ---------------------


def test_plain_solver_direct_paper_example():
    g = T.paper_example_graph()
    f32 = torch.float32
    cuts, masks = TK.mcop_stoer_wagner_kernel(
        torch.tensor(g.adj[None], dtype=f32), torch.tensor(g.w_local[None], dtype=f32),
        torch.tensor(g.w_cloud[None], dtype=f32), torch.tensor(~g.offloadable[None]),
    )
    assert float(cuts[0]) == 22.0
    assert np.array_equal(masks[0].numpy(), T.mcop_reference(g).local_mask)
    assert TK.LAUNCHES["mcop_stoer_wagner_kernel"] == 0  # CPU: plain version, no launch


@pytest.mark.parametrize("kind_idx", [0, 1, 2], ids=["time", "energy", "weighted"])
def test_kernel_weights_match_repro_kernel_weights(kind_idx):
    """The fused kernel's weight build, torch vs the Pallas body's, f32:
    same association, so equal to the last bit except the Eq.-8
    normalisers' sums (rtol 1e-6)."""
    import jax.numpy as jnp

    kind = TK.FUSED_MODEL_KINDS[kind_idx]
    rng = np.random.default_rng(5)
    n = 8
    t_loc = rng.uniform(1, 20, n).astype(np.float32)
    d_in = rng.uniform(0, 5, (n, n)).astype(np.float32)
    d_out = rng.uniform(0, 5, (n, n)).astype(np.float32)
    env = rng.uniform(0.5, 4.0, (3, 6)).astype(np.float32)
    got = TK._kernel_weights(kind, 0.3, *(torch.tensor(a) for a in (t_loc, d_in, d_out, env)))
    for i in range(3):
        want = JK._kernel_weights(
            kind, 0.3, jnp.asarray(t_loc)[None], jnp.asarray(d_in), jnp.asarray(d_out),
            jnp.asarray(d_in.T), jnp.asarray(d_out.T), jnp.asarray(env[i : i + 1]),
        )
        for a, b in zip(got, want):
            np.testing.assert_allclose(a[i].numpy(), np.asarray(b).reshape(a[i].shape), rtol=1e-6)


@pytest.mark.parametrize("name,mj,mt", models(), ids=[m[0] for m in models()])
def test_cuda_fused_on_cpu_matches_pallas_fused_interpret(name, mj, mt):
    gj = J.random_wcg(9, n_unoffloadable=2, rng=np.random.default_rng(21))
    pj = J.AppProfile.from_wcg_times(gj)
    pt = profile_pair(pj)
    ej, et = env_pair(np.random.default_rng(8), 5)
    rj = J.solve_envs(pj, mj, ej, backend="pallas_fused", interpret=True, mesh=False)
    rt = T.solve_envs(pt, mt, et, backend="cuda_fused", device="cpu")
    _assert_same(rj, rt)
    # and the fused path agrees with the build-then-solve path of the port
    _assert_same(T.solve_envs(pt, mt, et, backend="cuda", device="cpu"), rt)


@pytest.mark.parametrize("backend_j,backend_t", [("jax", "torch"), ("pallas", "cuda")])
def test_solve_envs_matches_repro(backend_j, backend_t):
    gj = J.random_wcg(10, rng=np.random.default_rng(33))
    pj = J.AppProfile.from_wcg_times(gj)
    pt = profile_pair(pj)
    ej, et = env_pair(np.random.default_rng(4), 4)
    for _, mj, mt in models():
        rj = J.solve_envs(pj, mj, ej, backend=backend_j, interpret=True, mesh=False)
        rt = T.solve_envs(pt, mt, et, backend=backend_t, device="cpu")
        _assert_same(rj, rt)


def test_solve_envs_reference_backend_is_bitwise_repro():
    gj = J.random_wcg(8, rng=np.random.default_rng(2))
    pj = J.AppProfile.from_wcg_times(gj)
    ej, et = env_pair(np.random.default_rng(1), 3)
    rj = J.solve_envs(pj, J.EnergyModel(), ej, backend="reference")
    rt = T.solve_envs(profile_pair(pj), T.EnergyModel(), et, backend="reference")
    _assert_same(rj, rt, rtol=0)
    assert T.solve_envs(profile_pair(pj), T.EnergyModel(), [], backend="reference") == []


def test_unknown_kind_raises_before_any_work():
    class Custom(T.ResponseTimeModel):
        name = "custom"

    g = T.paper_example_graph()
    p = T.AppProfile.from_wcg_times(g)
    env = [T.Environment.symmetric(1.0, 2.0)]
    with pytest.raises(ValueError, match="cuda_fused"):
        T.solve_envs(p, Custom(), env, backend="cuda_fused", device="cpu")
    # the build-then-solve backend takes custom models
    assert len(T.solve_envs(p, Custom(), env, backend="cuda", device="cpu")) == 1
    z = torch.zeros
    with pytest.raises(ValueError, match="unknown fused cost-model kind"):
        TK.mcop_fused_solve_kernel(
            z(4), z(4, 4), z(4, 4), z(4, dtype=torch.bool), torch.ones(1, 6), kind="latency"
        )
    with pytest.raises(ValueError):
        T.solve_envs(p, T.ResponseTimeModel(), env, backend="pallas_fused", device="cpu")


def test_wrappers_reject_what_the_kernels_do_not_take():
    f32 = torch.float32
    ok = (torch.zeros(2, 4, 4), torch.zeros(2, 4), torch.zeros(2, 4), torch.ones(2, 4, dtype=torch.bool))
    TK.mcop_stoer_wagner_kernel(*ok)
    with pytest.raises(TypeError):
        TK.mcop_stoer_wagner_kernel(ok[0].double(), *ok[1:])
    with pytest.raises(TypeError):
        TK.mcop_stoer_wagner_kernel(*ok[:3], ok[3].to(f32))
    with pytest.raises(ValueError):
        TK.mcop_stoer_wagner_kernel(ok[0], ok[1][:, :3], *ok[2:])
    with pytest.raises(ValueError, match="contiguous"):
        TK.mcop_stoer_wagner_kernel(ok[0].transpose(1, 2)[:, :, :], ok[1].t().contiguous().t(), *ok[2:])
    big = TK.SW_MAX_N + 64
    with pytest.raises(ValueError, match=f"n={big}"):
        TK.mcop_stoer_wagner_kernel(
            torch.zeros(1, big, big), torch.zeros(1, big), torch.zeros(1, big),
            torch.ones(1, big, dtype=torch.bool),
        )
    big = TK.FUSED_MAX_N + 64
    with pytest.raises(ValueError, match=f"n={big}"):
        TK.mcop_fused_solve_kernel(
            torch.zeros(big), torch.zeros(big, big), torch.zeros(big, big),
            torch.ones(big, dtype=torch.bool), torch.ones(1, 6), kind="time",
        )


def test_bucket_sizes_match_repro():
    from repro.core.mcop import _bucket_size as bj
    from repro_torch.core.mcop import _bucket_size as bt

    for n in (1, 16, 17, 64, 65, 256, 257, 320, 321, 700, 768):
        assert bj(n, (16, 64, 256)) == bt(n, (16, 64, 256))
    assert bt(768, (16, 64, 256)) <= TK.SW_MAX_N
    assert bt(512, (16, 64, 256)) <= TK.FUSED_MAX_N
