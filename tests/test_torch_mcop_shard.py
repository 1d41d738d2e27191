"""The solver fleet of ``repro_torch`` (``core/mcop_shard.py``) on the CPU.

A mesh of eight ``"cpu"`` entries stands in for the JAX package's eight
forced host devices (``tests/test_mcop_shard.py``, which covers the JAX
fleet in its own subprocesses); on CPU tensors the ``"cuda"`` and
``"cuda_fused"`` backends run their kernels' plain versions.  Sharded
must equal unsharded bit for bit (``==``, no tolerance) in ``solve_envs``
across the Fig.-2 topologies and the three cost models at an uneven
K = 13, in ``mcop_batch`` and the broker's ``WCGBatch`` flush, and in a
full ``tick_sessions`` tick with the empty-miss tick after it.  The shard
plan is held to ``repro``'s, and one case holds the sharded port to
``repro``'s unsharded solve under the usual parity contract (masks equal,
cuts to ``rtol=1e-5``).
"""

import numpy as np
import pytest
import torch

import repro.core as J
from repro.core.mcop_shard import shard_plan as jax_shard_plan
import repro_torch.core as T
from repro_torch.core.cost_models import EnvArrays
from repro_torch.core.mcop_shard import (
    ShardPlan, default_solver_mesh, resolve_mesh, runs_on_cpu, shard_plan,
)
from repro_torch.launch.mesh import SolverMesh, make_solver_mesh
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Tracer
from repro_torch.runtime.sharding import SOLVE_AXIS, solver_axis, solver_shards

from _torch_parity import profile_pair

SHARDS = 8
K = 13  # uneven on 8 shards: padding and round-robin both engaged

TOPOLOGIES = {
    "linear": lambda: T.linear_graph(9, rng=np.random.default_rng(1)),
    "loop": lambda: T.loop_graph(8, rng=np.random.default_rng(2)),
    "tree": lambda: T.tree_graph(10, rng=np.random.default_rng(3)),
    "mesh": lambda: T.mesh_graph(3, 3, rng=np.random.default_rng(4)),
}
MODELS = {
    "time": T.ResponseTimeModel,
    "energy": T.EnergyModel,
    "weighted": lambda: T.WeightedModel(0.35),
}


@pytest.fixture(scope="module")
def fleet():
    return make_solver_mesh(["cpu"] * SHARDS)


def _envs(seed: int, k: int = K) -> EnvArrays:
    rng = np.random.default_rng(seed)
    return EnvArrays(*(rng.uniform(0.5, 5.0, k) for _ in range(6)))


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.min_cut == y.min_cut
        assert np.array_equal(x.local_mask, y.local_mask)


# ---- the shard plan: pure host math, the same as repro's ------------------


@pytest.mark.parametrize("k", [1, 2, 5, 13, 16, 64, 100])
@pytest.mark.parametrize("shards", [1, 2, 3, 4, 8])
def test_shard_plan_equals_repro(k, shards):
    got, want = shard_plan(k, shards), jax_shard_plan(k, shards)
    assert isinstance(got, ShardPlan)
    assert got._fields == want._fields == ("shards", "k", "pad", "perm", "inverse")
    assert (got.shards, got.k, got.pad, got.rows_per_shard) == (
        want.shards, want.k, want.pad, want.rows_per_shard)
    assert np.array_equal(got.perm, want.perm) and np.array_equal(got.inverse, want.inverse)
    x = np.arange(k + got.pad)
    assert np.array_equal(x[got.perm][got.inverse], x)
    # shard s holds rows i with i % shards == s, in a contiguous block
    for p, i in enumerate(got.perm):
        assert i % shards == p // got.rows_per_shard
    assert sum(got.real_rows(s) for s in range(shards)) == k


@pytest.mark.parametrize("k,shards", [(0, 8), (8, 0), (-1, 2), (3, -4)])
def test_shard_plan_rejects_degenerate_inputs(k, shards):
    with pytest.raises(ValueError):
        shard_plan(k, shards)
    with pytest.raises(ValueError):
        jax_shard_plan(k, shards)


# ---- mesh= normalisation --------------------------------------------------


def test_resolve_mesh_false_forces_single_device():
    assert resolve_mesh(False) is None


def test_resolve_mesh_auto_never_shards(monkeypatch):
    # no CUDA device: no fleet, and auto is the plain path
    assert default_solver_mesh() is None
    assert resolve_mesh(None) is None
    # four GPUs: the fleet is there to be asked for; auto stays on one device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    fleet4 = default_solver_mesh()
    assert fleet4.devices == tuple(torch.device("cuda", i) for i in range(4))
    assert resolve_mesh(None) is None
    assert resolve_mesh(fleet4) is fleet4


def test_resolve_mesh_collapses_one_shard_and_keeps_a_fleet(fleet):
    one = make_solver_mesh(["cpu"])
    assert resolve_mesh(one) is None
    assert resolve_mesh(fleet) is fleet and resolve_mesh(resolve_mesh(fleet)) is fleet
    assert solver_shards(fleet) == SHARDS
    assert solver_axis(fleet) == SOLVE_AXIS == fleet.axis_names[0]
    assert runs_on_cpu(fleet, "cuda") and runs_on_cpu(None, "cpu")
    assert not runs_on_cpu(None, "cuda")


@pytest.mark.parametrize("junk", [8, "cpu", ["cpu", "cpu"], object()])
def test_resolve_mesh_rejects_junk(junk):
    with pytest.raises(TypeError):
        resolve_mesh(junk)


def test_make_solver_mesh_contract():
    mesh = make_solver_mesh(["cpu", "cpu", "cpu"])
    assert isinstance(mesh, SolverMesh) and len(mesh.devices) == 3
    assert all(d.type == "cpu" for d in mesh.devices)
    with pytest.raises(ValueError):
        make_solver_mesh([])


# ---- sharded == unsharded, bit for bit --------------------------------------


@pytest.mark.parametrize("backend", ["torch", "cuda_fused"])
@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("topology", sorted(TOPOLOGIES))
def test_sharded_solve_envs_bit_identical(fleet, topology, model, backend):
    profile = T.AppProfile.from_wcg_times(TOPOLOGIES[topology]())
    envs = _envs(7)
    tracer = Tracer()
    sharded = T.solve_envs(profile, MODELS[model](), envs, backend=backend, device="cpu",
                           mesh=fleet, tracer=tracer)
    single = T.solve_envs(profile, MODELS[model](), envs, backend=backend, device="cpu",
                          mesh=False)
    _same(sharded, single)
    spans = tracer.spans("solve_envs.shard")
    assert [s.attrs["shard"] for s in spans] == list(range(SHARDS))
    assert all(s.attrs["devices"] == SHARDS for s in spans)
    # the reference's rows: real rows only, round robin
    assert [s.attrs["rows"] for s in spans] == [2] * 5 + [1] * 3


def test_sharded_solve_envs_metrics_count_the_shards(fleet):
    profile = T.AppProfile.from_wcg_times(TOPOLOGIES["tree"]())
    reg = MetricsRegistry()
    for mesh in (fleet, False):
        T.solve_envs(profile, T.ResponseTimeModel(), _envs(3), backend="cuda",
                     device="cpu", mesh=mesh, metrics=reg)
    for devices in (SHARDS, 1):
        assert reg.counter("solve_envs_dispatches", backend="cuda", bucket=16,
                           devices=devices).value == 1
    # the reference backend ignores the mesh: one device, no shard span
    tracer = Tracer()
    T.solve_envs(profile, T.ResponseTimeModel(), _envs(3), backend="reference",
                 mesh=fleet, metrics=reg, tracer=tracer)
    assert reg.counter("solve_envs_dispatches", backend="reference", bucket=16,
                       devices=1).value == 1
    assert tracer.spans("solve_envs.shard") == []


@pytest.mark.parametrize("k", [1, 3, 13])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_sharded_mcop_batch_and_wcg_batch_bit_identical(fleet, backend, k):
    graphs = [T.linear_graph(4 + (i % 10), rng=np.random.default_rng(10 + i))
              for i in range(k)]
    batch = T.WCGBatch.from_wcgs(graphs, m=16)
    tracer = Tracer()
    single = T.mcop_batch(batch, backend=backend, device="cpu", mesh=False)
    _same(T.mcop_batch(batch, backend=backend, device="cpu", mesh=fleet, tracer=tracer),
          single)
    _same(T.mcop_batch(graphs, backend=backend, device="cpu", mesh=fleet), single)
    spans = tracer.spans("solve.shard")
    assert len(spans) == SHARDS
    assert [s.attrs["rows"] for s in spans] == [len(range(s, k, SHARDS)) for s in range(SHARDS)]


def test_sharded_mcop_batch_heterogeneous_buckets(fleet):
    rng = np.random.default_rng(5)
    graphs = [T.random_wcg(int(n), rng=rng) for n in rng.integers(3, 40, 21)]
    tracer = Tracer()
    sharded = T.mcop_batch(graphs, backend="cuda", device="cpu", mesh=fleet, tracer=tracer)
    _same(sharded, T.mcop_batch(graphs, backend="cuda", device="cpu", mesh=False))
    # one span a shard for each of the two buckets (16 and 64)
    assert len(tracer.spans("solve.shard")) == 2 * SHARDS


def test_sharded_mcop_batch_mixed_symmetry_bit_identical(fleet, monkeypatch):
    """A bucket where some graphs are symmetric only to a tolerance: each
    shard routes its own rows (the full-row variant for those graphs, the
    packed one for the rest) and the gather is the single-device answer."""
    from repro_torch.kernels import mcop_phase as TK

    rng = np.random.default_rng(8)
    graphs = []
    for i in range(11):
        g = T.random_wcg(int(rng.integers(4, 15)), rng=rng)
        if i % 3 == 1:  # a lower-triangle edge off by 5e-6, as WCG allows
            j, l = np.argwhere(np.tril(g.adj, -1) > 0)[0]
            adj = g.adj.copy()
            adj[j, l] *= 1 + 5e-6
            g = T.WCG(g.w_local, g.w_cloud, adj, g.offloadable)
        graphs.append(g)
    routes = []
    real = TK.mcop_stoer_wagner_kernel

    def spy(adj, *args, full_rows=False):
        routes.append((full_rows, int(adj.shape[0])))
        return real(adj, *args, full_rows=full_rows)

    monkeypatch.setattr(TK, "mcop_stoer_wagner_kernel", spy)
    single = T.mcop_batch(graphs, backend="cuda", device="cpu", mesh=False)
    assert routes == [(False, 7), (True, 4)]
    routes.clear()
    _same(T.mcop_batch(graphs, backend="cuda", device="cpu", mesh=fleet), single)
    # shard s holds rows s and s + 8 (or an inert pad row); rows 1, 4, 7 and
    # 10 are near-symmetric, so shards 1, 2, 4 and 7 launch twice
    assert sorted(routes) == sorted([(True, 1)] * 4 + [(False, 1)] * 4 + [(False, 2)] * 4)
    for g, r in zip(graphs, single):
        assert np.array_equal(r.local_mask, T.mcop_reference(g).local_mask)


def test_sharded_port_matches_repro_unsharded(fleet):
    """The parity contract across packages: the port's 8-shard solve of
    the JAX package's inputs against the JAX package's single-device
    solve (masks equal, cuts to f32 rounding)."""
    gj = J.random_wcg(10, rng=np.random.default_rng(33))
    pj = J.AppProfile.from_wcg_times(gj)
    rng = np.random.default_rng(4)
    cols = [rng.uniform(0.5, 5.0, K) for _ in range(6)]
    rj = J.solve_envs(pj, J.ResponseTimeModel(), J.EnvArrays(*cols), backend="jax",
                      mesh=False)
    rt = T.solve_envs(profile_pair(pj), T.ResponseTimeModel(), EnvArrays(*cols),
                      backend="cuda", device="cpu", mesh=fleet)
    for a, b in zip(rj, rt):
        assert np.array_equal(a.local_mask, b.local_mask)
        assert b.min_cut == pytest.approx(a.min_cut, rel=1e-5)


def test_sharded_tick_sessions_bit_identical(fleet):
    profile = T.AppProfile.from_wcg_times(TOPOLOGIES["tree"]())
    rng = np.random.default_rng(5)
    cols = rng.uniform(0.5, 5.0, (6, K))

    def drive(mesh):
        batch = T.SessionBatch.create(K, profile.n, threshold=0.15, min_interval=2)
        batch.activate(np.arange(K))
        cache = T.PlacementCache(T.EnvQuantizer())
        tracer = Tracer()
        # tick 0: K fresh sessions flush through the fleet; tick 1: the
        # same environments, the cooldown holds: an empty miss set
        reps = [T.tick_sessions(batch, EnvArrays(*cols.copy()), profile=profile,
                                model=T.ResponseTimeModel(), cache=cache, backend="cuda",
                                device="cpu", mesh=mesh, tick=t, tracer=tracer)
                for t in range(2)]
        return reps, cache.stats, tracer

    sharded, stats_sh, tr_sh = drive(fleet)
    single, stats_1, tr_1 = drive(False)
    assert stats_sh == stats_1
    for rs, r1 in zip(sharded, single):
        assert (rs.solved, rs.coalesced, rs.hits, rs.due) == (r1.solved, r1.coalesced,
                                                              r1.hits, r1.due)
        for f in ("repartitioned", "placements", "partial_cost", "no_offload_cost",
                  "full_offload_cost", "gain"):
            assert np.array_equal(getattr(rs, f), getattr(r1, f)), f
        assert np.array_equal(rs.min_cut, r1.min_cut, equal_nan=True)
    assert sharded[0].solved > 0 and sharded[1].solved == 0
    # one shard span each for the one flush; the flush span counts the shards
    assert len(tr_sh.spans("solve_envs.shard")) == SHARDS
    assert [s.attrs["devices"] for s in tr_sh.spans("stage.solve_flush")] == [SHARDS]
    assert [s.attrs["devices"] for s in tr_1.spans("stage.solve_flush")] == [1]
    assert tr_1.spans("solve_envs.shard") == []


def test_sharded_broker_flush_bit_identical(fleet):
    """The broker resolves its fleet once and every flush (the WCGBatch
    path) shards over it; replies equal the single-device broker's."""
    from repro_torch.service import BrokerSession, OffloadBroker

    profile = T.AppProfile.from_wcg_times(TOPOLOGIES["mesh"]())
    envs = _envs(11, 12)

    def run(mesh):
        tracer = Tracer()
        broker = OffloadBroker(backend="cuda", device="cpu", mesh=mesh, tracer=tracer)
        broker.register("app", profile, T.EnergyModel())
        sessions = [BrokerSession(broker, "app", threshold=0.0) for _ in range(12)]
        events = []
        for step in range(2):
            for i, s in enumerate(sessions):
                s.observe(envs.env(i) if step == 0 else envs.env(11 - i))
            broker.tick()
            for s in sessions:
                events += s.drain()
        assert len(events) == 24
        return broker, events, tracer

    b_sh, ev_sh, tr_sh = run(fleet)
    b_1, ev_1, _ = run(False)
    assert b_sh.mesh is fleet and b_sh._devices == SHARDS and b_1.mesh is None
    for a, b in zip(ev_sh, ev_1):
        assert a.result.min_cut == b.result.min_cut
        assert np.array_equal(a.result.local_mask, b.result.local_mask)
        assert (a.partial_cost, a.repartitioned, a.cache_hit) == (
            b.partial_cost, b.repartitioned, b.cache_hit)
    assert tr_sh.spans("solve.shard")
    assert {s.attrs["devices"] for s in tr_sh.spans("stage.solve_flush")} == {SHARDS}
