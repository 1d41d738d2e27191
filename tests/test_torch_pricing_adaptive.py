"""Pricing, the placement cache and the adaptive loop: port vs ``repro``.

Host pricing, cache keys and drift decisions are numpy float64 in both
packages, so the contracts here are ``==``.  The device telemetry summary
is float32 and is held to ``rel=1e-5``.
"""

import json

import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro_torch import convert

from _torch_parity import env_pair, event_key, models, placement_key, profile_pair


def _profiles(n=9, seed=3):
    pj = J.AppProfile.from_wcg_times(J.random_wcg(n, rng=np.random.default_rng(seed)))
    return pj, profile_pair(pj)


def _env_walk(seed, steps):
    """A seeded bandwidth/speedup walk with plateaus, jumps and returns."""
    rng = np.random.default_rng(seed)
    band, speed, out = 2.0, 3.0, []
    for i in range(steps):
        if i % 4 == 3:
            band = float(rng.choice([0.4, 2.0, 6.0]))
            speed = float(rng.choice([2.0, 3.0, 5.0]))
        out.append((band * (1 + 0.01 * rng.standard_normal()), speed))
    return out


@pytest.mark.parametrize("name,mj,mt", models(), ids=[m[0] for m in models()])
def test_price_report_fields_equal(name, mj, mt):
    pj, pt = _profiles()
    rng = np.random.default_rng(12)
    ej, et = env_pair(rng, 7)
    masks = rng.random((7, pj.n)) < 0.5
    masks[:, ~pj.offloadable] = True
    rj = J.price_trace(pj, mj, [(ej.env(i), masks[i]) for i in range(7)])
    rt = T.price_trace(pt, mt, [(et.env(i), masks[i]) for i in range(7)])
    for f in ("partial_cost", "no_offload_cost", "full_offload_cost", "gain"):
        assert np.array_equal(np.asarray(getattr(rj, f)), getattr(rt, f)), f
    assert len(rt) == 7 and rt.row(3) == rj.row(3)
    # batch pricing == scalar pricing, bitwise (the port's own contract)
    for i in range(7):
        g = mt.build(pt, et.env(i))
        assert rt.partial_cost[i] == g.total_cost(masks[i])
        assert rt.no_offload_cost[i] == T.no_offloading(g).cost
        assert rt.full_offload_cost[i] == T.full_offloading(g).cost
    empty = T.price_trace(pt, mt, [])
    assert len(empty) == 0


def test_vector_gain_guards_non_positive_baseline():
    from repro_torch.core.pricing import vector_gain

    out = vector_gain(np.array([10.0, 0.0, -1.0]), np.array([4.0, 1.0, 1.0]))
    assert out.tolist() == [0.6, 0.0, 0.0]
    assert T.offloading_gain(10.0, 4.0) == 0.6


def test_device_price_summary_matches_host_report_within_f32():
    _, pt = _profiles()
    pt = T.AppProfile.from_wcg_times(T.face_recognition_graph(speedup=1.0, bandwidth_mbps=1.0))
    model = T.ResponseTimeModel()
    rng = np.random.default_rng(4)
    envs = [T.Environment.symmetric(float(b), 3.0) for b in np.geomspace(0.3, 9.0, 10)]
    masks = rng.random((10, pt.n)) < 0.5
    masks[:, ~pt.offloadable] = True
    active = np.ones(10, dtype=bool)
    active[7:] = False
    out = T.device_price_summary(pt, model, envs, masks, active=active, device="cpu")
    host = T.price_trace(pt, model, list(zip(envs, masks)))
    want = {
        "partial_mean": host.partial_cost[active].mean(),
        "partial_min": host.partial_cost[active].min(),
        "partial_max": host.partial_cost[active].max(),
        "no_offload_mean": host.no_offload_cost[active].mean(),
        "full_offload_mean": host.full_offload_cost[active].mean(),
        "gain_mean": host.gain[active].mean(),
        "gain_min": host.gain[active].min(),
        "gain_max": host.gain[active].max(),
    }
    assert set(out) == set(want)
    for k, v in want.items():
        assert out[k] == pytest.approx(float(v), rel=1e-5), k
    # and against repro's jitted summary on the same inputs (both f32)
    pj = J.AppProfile.from_wcg_times(J.face_recognition_graph(speedup=1.0, bandwidth_mbps=1.0))
    jout = J.device_price_summary(
        pj, J.ResponseTimeModel(),
        [J.Environment.symmetric(float(b), 3.0) for b in np.geomspace(0.3, 9.0, 10)],
        masks, active=active,
    )
    for k in want:
        assert out[k] == pytest.approx(jout[k], rel=1e-5), k


def test_drift_test_numpy_and_torch_agree_with_repro():
    rng = np.random.default_rng(6)
    a = rng.uniform(0.5, 5.0, (3, 50))
    b = a * (1 + 0.2 * rng.standard_normal((3, 50)))
    want = J.drift_exceeded_arrays(*a, *b, 0.1)
    got = T.drift_exceeded_arrays(*a, *b, 0.1)
    assert np.array_equal(np.asarray(want), got)
    got_t = T.drift_exceeded_arrays(*(torch.tensor(x) for x in a), *(torch.tensor(x) for x in b), 0.1)
    assert np.array_equal(got_t.numpy(), got)


@pytest.mark.parametrize("name,mj,mt", models(), ids=[m[0] for m in models()])
def test_sweep_equals_serial_observe_equals_repro(name, mj, mt):
    """Reference backend: sweep ≡ serial observe() ≡ repro's events, ==,
    with and without a cache; cache counters equal."""
    pj, pt = _profiles(8, seed=5)
    walk = _env_walk(9, 14)
    envs_j = [J.Environment.symmetric(b, f) for b, f in walk]
    envs_t = [T.Environment.symmetric(b, f) for b, f in walk]
    for use_cache in (False, True):
        cj = J.PlacementCache() if use_cache else None
        ct_sweep = T.PlacementCache() if use_cache else None
        ct_serial = T.PlacementCache() if use_cache else None
        kw = dict(threshold=0.12, min_interval=2, backend="reference")
        ev_j = J.AdaptiveController(pj, mj, cache=cj, **kw).sweep(envs_j)
        ev_sweep = T.AdaptiveController(pt, mt, cache=ct_sweep, **kw).sweep(envs_t)
        serial = T.AdaptiveController(pt, mt, cache=ct_serial, **kw)
        ev_serial = [serial.observe(e) for e in envs_t]
        keys = [event_key(e) for e in ev_j]
        assert [event_key(e) for e in ev_sweep] == keys
        assert [event_key(e) for e in ev_serial] == keys
        assert any(e.repartitioned for e in ev_sweep[1:])
        if use_cache:
            sj, ss, sr = cj.stats, ct_sweep.stats, ct_serial.stats
            assert (sj.hits, sj.misses) == (ss.hits, ss.misses) == (sr.hits, sr.misses)
            assert len(cj) == len(ct_sweep) == len(ct_serial)


@pytest.mark.parametrize("backend_j,backend_t", [("jax", "torch"), ("jax", "cuda"), ("jax", "cuda_fused")])
def test_sweep_on_device_backends_gives_repro_placements(backend_j, backend_t):
    """f32 solvers: placements and decisions equal repro's jax backend;
    prices are host f64 in both, so they are == too."""
    pj, pt = _profiles(9, seed=8)
    walk = _env_walk(2, 10)
    ev_j = J.AdaptiveController(pj, J.ResponseTimeModel(), backend=backend_j).sweep(
        [J.Environment.symmetric(b, f) for b, f in walk]
    )
    ev_t = T.AdaptiveController(
        pt, T.ResponseTimeModel(), backend=backend_t, device="cpu"
    ).sweep([T.Environment.symmetric(b, f) for b, f in walk])
    assert [placement_key(e) for e in ev_t] == [placement_key(e) for e in ev_j]
    assert [e.partial_cost for e in ev_t] == [e.partial_cost for e in ev_j]


def test_observe_on_device_backends_and_rollback():
    _, pt = _profiles(7, seed=1)
    env = T.Environment.symmetric(1.5, 3.0)
    ref = T.AdaptiveController(pt, T.EnergyModel()).observe(env)
    for backend in ("torch", "cuda"):
        ev = T.AdaptiveController(pt, T.EnergyModel(), backend=backend, device="cpu").observe(env)
        assert placement_key(ev) == placement_key(ref)
    ctl = T.AdaptiveController(pt, T.EnergyModel(), backend="nope")
    with pytest.raises(ValueError):
        ctl.observe(env)
    assert ctl._has_partition is False and ctl.history == []
    with pytest.raises(RuntimeError):
        ctl.placement


def test_cache_snapshot_crosses_packages(tmp_path):
    """A snapshot saved by either package loads in the other: same keys,
    same masks, same hit behaviour."""
    pj, pt = _profiles(8, seed=2)
    walk = _env_walk(4, 12)
    cj, ct = J.PlacementCache(), T.PlacementCache()
    J.AdaptiveController(pj, J.ResponseTimeModel(), cache=cj).sweep(
        [J.Environment.symmetric(b, f) for b, f in walk])
    T.AdaptiveController(pt, T.ResponseTimeModel(), cache=ct).sweep(
        [T.Environment.symmetric(b, f) for b, f in walk])
    fj = J.profile_fingerprint(pj)
    assert fj == T.profile_fingerprint(pt)
    snap_j, snap_t = cj.snapshot(fingerprint=fj), ct.snapshot(fingerprint=fj)
    assert json.dumps(snap_j, sort_keys=True) == json.dumps(snap_t, sort_keys=True)

    # repro → file → port
    path = tmp_path / "from_jax.json"
    cj.save(path, fingerprint=fj, meta={"tick": 3})
    loaded = T.PlacementCache()
    n, meta = loaded.load_with_meta(path, fingerprint=fj, expected_n=pt.n)
    assert n == len(cj) > 0 and meta == {"tick": 3}
    warm = convert.placement_cache_from_snapshot(snap_j, fingerprint=fj)
    for b, f in walk:
        env_t, env_j = T.Environment.symmetric(b, f), J.Environment.symmetric(b, f)
        want = cj.lookup(cj.key(env_j), expected_n=pj.n)
        for cache in (loaded, warm):
            got = cache.lookup(cache.key(env_t), expected_n=pt.n)
            assert (want is None) == (got is None)
            assert want is None or np.array_equal(want, got)
    # port → file → repro
    path = tmp_path / "from_torch.json"
    ct.save(path, fingerprint=fj)
    back = J.PlacementCache()
    assert back.load(path, fingerprint=fj, expected_n=pj.n) == len(ct)
    # a snapshot for another application is refused by both
    assert T.PlacementCache().load(snap_j, fingerprint="someone-else") == 0


def test_quantizer_keys_equal():
    ej, et = env_pair(np.random.default_rng(3), 40)
    qj, qt = J.EnvQuantizer(0.07), T.EnvQuantizer(0.07)
    assert np.array_equal(qj.keys_batch(ej), qt.keys_batch(et))
    assert qj.key(ej.env(5)) == qt.key(et.env(5))


def test_baselines_equal_repro():
    gj = J.random_wcg(9, rng=np.random.default_rng(13))
    gt = convert.wcg_from_arrays(gj.w_local, gj.w_cloud, gj.adj, gj.offloadable, gj.names)
    for fn in ("no_offloading", "full_offloading", "brute_force", "maxflow_optimal", "branch_and_bound"):
        a, b = getattr(J, fn)(gj), getattr(T, fn)(gt)
        assert a.cost == b.cost and np.array_equal(a.local_mask, b.local_mask), fn
    lj = J.linear_graph(7, rng=np.random.default_rng(2))
    lt = T.linear_graph(7, rng=np.random.default_rng(2))
    assert J.chain_dp(lj).cost == T.chain_dp(lt).cost
