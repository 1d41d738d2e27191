"""``repro_torch`` graphs and cost models against ``repro`` on the CPU.

Host construction is numpy float64 in both packages, so every comparison
here is ``==`` (bitwise), never approximate.  Inputs come from seeded
numpy generators and cross between the packages as plain arrays.
"""

import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro_torch import convert

from _torch_parity import env_pair, models, profile_pair, wcg_pair

TOPOLOGIES = ["linear", "loop", "tree", "mesh"]


def _topology_pair(kind, n, seed):
    from repro.core.graph import TOPOLOGY_BUILDERS as JB
    from repro_torch.core.graph import TOPOLOGY_BUILDERS as TB

    gj = JB[kind](n, rng=np.random.default_rng(seed))
    gt = TB[kind](n, rng=np.random.default_rng(seed))
    return gj, gt


def _same_wcg(a, b):
    return (
        np.array_equal(a.w_local, b.w_local)
        and np.array_equal(a.w_cloud, b.w_cloud)
        and np.array_equal(a.adj, b.adj)
        and np.array_equal(a.offloadable, b.offloadable)
        and list(a.names) == list(b.names)
    )


@pytest.mark.parametrize("kind", TOPOLOGIES)
def test_fig2_generators_equal(kind):
    gj, gt = _topology_pair(kind, 12, seed=3)
    assert _same_wcg(gj, gt)


@pytest.mark.parametrize("name", ["paper_example_graph", "face_recognition_graph"])
def test_named_graphs_equal(name):
    assert _same_wcg(getattr(J, name)(), getattr(T, name)())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_wcg_equal(seed):
    gj = J.random_wcg(11, n_unoffloadable=2, rng=np.random.default_rng(seed))
    gt = T.random_wcg(11, n_unoffloadable=2, rng=np.random.default_rng(seed))
    assert _same_wcg(gj, gt)
    assert _same_wcg(gj, wcg_pair(gj))


@pytest.mark.parametrize("kind", TOPOLOGIES)
@pytest.mark.parametrize("model_idx", [0, 1, 2], ids=["time", "energy", "weighted"])
def test_host_weights_equal_repro(kind, model_idx):
    """build_batch rows == repro's, and build == a row of build_batch."""
    gj, _ = _topology_pair(kind, 10, seed=5)
    pj = J.AppProfile.from_wcg_times(gj, bandwidth=2.0)
    pt = profile_pair(pj)
    _, mj, mt = models()[model_idx]
    ej, et = env_pair(np.random.default_rng(7), 5)
    bj = mj.build_batch(pj, ej)
    bt = mt.build_batch(pt, et)
    for f in ("w_local", "w_cloud", "adj", "pinned"):
        assert np.array_equal(np.asarray(getattr(bj, f)), getattr(bt, f)), f
    assert bj.n_valid == bt.n_valid and bj.names == bt.names
    for i in range(et.k):
        assert _same_wcg(mt.build(pt, et.env(i)), bt.wcg(i))
        assert _same_wcg(mj.build(pj, ej.env(i)), bt.wcg(i))


def test_total_cost_and_price_batch_equal():
    rng = np.random.default_rng(11)
    gj = J.random_wcg(9, rng=np.random.default_rng(4))
    pj = J.AppProfile.from_wcg_times(gj)
    pt = profile_pair(pj)
    ej, et = env_pair(rng, 6)
    masks = rng.random((6, 9)) < 0.5
    masks[:, ~pj.offloadable] = True
    for _, mj, mt in models():
        bj, bt = mj.build_batch(pj, ej), mt.build_batch(pt, et)
        assert np.array_equal(bj.total_cost(masks), bt.total_cost(masks))
        for a, b in zip(bj.price_batch(masks), bt.price_batch(masks)):
            assert np.array_equal(a, b)
        for i in range(6):
            assert bt.wcg(i).total_cost(masks[i]) == bj.wcg(i).total_cost(masks[i])
            # unpadded batch row == scalar evaluation, bitwise
            assert bt.total_cost(masks)[i] == bt.wcg(i).total_cost(masks[i])


def test_wcg_batch_roundtrip_and_padding():
    graphs = [T.random_wcg(n, rng=np.random.default_rng(n)) for n in (4, 7, 5)]
    batch = T.WCGBatch.from_wcgs(graphs, m=8)
    assert batch.k == 3 and batch.m == 8 and batch.n_valid == (4, 7, 5)
    for g, back in zip(graphs, batch.to_wcgs()):
        assert _same_wcg(g, back)
    jb = J.WCGBatch.from_wcgs(
        [J.random_wcg(n, rng=np.random.default_rng(n)) for n in (4, 7, 5)], m=8
    )
    assert np.array_equal(jb.anchored_pinned(), batch.anchored_pinned())
    moved = convert.wcg_batch_from_arrays(
        np.asarray(jb.w_local), np.asarray(jb.w_cloud), np.asarray(jb.adj),
        np.asarray(jb.pinned), jb.n_valid, jb.names,
    )
    assert np.array_equal(moved.adj, batch.adj) and moved.n_valid == batch.n_valid


def test_wcg_batch_to_device_keeps_values():
    g = T.paper_example_graph()
    dev = T.WCGBatch.from_wcgs([g, g]).to("cpu")
    assert isinstance(dev.adj, torch.Tensor) and dev.adj.dtype == torch.float32
    assert dev.pinned.dtype == torch.bool and dev.n_valid == (6, 6)
    assert np.array_equal(dev.adj[0].numpy(), g.adj.astype(np.float32))


def test_validate_finite_names_rows():
    g = T.paper_example_graph()
    wl = np.stack([g.w_local, g.w_local])
    wl[1, 2] = np.nan
    with pytest.raises(T.NonFiniteWeightError) as e:
        T.WCGBatch.pack(wl, wl / 2, np.stack([g.adj, g.adj]),
                        np.stack([g.offloadable] * 2))
    assert e.value.rows == (1,)
    _, et = env_pair(np.random.default_rng(0), 3)
    et.speedup[2] = np.inf
    with pytest.raises(T.NonFiniteWeightError) as e:
        T.validate_env_finite(et)
    assert e.value.rows == (2,)


@pytest.mark.parametrize("model_idx", [0, 1, 2], ids=["time", "energy", "weighted"])
def test_batch_weights_on_tensors_match_numpy(model_idx):
    """The same batch_weights code on f32 torch tensors agrees with the f64
    numpy path to f32 rounding (rtol 1e-5: a handful of f32 operations)."""
    gj = J.random_wcg(8, rng=np.random.default_rng(9))
    pt = profile_pair(J.AppProfile.from_wcg_times(gj))
    _, _, mt = models()[model_idx]
    _, et = env_pair(np.random.default_rng(3), 4)
    want = mt.batch_weights(pt.t_local, pt.data_in, pt.data_out, et)
    got = mt.batch_weights(
        torch.tensor(pt.t_local, dtype=torch.float32),
        torch.tensor(pt.data_in, dtype=torch.float32),
        torch.tensor(pt.data_out, dtype=torch.float32),
        et.to("cpu"),
    )
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.broadcast_to(b, a.shape), rtol=1e-5)
