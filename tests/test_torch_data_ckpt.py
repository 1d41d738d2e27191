"""The data pipeline, the checkpoint store and the training driver.

Batches ``==`` ``repro``'s (tokens, labels and the frontends' embeddings,
host-sharded too); the reference's checkpoint tests mirrored (roundtrip and
retention, an incomplete checkpoint invisible, corruption detected, an
async save that completes, a resume that reproduces the uninterrupted
run), a checkpoint written by either package read by the other, and
``launch/train.py --reduced --device cpu``.
"""

from __future__ import annotations

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointStore as JStore
from repro.configs import ARCHITECTURES as J_ARCHS
from repro.configs import reduce_config as j_reduce
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLMDataset as JDataset
from repro.data import make_batch_shapes as j_shapes
from repro_torch.checkpoint import CheckpointStore
from repro_torch.configs import ARCHITECTURES, reduce_config
from repro_torch.data import DataConfig, SyntheticLMDataset, make_batch_shapes
from repro_torch.launch import train as train_launch


@pytest.mark.parametrize("arch,dtype,hosts", [
    ("qwen2-7b", "float32", 1), ("qwen2-vl-72b", "bfloat16", 1),
    ("seamless-m4t-large-v2", "float32", 2), ("zamba2-1.2b", "bfloat16", 2)])
def test_batches_equal_repro(arch, dtype, hosts):
    j_cfg = j_reduce(J_ARCHS[arch], dtype=dtype)
    t_cfg = reduce_config(ARCHITECTURES[arch], dtype=dtype)
    for host in range(hosts):
        j_data = JDataset(JDataConfig(24, 4, j_cfg.vocab_size, seed=7, num_hosts=hosts,
                                      host_index=host), j_cfg)
        t_data = SyntheticLMDataset(DataConfig(24, 4, t_cfg.vocab_size, seed=7,
                                               num_hosts=hosts, host_index=host), t_cfg,
                                    device="cpu")
        for step in (0, 1, 5):
            want, got = j_data.batch(step), t_data.batch(step)
            assert set(got) == set(want)
            for key, w in want.items():
                g = got[key]
                assert g.shape == w.shape and g.device.type == "cpu", key
                if key in ("tokens", "labels"):
                    assert g.dtype == torch.int64
                    assert np.array_equal(g.numpy(), np.asarray(w)), key
                else:
                    assert str(g.dtype).split(".")[1] == str(w.dtype), key
                    assert np.array_equal(g.float().numpy(), np.asarray(w, np.float32)), key
    shapes, j_sh = make_batch_shapes(t_cfg, 24, 4), j_shapes(j_cfg, 24, 4)
    assert {k: tuple(v.shape) for k, v in shapes.items()} == {
        k: tuple(v.shape) for k, v in j_sh.items()}
    assert all(v.device.type == "meta" for v in shapes.values())


def _tree(seed: int = 0) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(3, 4, generator=g).to(torch.bfloat16),
                       "b": torch.randn(4, generator=g)},
            "opt": {"mu": {"w": torch.randn(3, 4, generator=g)},
                    "step": torch.tensor(7, dtype=torch.int32)}}


def _equal(a: dict, b: dict) -> bool:
    from repro_torch.checkpoint.store import flatten

    fa, fb = flatten(a), flatten(b)
    return [p for p, _ in fa] == [p for p, _ in fb] and all(
        x.dtype == y.dtype and torch.equal(x, y) for (_, x), (_, y) in zip(fa, fb))


def test_checkpoint_roundtrip_and_retention(tmp_path):
    store = CheckpointStore(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        store.save(s, _tree(s))
    assert store.steps() == [2, 3]  # keep=2 removed step 1
    assert sorted(os.listdir(tmp_path)) == ["step_000000002", "step_000000003"]
    step, restored, extra = store.restore_latest(_tree(0))
    assert step == 3 and extra == {} and _equal(restored, _tree(3))


def test_incomplete_checkpoint_is_invisible(tmp_path):
    store = CheckpointStore(str(tmp_path))
    store.save(5, {"w": torch.ones(3)})
    os.makedirs(tmp_path / "step_000000007.tmp")   # a crash mid-save
    os.makedirs(tmp_path / "step_000000008")        # no manifest yet
    assert store.latest_step() == 5


def test_checkpoint_corruption_detected(tmp_path):
    store = CheckpointStore(str(tmp_path))
    path = store.save(1, {"w": torch.arange(8, dtype=torch.float32)})
    leaf = os.path.join(path, "leaf_00000.npy")
    arr = np.load(leaf)
    arr[0] = 999.0
    np.save(leaf, arr)
    with pytest.raises(IOError, match="checksum"):
        store.restore(1, {"w": torch.zeros(8)})
    with pytest.raises(ValueError, match="leaves"):
        store.restore(1, {"w": torch.zeros(8), "v": torch.zeros(1)}, verify=False)


def test_async_save_completes_from_a_host_snapshot(tmp_path):
    store = CheckpointStore(str(tmp_path))
    tree = _tree(4)
    store.save_async(9, tree)
    with torch.no_grad():   # the step may overwrite its tensors at once
        tree["params"]["b"].fill_(0.0)
    store.wait()
    assert store.latest_step() == 9
    _, restored, _ = store.restore_latest(_tree(0))
    assert _equal(restored, _tree(4))


def test_checkpoints_cross_between_the_packages(tmp_path):
    """The same layout: a tree saved by either store restores in the other,
    bf16 leaves included."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 4)).astype(np.float32)
    j_tree = {"a": jnp.asarray(w, jnp.bfloat16), "b": jnp.asarray(w[0]),
              "c": jnp.asarray(np.int32(5))}
    JStore(str(tmp_path / "j")).save(2, j_tree)
    t_like = {"a": torch.zeros(3, 4, dtype=torch.bfloat16), "b": torch.zeros(4),
              "c": torch.tensor(0, dtype=torch.int32)}
    _, got, _ = CheckpointStore(str(tmp_path / "j")).restore_latest(t_like)
    assert np.array_equal(got["a"].float().numpy(), np.asarray(j_tree["a"], np.float32))
    assert np.array_equal(got["b"].numpy(), w[0]) and int(got["c"]) == 5
    CheckpointStore(str(tmp_path / "t")).save(3, got)
    _, back, _ = JStore(str(tmp_path / "t")).restore_latest(j_tree)
    for key in j_tree:
        assert back[key].dtype == j_tree[key].dtype
        assert np.array_equal(np.asarray(back[key], np.float32),
                              np.asarray(j_tree[key], np.float32))


def _args(ckpt: str, steps: int = 4) -> list[str]:
    return ["--arch", "qwen2-7b", "--reduced", "--device", "cpu", "--steps", str(steps),
            "--seq-len", "16", "--global-batch", "4", "--log-every", "1",
            "--ckpt-dir", ckpt, "--ckpt-every", "2"]


def test_resume_reproduces_the_uninterrupted_run(tmp_path):
    """Run 4 steps saving at step 2 (in the background) and at the end;
    then resume a fresh run from the step-2 checkpoint alone: its steps 2
    and 3 give the uninterrupted run's losses, bit for bit."""
    full = train_launch.run(_args(str(tmp_path / "a")))
    assert full["start"] == 0 and len(full["history"]) == 4
    os.makedirs(tmp_path / "b")
    shutil.copytree(tmp_path / "a" / "step_000000002", tmp_path / "b" / "step_000000002")
    resumed = train_launch.run(_args(str(tmp_path / "b")))
    assert resumed["start"] == 2
    for key in ("loss", "grad_norm", "lr"):
        assert [h[key] for h in resumed["history"]] == [h[key] for h in full["history"][2:]]
    assert CheckpointStore(str(tmp_path / "b")).latest_step() == 4


def test_launch_train_on_the_cpu(capsys):
    assert train_launch.main(["--arch", "zamba2-1.2b", "--reduced", "--device", "cpu",
                              "--steps", "2", "--seq-len", "32", "--global-batch", "2",
                              "--log-every", "1"]) == 0
    out = capsys.readouterr().out
    assert "[train] MCOP placement" in out and "[train] done" in out
    lines = [ln for ln in out.splitlines() if ln.startswith("[train] step")]
    assert len(lines) == 2 and all("tok/s" in ln and "gnorm" in ln for ln in lines)


def test_launch_train_runs_with_deterministic_algorithms():
    """The entry itself turns deterministic algorithms on for its steps (the
    resume guarantee rests on it, not on its caller) and restores the
    caller's setting on return."""
    seen = []
    assert not torch.are_deterministic_algorithms_enabled()
    train_launch.run(["--arch", "qwen2-7b", "--reduced", "--device", "cpu", "--steps", "1",
                      "--seq-len", "16", "--global-batch", "2"],
                     hooks=[lambda step, m: seen.append(
                         (torch.are_deterministic_algorithms_enabled(),
                          torch.is_deterministic_algorithms_warn_only_enabled()))])
    assert seen == [(True, False)]
    assert not torch.are_deterministic_algorithms_enabled()
