"""The port's distributed training against the JAX package's, in one gloo
world of eight CPU ranks: the counterparts of ``tests/test_distributed.py``.

The world (``tests/_torch_dist_world.py``) runs in processes of its own
over a ``file://`` rendezvous in a temporary directory (no port is
fixed, so several test workers can each run a world).  It runs once per
module; the tests read its results.

* ``shard_params`` places ``wq`` as ``(None, "model")`` on (data 2, model
  4) and the forward runs;
* one sharded AdamW step of the reduced qwen2-7b (widened as the JAX test
  widens it, float32) on (data 2, model 4) against the port's unsharded
  step (loss, gradient norm and the loss at the updated parameters within
  1e-5 relative, the moments within 1e-5 of the largest) and ``repro``'s
  single-device step (1e-4), at 16 tokens, at 4160 (above
  ``CHUNKED_ABOVE``: the DTensor route to B4's plain version) and at
  widths whose large leaves take the FSDP axis (d 1024, vocab 2048: the
  weights gathered over "data" before each product, the gradients
  reduce-scattered).  The loss at the updated parameters is the loss the
  next step reports: it moves 5-94 % with the update, so an update that
  never reaches the DTensor parameters fails it.  Each leaf's update
  (after - before) within 1e-2 of the reference's in norm (a lost update
  reads 1; AdamW's first step moves an element by lr g / (|g| + eps), so
  the few elements whose gradient is at the rounding of its sums move by
  an amount of either sign: 3.0e-3 between the port's unsharded step and
  ``repro``'s on ``wk``'s bias); the parameters within the JAX test's 0.15;
* ``launch.specs.build_cell``'s training step (two microbatches, then
  AdamW) on DTensors placed by the cell, against the unsharded step (loss,
  gradient norm and the loss at the updated parameters within 1e-5, each
  leaf's update within 1e-2);
* ``pipeline_apply`` on (pod 2, data 4) against the sequential stack: the
  tanh stack for n_micro 1, 2, 4 (output and the gradients of its sum with
  respect to x and the weights, within 1e-6 of the largest), and four
  reduced qwen2-7b blocks as ``stage_fn`` (1e-5);
* a sum over (pod 2, data 2, model 2) placed ``(("pod", "data"), "model")``;
* a checkpoint saved from (data 2, model 4) restores ``==`` onto (data 4,
  model 2) with the new placements.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Shard

import repro.train as J
import repro_torch.train as T
from _torch_parity import model_pair
from repro_torch import convert
from repro_torch.data import DataConfig, SyntheticLMDataset

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import _torch_dist_world as W  # noqa: E402

# (seq_len, global batch, widths over the widened config): "fsdp" makes the
# large leaves big enough (>= 2^20 elements) for the FSDP axis over "data"
STEPS = {"short": (16, 8, {}), "long": (4160, 2, {}),
         "fsdp": (64, 8, dict(d_model=1024, n_heads=8, head_dim=128, d_ff=2048,
                              vocab_size=2048))}


def _port(tree, cfg):
    return convert.model_params_from_jax(jax.tree_util.tree_map(np.asarray, tree), cfg)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(results of the world, references computed here).  The inputs are
    written first; the world runs in its processes while this one computes
    the references."""
    in_dir = tmp_path_factory.mktemp("world_in")
    out_dir = tmp_path_factory.mktemp("world_out")
    cases, before = {}, {}
    for tag, (seq, gb, widths) in STEPS.items():
        cfg, j_model, j_params, t_model, t_params = model_pair("qwen2-7b", **{
            **{k: v for k, v in W.WIDE.items() if k != "dtype"}, **widths})
        batch = SyntheticLMDataset(DataConfig(seq_len=seq, global_batch=gb,
                                              vocab_size=cfg.vocab_size), cfg,
                                   device="cpu").batch(0)
        sd = {k: v.clone() for k, v in t_params.state_dict().items()}
        before[tag] = sd
        torch.save({"params": sd, "batch": batch, "widths": widths}, in_dir / f"step_{tag}.pt")
        cases[tag] = (cfg, j_model, j_params, t_model, sd, batch)
    env = {**os.environ, "PYTHONPATH": os.path.join(os.path.dirname(HERE), "src")}
    log = open(out_dir / "world.log", "w")
    proc = subprocess.Popen([sys.executable, os.path.join(HERE, "_torch_dist_world.py"),
                             str(in_dir), str(out_dir), "8"],
                            stdout=log, stderr=subprocess.STDOUT, env=env)
    try:
        refs = {}
        for tag, (cfg, j_model, j_params, t_model, sd, batch) in cases.items():
            refs[tag] = {"port": _port_step(t_model, sd, batch, T.AdamWConfig(**W.OPT)),
                         "repro": _repro_step(cfg, j_model, j_params, batch)}
        cfg, _, _, t_model, sd, batch = cases["short"]
        # build_cell's step: two microbatches, AdamW's defaults
        refs["cell"] = _port_step(t_model, sd, batch, T.AdamWConfig(), n_micro=2)
        refs["before"] = before
        proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    assert proc.returncode == 0, (out_dir / "world.log").read_text()[-4000:]
    return torch.load(out_dir / "results.pt", weights_only=False), refs


def _port_step(t_model, sd, batch, opt, n_micro=1) -> dict:
    """The port's unsharded step from the state dict ``sd``."""
    params = t_model.init(0)
    params.load_state_dict(sd)
    tcfg = T.TrainConfig(optimizer=opt, n_micro=n_micro)
    st = T.init_train_state(params, tcfg)
    _, state, _, m = T.make_train_step(t_model.train_loss, tcfg)(
        st.params, st.opt_state, None, batch, None)
    with torch.no_grad():
        after = float(t_model.train_loss(params, batch)[0])
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]), "loss_after": after,
            "params": {k: p.detach().clone() for k, p in params.named_parameters()},
            "mu": state["mu"], "nu": state["nu"]}


def _repro_step(cfg, j_model, j_params, batch) -> dict:
    """The JAX package's single-device step."""
    jcfg = J.TrainConfig(optimizer=J.AdamWConfig(**W.OPT))
    jstep = J.make_train_step(lambda p, b: j_model.train_loss(p, b), jcfg)
    jst = J.init_train_state(j_params, jcfg)
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    jp, jo, _, jm = jax.jit(jstep)(jst.params, jst.opt_state, None, jb, jax.random.PRNGKey(0))
    return {"loss": float(jm["loss"]), "grad_norm": float(jm["grad_norm"]),
            "loss_after": float(j_model.train_loss(jp, jb)[0]),
            "params": _port(jp, cfg), "mu": _port(jo["mu"], cfg), "nu": _port(jo["nu"], cfg)}


def near(got: dict, want: dict, rtol: float) -> float:
    """The largest difference over the tensors of ``got``, as a share of
    the largest value of ``want``; asserts it is within ``rtol``."""
    assert set(got) == set(want)
    scale = max(float(w.abs().max()) for w in want.values())
    err = max(float((got[k].float() - want[k].float()).abs().max()) for k in want)
    assert err <= rtol * scale, (err, scale)
    return err


def updates_near(got: dict, want: dict, before: dict, rtol: float) -> float:
    """The largest ||got - want|| / ||want - before|| over the leaves: each
    leaf's update against the reference's update; asserts it is within
    ``rtol``."""
    assert set(got) == set(want) == set(before)
    worst = max(float((got[k] - want[k]).norm()) / float((want[k] - before[k]).norm())
                for k in want)
    assert worst <= rtol, worst
    return worst


def test_shard_params_places_wq_and_the_forward_runs(world):
    res = world[0]["place"]
    assert res["wq"] == res["wq_want"]
    assert np.isfinite(res["loss"])


@pytest.mark.parametrize("tag", sorted(STEPS))
def test_sharded_step_matches_the_unsharded_step(world, tag):
    got, want = world[0][f"step_{tag}"], world[1][tag]["port"]
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
    assert got["grad_norm"] == pytest.approx(want["grad_norm"], rel=1e-5)
    assert got["loss_after"] == pytest.approx(want["loss_after"], rel=1e-5)
    near(got["mu"], want["mu"], 1e-5)
    near(got["nu"], want["nu"], 1e-5)
    assert near(got["params"], want["params"], 1.0) <= 2.5 * W.OPT["lr"]
    updates_near(got["params"], want["params"], world[1]["before"][tag], 1e-2)
    # the moments inherit the parameters' placements
    assert got["mu_placements"] == got["param_placements"]
    if tag == "fsdp":   # the FSDP axis is taken: wq is (data, model)
        assert got["param_placements"]["blocks.0.attn.wq.w"] == (Shard(0), Shard(1))


@pytest.mark.parametrize("tag", sorted(STEPS))
def test_sharded_step_matches_repro(world, tag):
    got, want = world[0][f"step_{tag}"], world[1][tag]["repro"]
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-4)
    assert got["grad_norm"] == pytest.approx(want["grad_norm"], rel=1e-4)
    assert got["loss_after"] == pytest.approx(want["loss_after"], rel=1e-4)
    near(got["mu"], want["mu"], 1e-4)
    near(got["nu"], want["nu"], 1e-4)
    worst = near(got["params"], want["params"], 1.0)
    assert worst < 0.15 and worst <= 2.5 * W.OPT["lr"]
    updates_near(got["params"], want["params"], world[1]["before"][tag], 1e-2)


def test_build_cell_step_runs_on_dtensors(world):
    """The dense cell's ``step_fn`` on arguments placed as its
    ``in_shardings`` say: two microbatches, then AdamW, against the port's
    unsharded step with the same microbatches."""
    got, want = world[0]["cell"], world[1]["cell"]
    assert got["placed"]
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
    assert got["grad_norm"] == pytest.approx(want["grad_norm"], rel=1e-5)
    assert got["loss_after"] == pytest.approx(want["loss_after"], rel=1e-5)
    assert near(got["params"], want["params"], 1.0) <= 2.5 * T.AdamWConfig().lr
    updates_near(got["params"], want["params"], world[1]["before"]["short"], 1e-2)


def sequential(stage_fn, params: dict, x):
    """Output and the gradients of its sum, by autograd through the stack."""
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    x = x.clone().requires_grad_(True)
    out = stage_fn(leaves, x)
    out.sum().backward()
    return out.detach(), x.grad, {k: v.grad for k, v in leaves.items()}


@pytest.mark.parametrize("n_micro", [1, 2, 4])
def test_pipeline_matches_sequential_tanh_stack(world, n_micro):
    from repro_torch.runtime import stack_stage_params

    res = world[0]["pipeline"][f"tanh_{n_micro}"]
    w, x = W.tanh_stack()
    out, gx, gp = sequential(W.tanh_stage, {"w": w}, x)
    assert float((res["out"] - out).abs().max()) < 1e-6
    near({"x": res["x_grad"]}, {"x": gx}, 1e-6)
    near(res["p_grads"], stack_stage_params(gp, 2), 1e-6)


def test_pipeline_with_qwen2_blocks_as_stages(world):
    res = world[0]["pipeline"]["qwen_2"]
    blocks, call, x = W.qwen_blocks()
    stacked, _ = torch.func.stack_module_state(list(blocks))
    out, gx, gp = sequential(W.block_stage(call), stacked, x)
    near({"out": res["out"]}, {"out": out}, 1e-5)
    near({"x": res["x_grad"]}, {"x": gx}, 1e-5)
    from repro_torch.runtime import stack_stage_params

    near(res["p_grads"], stack_stage_params(gp, 2), 1e-5)


def test_multipod_mesh_cross_pod_sum(world):
    res = world[0]["sum"]
    assert res["total"] == res["want"] == 120.0
    assert res["local"] == (2, 1)   # 8 rows over pod x data, 2 columns over model


def test_checkpoint_restore_onto_different_mesh(world, tmp_path):
    res = world[0]["ckpt"]
    assert res["equal"] and res["placed"]
