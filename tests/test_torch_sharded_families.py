"""Every family's sharded training step against the unsharded step and
``repro``'s, in one gloo world of eight CPU ranks on (data 2, model 4).

The world (``tests/_torch_dist_families.py``) runs once per module in
processes of its own, over a ``file://`` rendezvous in a temporary
directory, while this process computes the references.  Each case is a
reduced config in float32 whose parameters are carried over from the JAX
package; ``launch.specs.build_cell``'s training step (AdamW's defaults, as
the JAX cell's) runs on arguments placed as the cell's ``in_shardings``
say, and is held to

* the port's unsharded step: loss, gradient norm and the loss at the
  updated parameters within 1e-5 relative, each leaf's update (after -
  before) within 1e-2 of the reference's in norm.  xLSTM's gradient norm
  within 2e-5: at this batch its gradient moves by ~1e-5 with the order
  of the f32 sums alone (the port's unsharded step and ``repro``'s differ
  by 8.2e-6 in its norm, 211.7393 against 211.7376, and by up to 2.4e-5 in
  a leaf's gradient; the sharded step reads 211.7368, 4e-6 from
  ``repro``'s; at 2 heads over 4 model ranks the sharded step's reads
  1.3e-5 from the unsharded one's);
* ``repro``'s single-device step within 1e-4 (loss, gradient norm, the
  loss at the updated parameters) and each leaf's update within 1e-2,
  where the reference runs: not above 4096 tokens, where the reference's
  chunked MLA raises and its chunked attention core runs slowly on the CPU.

The cases: the hybrid at a batch of 2, the size of the data axis, whose 4
heads "model" splits evenly (naive attention at 16 tokens on each rank's
heads: DTensor's own rules for its einsums failed there, ROADMAP Queue
C); GQA whose heads the model axis does not split into whole
groups (4 query / 2 kv heads, and 6 / 2 in one layer at 4160 tokens, where B4's
DTensor route chunks the query heads 2, 2, 2, 0 over the four model ranks);
the hybrid (Mamba2 and the shared attention block); MoE with MLA
(deepseek-v2, also at 4160 tokens: B4 at MLA's heads) and with GQA
(llama4-scout) in both ``expert_mode``\\ s; the VLM with M-RoPE and patch
embeddings; the encoder-decoder; xLSTM, also at 2 heads over the 4 model
ranks (each rank runs both heads, and the merged heads' gradient is
gathered before it is split back into heads); and qwen3 (qk-norm) and granite
(one kv head).  One more case runs an MoE layer alone at a capacity that
the first data rank's tokens fill: the second rank's pairs to that expert
are dropped by the whole batch's capacity though its own would keep them,
and the sharded layer gives the reference's output.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

import repro.train as J
import repro_torch.train as T
from _torch_parity import model_pair
from repro_torch import convert
from repro_torch.data import DataConfig, SyntheticLMDataset

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import _torch_dist_families as W  # noqa: E402

# name: (arch, widths over the reduced config, seq_len, global batch,
#        expert_mode, held to repro)
CASES = {
    "gqa_4_2": ("phi3-medium-14b", dict(n_heads=4, n_kv_heads=2), 16, 4, "ep_model", True),
    "gqa_6_2_long": ("phi3-medium-14b", dict(n_heads=6, n_kv_heads=2, n_layers=1), 4160, 2,
                     "ep_model", False),
    "hybrid": ("zamba2-1.2b", {}, 32, 4, "ep_model", True),
    "hybrid_batch2": ("zamba2-1.2b", {}, 16, 2, "ep_model", True),
    "moe_mla": ("deepseek-v2-236b", {}, 16, 4, "ep_model", True),
    "moe_mla_long": ("deepseek-v2-236b", {}, 4160, 2, "ep_model", False),
    "moe_gqa": ("llama4-scout-17b-a16e", {}, 16, 4, "ep_model", True),
    "moe_gqa_ep_data": ("llama4-scout-17b-a16e", {}, 16, 4, "ep_data_tp_model", True),
    "vlm": ("qwen2-vl-72b", {}, 16, 4, "ep_model", True),
    "encdec": ("seamless-m4t-large-v2", {}, 16, 4, "ep_model", True),
    "ssm": ("xlstm-1.3b", {}, 8, 4, "ep_model", True),
    "ssm_uneven_heads": ("xlstm-1.3b", dict(n_heads=2), 8, 4, "ep_model", True),
    "dense_qk_norm": ("qwen3-32b", {}, 16, 4, "ep_model", False),
    "dense_mqa": ("granite-34b", {}, 16, 4, "ep_model", False),
}

# leaves each case must hold split over "model" (mesh dimension 1) at its
# widths: the paths under test run on shards, not on replicas
SPLIT = {
    "gqa_4_2": ("blocks.0.attn.wq.w", "blocks.0.attn.wk.w"),
    "gqa_6_2_long": ("blocks.0.attn.wq.w", "blocks.0.attn.wk.w"),
    "hybrid": ("mamba.0.0.in_proj.w", "mamba.0.0.conv_w", "mamba.0.0.out_proj.w",
               "shared_attn.wq.w"),
    "hybrid_batch2": ("mamba.0.0.in_proj.w", "shared_attn.wq.w"),
    "moe_mla": ("blocks.0.moe.w_gate", "blocks.0.attn.w_uq.w", "blocks.0.attn.w_uk.w",
                "blocks.0.attn.w_uv.w"),
    "moe_mla_long": ("blocks.0.moe.w_gate", "blocks.0.attn.w_uq.w"),
    "moe_gqa": ("blocks.0.moe.w_gate", "blocks.0.moe.shared.w_up.w"),
    "moe_gqa_ep_data": ("blocks.0.moe.w_gate", "blocks.0.moe.w_down"),
    "vlm": ("blocks.0.attn.wq.w",),
    "encdec": ("enc_blocks.0.attn.wq.w", "dec_blocks.0.cross_attn.wk.w"),
    "ssm": ("mlstm.0.0.wq.w", "mlstm.0.0.w_if.w", "slstm.0.w_in.w"),
    "ssm_uneven_heads": ("mlstm.0.0.wq.w", "slstm.0.w_in.w"),
    "dense_qk_norm": ("blocks.0.attn.wq.w",),
    "dense_mqa": ("blocks.0.attn.wq.w",),
}

# the MoE layer alone: llama4-scout reduced (top-1 of 8 experts), 4 x 16
# tokens, capacity 16 for the whole batch
DROPS = {"arch": "llama4-scout-17b-a16e", "batch": 4, "seq": 16, "seed": 5}


def _port(tree, cfg):
    return convert.model_params_from_jax(jax.tree_util.tree_map(np.asarray, tree), cfg)


def _drops_input(cfg, router_w: torch.Tensor) -> torch.Tensor:
    """x (4, 16, d): the first data rank's 32 tokens near the direction the
    router sends to expert 0, the second rank's drawn at random."""
    rng = np.random.default_rng(DROPS["seed"])
    b, s, d = DROPS["batch"], DROPS["seq"], cfg.d_model
    x = rng.normal(size=(b, s, d))
    u = router_w[:, 0].double().numpy()
    x[: b // 2] = 4.0 * u / np.linalg.norm(u) + 0.3 * x[: b // 2]
    return torch.tensor(x, dtype=torch.float32)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(results of the world, references computed here)."""
    in_dir = tmp_path_factory.mktemp("families_in")
    out_dir = tmp_path_factory.mktemp("families_out")
    cases, pairs = {}, {}
    for name, (arch, widths, seq, gb, mode, _) in CASES.items():
        pair = model_pair(arch, **widths)
        cfg, t_params = pair[0], pair[4]
        batch = SyntheticLMDataset(DataConfig(seq_len=seq, global_batch=gb,
                                              vocab_size=cfg.vocab_size), cfg,
                                   device="cpu").batch(0)
        sd = {k: v.clone() for k, v in t_params.state_dict().items()}
        cases[name] = {"arch": arch, "widths": widths, "expert_mode": mode, "params": sd,
                       "batch": batch}
        pairs[name] = (pair, sd, batch)
    # the MoE layer alone, in both expert modes, on the reduced llama4's first layer
    (cfg, _, _, t_model, t_params), _, _ = pairs["moe_gqa"]
    x = _drops_input(cfg, t_params.blocks[0].moe.router.w.detach())
    for mode in ("ep_model", "ep_data_tp_model"):
        cases[f"drops_{mode}"] = {"arch": DROPS["arch"], "widths": {}, "expert_mode": mode,
                                  "params": pairs["moe_gqa"][1], "x": x}
    torch.save(cases, in_dir / "cases.pt")
    env = {**os.environ, "PYTHONPATH": os.path.join(os.path.dirname(HERE), "src")}
    log = open(out_dir / "world.log", "w")
    proc = subprocess.Popen([sys.executable, os.path.join(HERE, "_torch_dist_families.py"),
                             str(in_dir), str(out_dir), "8"],
                            stdout=log, stderr=subprocess.STDOUT, env=env)
    try:
        refs = {}
        for name, ((cfg, j_model, j_params, t_model, _), sd, batch) in pairs.items():
            refs[name] = {"port": _port_step(t_model, sd, batch), "before": sd}
            if CASES[name][5] and name != "moe_gqa_ep_data":
                refs[name]["repro"] = _repro_step(cfg, j_model, j_params, batch)
        refs["moe_gqa_ep_data"]["repro"] = refs["moe_gqa"]["repro"]
        refs["drops"] = _drops_refs(pairs["moe_gqa"][0], x)
        proc.wait(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    assert proc.returncode == 0, (out_dir / "world.log").read_text()[-4000:]
    return torch.load(out_dir / "results.pt", weights_only=False), refs


def _port_step(t_model, sd, batch) -> dict:
    """The port's unsharded step (AdamW's defaults, one microbatch)."""
    params = t_model.init(0)
    params.load_state_dict(sd)
    tcfg = T.TrainConfig(optimizer=T.AdamWConfig())
    st = T.init_train_state(params, tcfg)
    _, _, _, m = T.make_train_step(t_model.train_loss, tcfg)(
        st.params, st.opt_state, None, batch, None)
    with torch.no_grad():
        after = float(t_model.train_loss(params, batch)[0])
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]), "loss_after": after,
            "params": {k: p.detach().clone() for k, p in params.named_parameters()}}


def _repro_step(cfg, j_model, j_params, batch) -> dict:
    """The JAX package's single-device step (AdamW's defaults)."""
    jcfg = J.TrainConfig(optimizer=J.AdamWConfig())
    jstep = J.make_train_step(lambda p, b: j_model.train_loss(p, b), jcfg)
    jst = J.init_train_state(j_params, jcfg)
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    jp, _, _, jm = jax.jit(jstep)(jst.params, jst.opt_state, None, jb, jax.random.PRNGKey(0))
    return {"loss": float(jm["loss"]), "grad_norm": float(jm["grad_norm"]),
            "loss_after": float(j_model.train_loss(jp, jb)[0]), "params": _port(jp, cfg)}


def _drops_refs(pair, x) -> dict:
    """The MoE layer on ``x``: ``repro``'s output and load-balancing loss,
    the port's unsharded output, loss and gradients, and the pairs the
    whole batch's capacity keeps, by data rank."""
    from repro.models import ffn as jffn
    from repro_torch.models import ffn

    cfg, j_model, j_params, _, t_params = pair
    moe = t_params.blocks[0].moe
    jp = jax.tree_util.tree_map(lambda a: a[0], j_params["blocks"]["moe"])
    j_out, j_aux = jffn.moe_forward(j_model.cfg, jp, jnp.asarray(x.numpy()))
    xg = x.clone().requires_grad_(True)
    out, aux = ffn.moe_forward(cfg, moe, xg)
    grads = torch.autograd.grad(out.sum() + aux, [xg, *moe.parameters()])
    # the reference's dispatch: top-1 expert ids, positions in token order
    m = cfg.moe
    ids = (x.reshape(-1, cfg.d_model) @ moe.router.w.detach()).argmax(-1).numpy()
    cap = ffn._capacity(m, ids.size)
    pos = np.array([(ids[:i] == ids[i]).sum() for i in range(ids.size)])
    half = ids.size // 2
    return {"repro_out": torch.tensor(np.asarray(j_out)), "repro_aux": float(j_aux),
            "out": out.detach(), "aux": float(aux.detach()), "x_grad": grads[0],
            "grads": dict(zip([k for k, _ in moe.named_parameters()], grads[1:])),
            "ids": ids, "keep": pos < cap, "cap": cap, "half": half}


def near(got: dict, want: dict, rtol: float) -> float:
    """The largest difference over the tensors of ``got``, as a share of
    the largest value of ``want``; asserts it is within ``rtol``."""
    assert set(got) == set(want)
    scale = max(float(w.abs().max()) for w in want.values())
    err = max(float((got[k].float() - want[k].float()).abs().max()) for k in want)
    assert err <= rtol * scale, (err, scale)
    return err


def updates_near(got: dict, want: dict, before: dict, rtol: float) -> float:
    """The largest ||got - want|| / ||want - before|| over the leaves (each
    leaf's update against the reference's; a lost update reads 1)."""
    assert set(got) == set(want) == set(before)
    worst = max((float((got[k] - want[k]).norm()) / float((want[k] - before[k]).norm()), k)
                for k in want)
    assert worst[0] <= rtol, worst
    return worst[0]


def _result(world, name):
    got = world[0][name]
    assert "error" not in got, got.get("error")
    return got


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_step_matches_the_unsharded_step(world, name):
    got, want = _result(world, name), world[1][name]["port"]
    assert got["placed"]
    for key in ("loss", "grad_norm", "loss_after"):
        rel = 2e-5 if key == "grad_norm" and name.startswith("ssm") else 1e-5
        assert got[key] == pytest.approx(want[key], rel=rel), key
    updates_near(got["params"], want["params"], world[1][name]["before"], 1e-2)


@pytest.mark.parametrize("name", sorted(n for n, c in CASES.items() if c[5]))
def test_sharded_step_matches_repro(world, name):
    got, want = _result(world, name), world[1][name]["repro"]
    for key in ("loss", "grad_norm", "loss_after"):
        assert got[key] == pytest.approx(want[key], rel=1e-4), key
    updates_near(got["params"], want["params"], world[1][name]["before"], 1e-2)


@pytest.mark.parametrize("name", sorted(CASES))
def test_the_leaves_under_test_are_split_over_model(world, name):
    """The rules split these leaves over "model" at the case's widths (so
    the sharded routes run on shards); zamba2's in_proj (296 columns, 74 a
    rank) has the z | x | B | C | dt boundaries inside shards."""
    placements = _result(world, name)["placements"]
    for leaf in SPLIT[name]:
        assert isinstance(placements[leaf][1], Shard), (leaf, placements[leaf])
    if name == "hybrid":
        cfg = W.case_config({"arch": CASES[name][0], "widths": {}})
        d_inner = cfg.ssm_expand * cfg.d_model
        cols = 2 * d_inner + 2 * cfg.ssm_state + d_inner // cfg.mamba_headdim
        per = cols // W.MESH[1]
        assert (cols, per) == (296, 74)
        assert all(b % per for b in (d_inner, 2 * d_inner, 2 * d_inner + cfg.ssm_state))
    if name == "moe_gqa_ep_data":   # experts over "data", d_ff over "model"
        assert placements["blocks.0.moe.w_gate"] == (Shard(0), Shard(2))
        assert placements["blocks.0.moe.w_down"] == (Shard(0), Shard(1))
    if name == "moe_gqa":           # experts over "model", nothing over "data" at this size
        assert placements["blocks.0.moe.w_gate"] == (Replicate(), Shard(0))


def test_capacity_drops_fall_unevenly_across_data_ranks(world):
    """The input the drops cases run: the first data rank's tokens overflow
    expert 0 on their own; the second rank's pairs to expert 0 are fewer
    than a capacity of its own tokens would hold, and the whole batch's
    capacity drops them all."""
    ref = world[1]["drops"]
    ids, keep, half, cap = ref["ids"], ref["keep"], ref["half"], ref["cap"]
    first, second = ids[:half] == 0, ids[half:] == 0
    assert first.sum() > cap and not keep[:half][first].all()
    from repro_torch.models.ffn import _capacity

    moe = W.case_config({"arch": DROPS["arch"], "widths": {}}).moe
    assert 0 < second.sum() <= _capacity(moe, half)
    assert not keep[half:][second].any()
    assert keep[half:][~second].all()


@pytest.mark.parametrize("mode", ["ep_model", "ep_data_tp_model"])
def test_sharded_moe_layer_keeps_the_references_drops(world, mode):
    got, ref = _result(world, f"drops_{mode}"), world[1]["drops"]
    near({"out": got["out"]}, {"out": ref["repro_out"]}, 1e-5)
    assert got["aux"] == pytest.approx(ref["repro_aux"], rel=1e-5)
    near({"out": got["out"]}, {"out": ref["out"]}, 1e-6)
    near({"x": got["x_grad"]}, {"x": ref["x_grad"]}, 1e-5)
    near(got["grads"], ref["grads"], 1e-5)
