"""The optimizer, the trainer and gradient compression against ``repro``'s.

AdamW, its clipping and its schedule on the same trees (a reduced zamba2's
parameters, carried across by ``convert.model_params_from_jax``, with
seeded gradients), the weight decay of the leaves the JAX package stacks
over layers (1-D here, decayed there), microbatch accumulation against the
full batch, ``train_loop``'s losses against the JAX package's over five
steps of reduced qwen2-7b and zamba2, top-k compression ``==`` and int8
within one quantisation step, and a falling loss on the learnable data.

Tolerances: AdamW, clipping and the schedule are float32 elementwise
arithmetic in the same order: 1e-6 relative (XLA may fuse a multiply-add).
Five training steps: losses to 1e-4 relative (the gradients' float32
differences, 1e-6 relative, move the parameters by ~lr x 1e-6 a step).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.runtime.compression as j_comp
import repro.train as J
import repro_torch.runtime.compression as t_comp
import repro_torch.train as T
from _torch_parity import model_pair
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLMDataset as JDataset
from repro_torch import convert
from repro_torch.data import DataConfig, SyntheticLMDataset

OPT = dict(lr=1e-2, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, grad_clip=1.0,
           warmup_steps=2, total_steps=6, min_lr_frac=0.1)


@pytest.fixture(scope="module")
def zamba_trees():
    """(cfg, JAX params, port params dict, seeded JAX grads for 3 steps)."""
    cfg, _, j_params, _, t_params = model_pair("zamba2-1.2b")
    rng = np.random.default_rng(3)
    grads = [jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(np.float32) * 0.3), j_params)
        for _ in range(3)]
    return cfg, j_params, {k: p.detach().clone() for k, p in t_params.named_parameters()}, grads


def _port(tree, cfg):
    return convert.model_params_from_jax(jax.tree_util.tree_map(np.asarray, tree), cfg)


def _close(got: dict, want: dict, rtol: float = 1e-6):
    assert set(got) == set(want)
    for k in want:
        w = want[k].float()
        err = float((got[k].detach().float() - w).abs().max())
        assert err <= rtol * max(float(w.abs().max()), 1e-30), (k, err)


def test_weight_decay_follows_the_jax_leaf_rank(zamba_trees):
    cfg, _, params, _ = zamba_trees
    mask = convert.weight_decay_mask(params)
    # stacked per-layer leaves, 1-D here: decayed, as the JAX package decays them
    for name in ("mamba.0.0.norm.scale", "mamba.0.0.a_log", "mamba.0.1.d_skip",
                 "mamba.0.0.dt_bias", "mamba.0.0.conv_b"):
        assert params[name].ndim == 1 and mask[name], name
    assert params["shared_ln"].ndim == 2 and mask["shared_ln"]
    # leaves the JAX package does not stack: their own rank decides
    assert params["final_norm.scale"].ndim == 1 and not mask["final_norm.scale"]
    assert mask["embed.embedding"] and mask["shared_attn.wq.w"]
    assert convert.jax_leaf_ndim("mamba.0.0.a_log", 1) == 3
    assert convert.jax_leaf_ndim("blocks.3.ln1.scale", 1) == 2


def test_adamw_three_steps_match_jax(zamba_trees):
    cfg, j_params, params, grads = zamba_trees
    opt = T.AdamWConfig(**OPT)
    j_opt = J.AdamWConfig(**OPT)
    j_state = J.init_opt_state(j_params)
    t_params = {k: v.clone() for k, v in params.items()}
    t_state = T.init_opt_state(t_params)
    jp = j_params
    for g in grads:
        jp, j_state, jm = J.adamw_update(j_opt, jp, g, j_state)
        _, t_state, tm = T.adamw_update(opt, t_params, _port(g, cfg), t_state)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-6)
    assert int(t_state["step"]) == int(j_state["step"]) == 3
    _close(t_params, _port(jp, cfg))
    _close(t_state["mu"], _port(j_state["mu"], cfg))
    _close(t_state["nu"], _port(j_state["nu"], cfg))
    # the update decays a stacked 1-D leaf and not an unstacked one: against
    # the same step without weight decay, the first moved, the second did not
    plain = {k: v.clone() for k, v in params.items()}
    T.adamw_update(T.AdamWConfig(**dict(OPT, weight_decay=0.0)), plain, _port(grads[0], cfg),
                   T.init_opt_state(plain))
    once = {k: v.clone() for k, v in params.items()}
    T.adamw_update(opt, once, _port(grads[0], cfg), T.init_opt_state(once))
    assert not torch.equal(plain["mamba.0.0.a_log"], once["mamba.0.0.a_log"])
    assert torch.equal(plain["final_norm.scale"], once["final_norm.scale"])


def test_clip_by_global_norm_matches_jax(zamba_trees):
    cfg, _, _, grads = zamba_trees
    for max_norm in (1.0, 1e9):
        j_clipped, j_norm = J.clip_by_global_norm(grads[0], max_norm)
        t_clipped, t_norm = T.clip_by_global_norm(_port(grads[0], cfg), max_norm)
        assert float(t_norm) == pytest.approx(float(j_norm), rel=1e-6)
        _close(t_clipped, _port(j_clipped, cfg))


def test_cosine_schedule_matches_jax():
    cfg = dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    j_lr, t_lr = J.cosine_schedule(J.AdamWConfig(**cfg)), T.cosine_schedule(T.AdamWConfig(**cfg))
    for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        want = float(j_lr(jnp.asarray(step, jnp.int32)))
        assert float(t_lr(torch.tensor(step, dtype=torch.int32))) == pytest.approx(want, rel=1e-6)


def _dataset(cfg, seq_len, batch, seed=0):
    return SyntheticLMDataset(DataConfig(seq_len, batch, cfg.vocab_size, seed=seed), cfg,
                              device="cpu")


def test_microbatch_accumulation_equals_the_full_batch():
    cfg, _, _, t_model, t_params = model_pair("qwen2-7b")
    batch = _dataset(cfg, 16, 8).batch(0)
    leaves = dict(t_params.named_parameters())
    steps = {}
    for n_micro in (1, 4):
        tcfg = T.TrainConfig(optimizer=T.AdamWConfig(**OPT), n_micro=n_micro)
        captured = {}

        def capture(cfg_, params, grads, state, *, captured=captured):
            captured.update(grads)
            return params, state, {"lr": torch.zeros(()), "grad_norm": torch.zeros(())}

        step = T.make_train_step(t_model.train_loss, tcfg)
        orig, T.trainer.adamw_update = T.trainer.adamw_update, capture
        try:
            _, _, _, m = step(t_params, T.init_opt_state(leaves), None, batch, None)
        finally:
            T.trainer.adamw_update = orig
        steps[n_micro] = (float(m["loss"]), captured)
    (l1, g1), (l4, g4) = steps[1], steps[4]
    assert l4 == pytest.approx(l1, rel=1e-6)
    _close(g4, g1, rtol=1e-5)


@pytest.mark.parametrize("arch", ["qwen2-7b", "zamba2-1.2b"])
def test_train_loop_losses_match_jax(arch):
    cfg, j_model, j_params, t_model, t_params = model_pair(arch)
    opt = dict(OPT, lr=3e-3, total_steps=5)
    j_data = JDataset(JDataConfig(16, 4, cfg.vocab_size, seed=1), cfg)
    _, j_hist = J.train_loop(lambda p, b: j_model.train_loss(p, b), j_params,
                             j_data.take(5), J.TrainConfig(optimizer=J.AdamWConfig(**opt)))
    data = _dataset(cfg, 16, 4, seed=1)
    _, t_hist = T.train_loop(t_model.train_loss, t_params, data.take(5),
                             T.TrainConfig(optimizer=T.AdamWConfig(**opt)))
    for key in ("loss", "grad_norm", "lr"):
        got, want = [h[key] for h in t_hist], [h[key] for h in j_hist]
        np.testing.assert_allclose(got, want, rtol=1e-4, err_msg=key)


def test_topk_compression_equals_jax_and_int8_is_within_a_step(zamba_trees):
    cfg, _, _, grads = zamba_trees
    j_state = j_comp.init_compression_state(grads[0])
    t_grads = [_port(g, cfg) for g in grads]
    t_state = t_comp.init_compression_state(t_grads[0])
    # a stacked JAX leaf (the Mamba2 layers' in_proj.w, ...) is one unit
    groups = convert.jax_leaf_groups(t_grads[0])
    assert groups["mamba.0.1.in_proj.w"] == groups["mamba.0.0.in_proj.w"] == "mamba.in_proj.w"
    for g_j, g_t in zip(grads, t_grads):     # the residual carries across steps
        j_sent, j_state = j_comp.topk_compress_with_ef(g_j, j_state, frac=0.05)
        t_sent, t_state = t_comp.topk_compress_with_ef(g_t, t_state, frac=0.05)
        for got, want in ((t_sent, _port(j_sent, cfg)), (t_state.residual,
                                                         _port(j_state.residual, cfg))):
            assert all(torch.equal(got[k], want[k]) for k in want)
    for scheme in ("topk", "int8", "none"):
        assert t_comp.wire_bytes(t_grads[0], scheme=scheme, frac=0.05) == (
            j_comp.wire_bytes(grads[0], scheme=scheme, frac=0.05))
    # int8: one quantisation step at most, the JAX package's scales, unbiased
    gen = torch.Generator().manual_seed(0)
    _, j_scales = j_comp.int8_compress(grads[0], jax.random.PRNGKey(0))
    j_scales = {".".join(str(k.key) for k in path): float(v)
                for path, v in jax.tree_util.tree_flatten_with_path(j_scales)[0]}
    g = t_grads[0]
    draws = []
    for _ in range(64):
        q8, scales = t_comp.int8_compress(g, gen)
        back = t_comp.int8_decompress(q8, scales)
        for k in g:
            assert q8[k].dtype == torch.int8 and int(q8[k].abs().max()) <= 127
            assert float(scales[k]) == pytest.approx(j_scales[groups[k]], rel=1e-6)
            assert float((back[k] - g[k]).abs().max()) <= float(scales[k]) * (1 + 1e-5)
        draws.append(back["shared_attn.wq.w"])
    mean = torch.stack(draws).mean(0)
    step = float(scales["shared_attn.wq.w"])
    # E[q scale] = g: the mean of 64 draws is within 4 sigma (sigma <= step / 16)
    assert float((mean - g["shared_attn.wq.w"]).abs().max()) <= 4 * step / 16 * 1.5


def test_both_compression_modes_train_and_the_loss_falls():
    cfg, _, _, t_model, t_params = model_pair("qwen2-7b")
    init = {k: v.detach().clone() for k, v in t_params.state_dict().items()}
    data = _dataset(cfg, 32, 8)
    tcfg = T.TrainConfig(optimizer=T.AdamWConfig(lr=2e-3, warmup_steps=5, total_steps=40))
    _, hist = T.train_loop(t_model.train_loss, t_params, data.take(40), tcfg)
    first = np.mean([h["loss"] for h in hist[:5]])
    last = np.mean([h["loss"] for h in hist[-5:]])
    assert last < first - 0.2, (first, last)
    for mode in ("topk", "int8"):
        with torch.no_grad():
            t_params.load_state_dict(init)
        tcfg = T.TrainConfig(optimizer=T.AdamWConfig(lr=2e-3, warmup_steps=2, total_steps=20),
                             compression=mode)
        _, hist = T.train_loop(t_model.train_loss, t_params, _dataset(cfg, 16, 4).take(12),
                               tcfg)
        losses = [h["loss"] for h in hist]
        assert np.isfinite(losses).all() and np.mean(losses[-3:]) < np.mean(losses[:3]), mode
