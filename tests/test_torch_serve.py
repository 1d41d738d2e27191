"""The port's serving slice against the JAX package on the CPU: the hybrid
model's prefill and decode, the ring cache, the engine's greedy tokens, the
serving placement report and the model's parameter count.

Reduced zamba2 in float32 with the JAX parameters carried over through
``convert.model_params_from_jax``.  Tolerance 1e-4 for logits and caches
(float32 sums in another order through a few layers); greedy tokens and
placements ``==``.  In bfloat16 the two frameworks round at other places
(the attention score product, per-op rounding of elementwise work), so
bf16 logits are held to 5 % of their largest magnitude (a few bf16 ulps
there)."""

import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHITECTURES, SHAPES, reduce_config
from repro.core import placement as j_pl
from repro.models import attention as j_attn
from repro.models.transformer import Model as JModel
from repro.profilers import program as j_prog
from repro.serving import ServingConfig as JServingConfig
from repro.serving import ServingEngine as JServingEngine
from repro_torch import convert
from repro_torch.configs import ARCHITECTURES as T_ARCHITECTURES
from repro_torch.configs import SHAPES as T_SHAPES
from repro_torch.configs import reduce_config as t_reduce_config
from repro_torch.core import placement as t_pl
from repro_torch.models import attention as t_attn
from repro_torch.models.transformer import Model as TModel
from repro_torch.profilers import program as t_prog
from repro_torch.serving import ServingConfig as TServingConfig
from repro_torch.serving import ServingEngine as TServingEngine

TOL = 1e-4


def _np(a) -> np.ndarray:
    return np.asarray(a, np.float32)


def _close(got: torch.Tensor, want, tol: float = TOL) -> None:
    np.testing.assert_allclose(got.detach().to(torch.float32).numpy(), _np(want), atol=tol, rtol=tol)


@pytest.fixture(scope="module")
def zamba():
    """(config, JAX model, JAX params, port model, port params)."""
    j_cfg = reduce_config(ARCHITECTURES["zamba2-1.2b"], dtype="float32")
    t_cfg = t_reduce_config(T_ARCHITECTURES["zamba2-1.2b"], dtype="float32")
    assert dataclasses.asdict(j_cfg) == dataclasses.asdict(t_cfg)
    j_model = JModel(j_cfg)
    j_params = j_model.init(jax.random.PRNGKey(0))
    t_model = TModel(t_cfg, device="cpu")
    t_params = t_model.init(0)
    sd = convert.model_params_from_jax(jax.tree_util.tree_map(np.asarray, j_params), t_cfg)
    assert set(sd) == set(t_params.state_dict())
    t_params.load_state_dict(sd)
    return j_cfg, j_model, j_params, t_model, t_params


def _hold_cache(t_cache: dict, j_cache: dict) -> None:
    assert t_cache["length"] == int(j_cache["length"])
    _close(t_cache["mamba"]["h"], j_cache["mamba"]["h"])
    _close(t_cache["mamba"]["conv"], j_cache["mamba"]["conv"])
    _close(t_cache["attn_k"], j_cache["attn_k"])
    _close(t_cache["attn_v"], j_cache["attn_v"])


@pytest.mark.parametrize("max_len", [40, 12], ids=["ring-wider", "ring-narrower"])
def test_prefill_and_decode_match_jax(zamba, max_len):
    """A 21-token prompt (not a multiple of the 16-step chunk); a ring of 12
    slots keeps only the last 12 positions."""
    j_cfg, j_model, j_params, t_model, t_params = zamba
    rng = np.random.default_rng(max_len)
    toks = rng.integers(1, j_cfg.vocab_size, size=(2, 21))
    j_logits, j_cache = j_model.prefill(
        j_params, {"tokens": jnp.asarray(toks, jnp.int32)}, j_model.init_cache(2, max_len))
    t_logits, t_cache = t_model.prefill(
        t_params, {"tokens": torch.from_numpy(toks)}, t_model.init_cache(2, max_len))
    _close(t_logits, j_logits)
    _hold_cache(t_cache, j_cache)
    for _ in range(3):
        nxt = rng.integers(1, j_cfg.vocab_size, size=(2, 1))
        j_logits, j_cache = j_model.decode_step(j_params, jnp.asarray(nxt, jnp.int32), j_cache)
        t_logits, t_cache = t_model.decode_step(t_params, torch.from_numpy(nxt), t_cache)
        _close(t_logits, j_logits)
        _hold_cache(t_cache, j_cache)


def test_bf16_prefill_and_decode_within_bf16_tolerance():
    j_cfg = reduce_config(ARCHITECTURES["zamba2-1.2b"])
    t_cfg = t_reduce_config(T_ARCHITECTURES["zamba2-1.2b"])
    assert t_cfg.dtype == "bfloat16"
    j_model, t_model = JModel(j_cfg), TModel(t_cfg, device="cpu")
    j_params = j_model.init(jax.random.PRNGKey(1))
    t_params = t_model.init(0)
    t_params.load_state_dict(
        convert.model_params_from_jax(jax.tree_util.tree_map(np.asarray, j_params), t_cfg))
    assert t_params.shared_attn.wq.w.dtype == torch.bfloat16
    rng = np.random.default_rng(4)
    toks = rng.integers(1, j_cfg.vocab_size, size=(2, 21))
    j_logits, j_cache = j_model.prefill(
        j_params, {"tokens": jnp.asarray(toks, jnp.int32)}, j_model.init_cache(2, 32))
    t_logits, t_cache = t_model.prefill(
        t_params, {"tokens": torch.from_numpy(toks)}, t_model.init_cache(2, 32))
    for step in range(3):
        want = _np(j_logits)
        assert t_logits.dtype == torch.bfloat16
        err = np.abs(t_logits.float().numpy() - want).max()
        assert err <= 0.05 * np.abs(want).max(), (step, err)
        nxt = rng.integers(1, j_cfg.vocab_size, size=(2, 1))
        j_logits, j_cache = j_model.decode_step(j_params, jnp.asarray(nxt, jnp.int32), j_cache)
        t_logits, t_cache = t_model.decode_step(t_params, torch.from_numpy(nxt), t_cache)


@pytest.mark.parametrize("ring", [True, False])
def test_attention_forward_chunked(zamba, ring):
    """``use_chunked=True``: the flash path (plain version on the CPU), with
    a ring of 8 slots under a 20-token prompt, or without a cache."""
    j_cfg, _, j_params, t_model, t_params = zamba
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 20, j_cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(20)[None], (2, 20))
    hd = j_cfg.resolved_head_dim
    kw = dict(window=8, use_chunked=True)
    if ring:
        shape = (2, 8, j_cfg.n_kv_heads, hd)
        j_kv = j_attn.KVCache(jnp.zeros(shape), jnp.zeros(shape), jnp.int32(0))
        t_kv = t_attn.KVCache(torch.zeros(shape), torch.zeros(shape), 0)
        kw["ring"] = True
    else:
        j_kv = t_kv = None
    j_out, j_new = j_attn.attention_forward(
        j_cfg, j_params["shared_attn"], jnp.asarray(x), positions=jnp.asarray(pos),
        cache=j_kv, **kw)
    t_out, t_new = t_attn.attention_forward(
        j_cfg, t_params.shared_attn, torch.from_numpy(x), positions=torch.from_numpy(pos),
        cache=t_kv, **kw)
    _close(t_out, j_out)
    if ring:
        assert t_new.length == 20
        _close(t_new.k, j_new.k)
        _close(t_new.v, j_new.v)


def test_engine_greedy_tokens_equal_jax_over_two_waves(zamba):
    j_cfg, j_model, j_params, t_model, t_params = zamba
    scfg = dict(max_batch=2, max_prompt_len=16, max_len=21)
    j_eng = JServingEngine(j_model, j_params, JServingConfig(**scfg))
    t_eng = TServingEngine(t_model, t_params, TServingConfig(**scfg))
    rng = np.random.default_rng(9)
    for plen, new in ((5, 4), (11, 3), (16, 4), (7, 2)):
        prompt = rng.integers(1, j_cfg.vocab_size, size=plen)
        j_eng.submit(prompt, max_new_tokens=new)
        t_eng.submit(prompt, max_new_tokens=new)
    want = j_eng.run_to_completion()
    got = t_eng.run_to_completion()
    assert got == want
    assert [len(v) for v in got.values()] == [4, 3, 4, 2]


def test_engine_samples_with_temperature(zamba):
    """Sampled tokens follow the logits (no parity of draws: the generators
    differ), are reproducible from the seed, and stay in the vocabulary."""
    _, _, _, t_model, t_params = zamba
    runs = []
    for _ in range(2):
        eng = TServingEngine(t_model, t_params, TServingConfig(max_batch=2, max_prompt_len=8,
                                                                max_len=16), rng_seed=4)
        for i in range(2):
            eng.submit(np.arange(1, 6) + i, max_new_tokens=6, temperature=1.5)
        runs.append(eng.run_to_completion())
    assert runs[0] == runs[1]
    assert all(0 <= t < 256 for toks in runs[0].values() for t in toks)
    eng = TServingEngine(t_model, t_params, TServingConfig(max_batch=1, max_prompt_len=8,
                                                            max_len=16), rng_seed=4)
    logits = torch.tensor([[0.0, 3.0, -1.0, 0.5]])
    draws = [eng._sample(logits, np.array([0.7]))[0] for _ in range(2000)]
    freq = np.bincount(draws, minlength=4) / len(draws)
    want = torch.softmax(logits[0] / 0.7, dim=0).numpy()
    np.testing.assert_allclose(freq, want, atol=0.03)


# ----------------------------------------------------------------------
# Placement report and program profiler: host numpy f64, ==
# ----------------------------------------------------------------------

PLACEMENT_ARCHS = ["zamba2-1.2b", "qwen2-7b", "deepseek-v2-236b"]


def _plan_key(plan):
    return (
        tuple(plan.stage_tier.tolist()), plan.mcop_cost, plan.contiguous_boundary,
        plan.contiguous_cost, plan.contiguity_penalty, plan.cut_bytes,
        plan.result.min_cut, tuple(plan.result.local_mask.tolist()),
    )


def _tiers(pl):
    return (dataclasses.replace(pl.TPUV5E_TIER, name="decode-pool", chips=64),
            dataclasses.replace(pl.TPUV5E_TIER, name="prefill-pool", chips=192))


@pytest.mark.parametrize("arch", PLACEMENT_ARCHS)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_stage_specs_equal(arch, shape):
    j = j_prog.stage_specs(ARCHITECTURES[arch], SHAPES[shape], group=4)
    t = t_prog.stage_specs(T_ARCHITECTURES[arch], T_SHAPES[shape], group=4)
    assert [dataclasses.astuple(s) for s in t] == [dataclasses.astuple(s) for s in j]


@pytest.mark.parametrize("arch", PLACEMENT_ARCHS)
def test_plan_placement_equal(arch):
    shape_j = SHAPES["decode_32k"]
    shape_t = T_SHAPES["decode_32k"]
    cfg_j, cfg_t = ARCHITECTURES[arch], T_ARCHITECTURES[arch]
    g = max(cfg_j.n_layers // 8, 1)
    j = j_pl.plan_placement(j_prog.stage_specs(cfg_j, shape_j, group=g), *_tiers(j_pl))
    t = t_pl.plan_placement(t_prog.stage_specs(cfg_t, shape_t, group=g), *_tiers(t_pl))
    assert _plan_key(t) == _plan_key(j)
    jx = j_pl.plan_placement(j_prog.stage_specs(cfg_j, shape_j, group=g), *_tiers(j_pl),
                             exact=True)
    tx = t_pl.plan_placement(t_prog.stage_specs(cfg_t, shape_t, group=g), *_tiers(t_pl),
                             exact=True)
    assert _plan_key(tx) == _plan_key(jx)
    # the f32 device backends (plain versions on the CPU): the same placement
    for backend in ("torch", "cuda"):
        td = t_pl.plan_placement(t_prog.stage_specs(cfg_t, shape_t, group=g),
                                 *_tiers(t_pl), backend=backend, device="cpu")
        assert np.array_equal(td.stage_tier, j.stage_tier)
        assert td.mcop_cost == pytest.approx(j.mcop_cost, rel=1e-5)


def test_plan_placement_batch_equal():
    bws = [1e9, 0.0, 5e10, 2e8, 1e12]
    stages_j = j_prog.stage_specs(ARCHITECTURES["zamba2-1.2b"], SHAPES["prefill_32k"], group=2)
    stages_t = t_prog.stage_specs(T_ARCHITECTURES["zamba2-1.2b"], T_SHAPES["prefill_32k"],
                                  group=2)
    j = j_pl.plan_placement_batch(stages_j, *_tiers(j_pl), inter_tier_bws=bws,
                                  backend="reference")
    t = t_pl.plan_placement_batch(stages_t, *_tiers(t_pl), inter_tier_bws=bws,
                                  backend="reference", device="cpu")
    assert [_plan_key(p) for p in t] == [_plan_key(p) for p in j]
    # the f32 device backends: the same placements, costs to float32 rounding
    jd = j_pl.plan_placement_batch(stages_j, *_tiers(j_pl), inter_tier_bws=bws, backend="jax")
    for backend in ("torch", "cuda"):
        td = t_pl.plan_placement_batch(stages_t, *_tiers(t_pl), inter_tier_bws=bws,
                                       backend=backend, device="cpu")
        for a, b in zip(td, jd):
            assert np.array_equal(a.stage_tier, b.stage_tier)
            assert a.contiguous_boundary == b.contiguous_boundary
            assert a.mcop_cost == pytest.approx(b.mcop_cost, rel=1e-5)


def test_serve_main_prints_the_reference_placement_line():
    from repro.launch import serve as j_serve
    from repro_torch.launch import serve as t_serve

    args = ["--arch", "zamba2-1.2b", "--reduced", "--requests", "2",
            "--max-new-tokens", "2", "--prompt-len", "8", "--max-batch", "2"]
    outs = []
    for main, extra in ((j_serve.main, []), (t_serve.main, ["--device", "cpu"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(args + extra) == 0
        outs.append(buf.getvalue().splitlines())
    assert outs[1][0] == outs[0][0]
    assert outs[0][0].startswith("[serve] MCOP placement: cut=")
    assert outs[1][1].startswith("[serve] 2 requests, 4 tokens")


def test_full_width_parameter_count_equals_jax():
    """zamba2-1.2b at full width, built on the meta device (shapes only)."""
    cfg_j = ARCHITECTURES["zamba2-1.2b"]
    shapes = jax.eval_shape(JModel(cfg_j).init, jax.random.PRNGKey(0))
    want = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(shapes))
    params = TModel(T_ARCHITECTURES["zamba2-1.2b"], device="meta").init(0)
    got = sum(p.numel() for p in params.parameters())
    assert got == want
    mamba = params.mamba[0][0]
    assert (mamba.in_proj.w.shape, mamba.conv_w.shape) == ((2048, 8384), (4, 4224))
    assert params.shared_attn.wq.w.dtype == torch.bfloat16
    assert len(params.mamba) * len(params.mamba[0]) == 38
