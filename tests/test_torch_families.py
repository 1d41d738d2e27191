"""The port's model stack against the JAX package on the CPU, family by
family: dense (qwen2-7b with qkv bias, qwen3-32b with qk_norm, granite and
phi3), VLM (qwen2-vl: M-RoPE with three distinct position streams, patch
embeddings), encoder-decoder (seamless: frame embeddings, cross-attention
k/v projected once) and SSM (xlstm: mLSTM and sLSTM blocks).  The MoE
families and MLA are in ``test_torch_mla_moe.py``.

Reduced configs with the JAX parameters carried over through
``convert.model_params_from_jax``.  In float32: prefill logits and every
cache tensor, then three decode steps, at 1e-4 (float32 sums in another
order through a few layers); greedy engine tokens ``==``.  In bfloat16 the
two frameworks round at other places, so bf16 logits are held to 5 % of
their largest magnitude, as ``test_torch_serve.py`` states."""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import hold_cache, model_pair
from repro.configs import ARCHITECTURES
from repro.models.transformer import Model as JModel
from repro.serving import ServingConfig as JServingConfig
from repro.serving import ServingEngine as JServingEngine
from repro_torch.configs import ARCHITECTURES as T_ARCHITECTURES
from repro_torch.models import transformer as t_transformer
from repro_torch.models.transformer import Model as TModel
from repro_torch.serving import ServingConfig as TServingConfig
from repro_torch.serving import ServingEngine as TServingEngine

TOL = 1e-4
ARCHS = ["qwen2-7b", "qwen3-32b", "granite-34b", "phi3-medium-14b", "qwen2-vl-72b",
         "seamless-m4t-large-v2", "xlstm-1.3b"]
B, S = 2, 12


@pytest.fixture(scope="module")
def pairs():
    """Model pairs built on first use, kept for the module."""
    built = {}

    def get(arch):
        if arch not in built:
            built[arch] = model_pair(arch)
        return built[arch]

    return get


def batch_pair(cfg, rng, b=B, s=S):
    """The same prompt batch for both packages: tokens, the frontend's
    embeddings, and for M-RoPE three distinct position streams."""
    toks = rng.integers(1, cfg.vocab_size, size=(b, s))
    arrays = {"tokens": toks}
    if cfg.frontend == "vision_patches":
        arrays["patch_embeds"] = rng.normal(size=(b, cfg.frontend_seq, cfg.d_model))
    if cfg.frontend == "audio_frames":
        arrays["frame_embeds"] = rng.normal(size=(b, 10, cfg.d_model))
    if cfg.rope_variant == "mrope":
        t = np.arange(s)
        arrays["positions"] = np.broadcast_to(
            np.stack([t, t // 3, (t * 7) % 5], axis=-1)[None], (b, s, 3)).copy()
    # embeddings in the model's dtype (the JAX decoder's carry must keep it)
    j = {k: jnp.asarray(v, jnp.int32) if v.dtype.kind == "i"
         else jnp.asarray(v, jnp.float32).astype(cfg.dtype) for k, v in arrays.items()}
    t = {k: torch.from_numpy(np.asarray(v, np.int64 if v.dtype.kind == "i" else np.float32))
         for k, v in j.items()}
    t = {k: v if k in ("tokens", "positions") else v.to(getattr(torch, cfg.dtype))
         for k, v in t.items()}
    return j, t


def decode_extras(cfg, rng, step):
    """Decode-step extras: distinct M-RoPE positions for the VLM."""
    if cfg.rope_variant != "mrope":
        return None, None
    pos = np.array([[[S + step, 2 + step, (5 * step) % 3]]] * B)
    return {"positions": jnp.asarray(pos, jnp.int32)}, {"positions": torch.from_numpy(pos)}


def run_pair(pair, seed, *, max_len=20, with_jax=True):
    """Prefill and three decode steps through both packages (the port alone
    without ``with_jax``); yields ((port logits, port cache), (JAX logits,
    JAX cache) or None) after each."""
    cfg, j_model, j_params, t_model, t_params = pair
    rng = np.random.default_rng(seed)
    j_batch, t_batch = batch_pair(cfg, rng)
    j_out = None
    if with_jax:
        j_out = j_model.prefill(j_params, j_batch, j_model.init_cache(B, max_len))
    t_out = t_model.prefill(t_params, t_batch, t_model.init_cache(B, max_len))
    yield t_out, j_out
    for step in range(3):
        nxt = rng.integers(1, cfg.vocab_size, size=(B, 1))
        j_ex, t_ex = decode_extras(cfg, rng, step)
        if with_jax:
            j_out = j_model.decode_step(j_params, jnp.asarray(nxt, jnp.int32), j_out[1], j_ex)
        t_out = t_model.decode_step(t_params, torch.from_numpy(nxt), t_out[1], t_ex)
        yield t_out, j_out


def _close(got: torch.Tensor, want, tol: float = TOL) -> None:
    want = want.detach() if isinstance(want, torch.Tensor) else want
    np.testing.assert_allclose(got.detach().to(torch.float32).numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(pairs, arch):
    for (t_logits, t_cache), (j_logits, j_cache) in run_pair(pairs(arch), 10):
        _close(t_logits, j_logits)
        hold_cache(t_cache, j_cache, TOL)


@pytest.mark.parametrize("arch", ["qwen2-7b", "qwen2-vl-72b"])
def test_empty_cache_prefill_route_matches_the_reference_cache_route(pairs, arch, monkeypatch):
    """With the long-prompt threshold lowered, a 12-token prefill takes the
    empty-cache route (the fresh k/v through the chunked core) where the
    JAX package attends the whole cache naively: the same logits and cache,
    and decoding after it the same."""
    monkeypatch.setattr(t_transformer, "CHUNKED_ABOVE", 4)
    for (t_logits, t_cache), (j_logits, j_cache) in run_pair(pairs(arch), 11):
        _close(t_logits, j_logits)
        hold_cache(t_cache, j_cache, TOL)


def test_vlm_patches_and_positions_reach_the_logits(pairs):
    """The patch splice and the second and third M-RoPE streams each change
    the prefill logits (so the parity above tests them)."""
    cfg, _, _, t_model, t_params = pairs("qwen2-vl-72b")
    _, batch = batch_pair(cfg, np.random.default_rng(12))
    base = t_model.prefill(t_params, batch, t_model.init_cache(B, 20))[0]
    no_patch = {k: v for k, v in batch.items() if k != "patch_embeds"}
    text_pos = {**batch, "positions": batch["positions"][..., :1].expand(B, S, 3)}
    for other in (no_patch, text_pos):
        logits = t_model.prefill(t_params, other, t_model.init_cache(B, 20))[0]
        assert float((logits - base).abs().max()) > 1e-3


def test_vlm_patches_longer_than_the_prompt_raise(pairs):
    cfg, _, _, t_model, t_params = pairs("qwen2-vl-72b")
    batch = {"tokens": torch.ones((B, cfg.frontend_seq - 1), dtype=torch.long),
             "patch_embeds": torch.zeros((B, cfg.frontend_seq, cfg.d_model))}
    with pytest.raises(ValueError, match="patch embeddings"):
        t_model.prefill(t_params, batch, t_model.init_cache(B, 20))


@pytest.mark.parametrize("arch", ["qwen2-7b", "qwen2-vl-72b", "seamless-m4t-large-v2"])
def test_bf16_prefill_and_decode_within_bf16_tolerance(arch):
    pair = model_pair(arch, dtype="bfloat16", seed=1)
    assert pair[4].lm_head.w.dtype == torch.bfloat16
    for (t_logits, _), (j_logits, _) in run_pair(pair, 13):
        assert t_logits.dtype == torch.bfloat16
        want = np.asarray(j_logits, np.float32)
        err = np.abs(t_logits.float().numpy() - want).max()
        assert err <= 0.05 * np.abs(want).max(), err


def test_bf16_xlstm_within_the_references_own_bf16_error():
    """xLSTM's exponential gates amplify bf16 rounding through the eight
    recurrent layers: at these widths the JAX package's own bf16 logits lie
    up to ~27 % of their largest magnitude from its float32 logits on the
    same (bf16) parameters, so 5 % says nothing here (each block alone
    agrees to 5 %: ``test_torch_layers``).  The two frameworks round silu
    and gelu differently in ~40 % of bf16 values, so their bf16 runs drift
    apart along the chain.  Held at every step: the port's bf16 logits lie
    no farther than twice the reference's own bf16 error from the float32
    logits, and within 35 % of the largest float32 logit from the port's
    own float32 model on the same parameters (measured on the CPU over
    parameter seeds 1-3 and batch seeds 13-14, four steps each: at most
    29.6 %, here at seed 1, batch 13).  Both bounds are loose by the
    chain's nature: this case checks that bf16 runs through the whole model
    and stays near float32; the arithmetic rests on the float32 test at
    1e-4 and the per-block bf16 tests."""
    import copy
    import dataclasses

    cfg, j_model, j_params, t_model, t_params = pair = model_pair(
        "xlstm-1.3b", dtype="bfloat16", seed=1)
    # both packages in float32 on the same parameters
    pair32 = (cfg, JModel(dataclasses.replace(j_model.cfg, dtype="float32")),
              jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), j_params),
              TModel(dataclasses.replace(t_model.cfg, dtype="float32"), device="cpu"),
              copy.deepcopy(t_params).float())
    for ((t_logits, _), (j_logits, _)), ((t32, _), (j32, _)) in zip(run_pair(pair, 13),
                                                                   run_pair(pair32, 13)):
        assert t_logits.dtype == torch.bfloat16
        truth = np.asarray(j32, np.float32)
        _close(t32, truth)
        got = t_logits.float().numpy()
        reference_err = np.abs(np.asarray(j_logits, np.float32) - truth).max()
        assert np.abs(got - truth).max() <= 2 * reference_err
        own_err = np.abs(got - t32.numpy()).max()
        assert own_err <= 0.35 * np.abs(truth).max(), own_err


def _engine_extras(cfg, max_batch):
    rng = np.random.default_rng(7)
    key = {"vision_patches": "patch_embeds", "audio_frames": "frame_embeds"}.get(cfg.frontend)
    if key is None:
        return {}, {}
    arr = rng.normal(size=(max_batch, cfg.frontend_seq, cfg.d_model)).astype(np.float32)
    return {key: jnp.asarray(arr)}, {key: torch.from_numpy(arr)}


@pytest.mark.parametrize("arch", ["qwen2-7b", "qwen2-vl-72b", "seamless-m4t-large-v2",
                                  "xlstm-1.3b"])
def test_engine_greedy_tokens_equal_jax(pairs, arch):
    """Two waves of two requests, the frontends' embeddings as engine extras."""
    cfg, j_model, j_params, t_model, t_params = pairs(arch)
    scfg = dict(max_batch=2, max_prompt_len=14, max_len=19)
    j_ex, t_ex = _engine_extras(cfg, 2)
    j_eng = JServingEngine(j_model, j_params, JServingConfig(**scfg), extras=j_ex)
    t_eng = TServingEngine(t_model, t_params, TServingConfig(**scfg), extras=t_ex)
    rng = np.random.default_rng(9)
    for plen, new in ((9, 4), (14, 3), (12, 4), (8, 2)):
        prompt = rng.integers(1, cfg.vocab_size, size=plen)
        j_eng.submit(prompt, max_new_tokens=new)
        t_eng.submit(prompt, max_new_tokens=new)
    want = j_eng.run_to_completion()
    got = t_eng.run_to_completion()
    assert got == want
    assert [len(v) for v in got.values()] == [4, 3, 4, 2]


@pytest.mark.parametrize("arch", sorted(ARCHITECTURES))
def test_full_width_parameter_count_equals_jax(arch):
    """Every architecture at its published widths, built on the meta device
    (shapes only), against ``jax.eval_shape`` of the JAX package's init:
    at full depth, but deepseek-v2 at 3 of its 60 layers (its 59 MoE
    layers of 160 experts take a minute to trace), still one dense and two
    MoE layers at full width."""
    import dataclasses

    cfg_j, cfg_t = ARCHITECTURES[arch], T_ARCHITECTURES[arch]
    if arch == "deepseek-v2-236b":
        cfg_j = dataclasses.replace(cfg_j, n_layers=3)
        cfg_t = dataclasses.replace(cfg_t, n_layers=3)
    shapes = jax.eval_shape(JModel(cfg_j).init, jax.random.PRNGKey(0))
    want = sorted(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(shapes))
    params = TModel(cfg_t, device="meta").init(0)
    assert sum(p.numel() for p in params.parameters()) == sum(want)
    assert all(p.device.type == "meta" for p in params.parameters())


@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "seamless-m4t-large-v2", "xlstm-1.3b"])
def test_serve_main_serves_every_family(arch):
    from repro_torch.launch import serve as t_serve

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert t_serve.main(["--arch", arch, "--reduced", "--requests", "2",
                             "--max-new-tokens", "2", "--prompt-len", "12",
                             "--max-batch", "2", "--device", "cpu"]) == 0
    lines = buf.getvalue().splitlines()
    assert lines[0].startswith("[serve] MCOP placement: cut=")
    assert lines[1].startswith("[serve] 2 requests, 4 tokens")


def test_serve_main_refuses_a_prompt_shorter_than_the_patches(capsys):
    """The VLM splices ``frontend_seq`` (8 reduced) patch embeddings into
    every prompt; a ``--prompt-len`` not above that is refused, not raised."""
    from repro_torch.launch import serve as t_serve

    with pytest.raises(SystemExit) as err:
        t_serve.main(["--arch", "qwen2-vl-72b", "--reduced", "--prompt-len", "8",
                      "--device", "cpu"])
    assert err.value.code == 2
    assert "--prompt-len 8: qwen2-vl-72b splices 8 patch embeddings" in capsys.readouterr().err
