"""The mixture-of-experts families as whole models against the JAX package
on the CPU: llama4-scout (GQA, 16 experts top-1 and a shared expert) and
deepseek-v2 (MLA, a dense first layer, experts top-2 of 8 at reduced width
and two shared): prefill logits and caches and three decode steps in
float32 at 1e-4, MLA's empty-cache chunked route, bf16 logits, and greedy
engine tokens ``==``."""

import numpy as np
import pytest
import torch

from _torch_parity import hold_cache, model_pair
from repro_torch.models import ffn as t_ffn
from repro_torch.models import transformer as t_transformer
from test_torch_families import B, _close, run_pair

TOL = 1e-4


@pytest.fixture(scope="module")
def deepseek():
    return model_pair("deepseek-v2-236b")


@pytest.fixture(scope="module")
def llama4():
    return model_pair("llama4-scout-17b-a16e")


@pytest.mark.parametrize("which", ["deepseek", "llama4"])
def test_moe_models_prefill_and_decode_match_jax(which, deepseek, llama4):
    pair = deepseek if which == "deepseek" else llama4
    for (t_logits, t_cache), (j_logits, j_cache) in run_pair(pair, 14):
        _close(t_logits, j_logits)
        hold_cache(t_cache, j_cache, TOL)


def test_deepseek_empty_cache_prefill_route_matches_jax(deepseek, monkeypatch):
    """With the long-prompt threshold lowered, the 12-token prefill runs
    MLA's decompressed form through the chunked core in both ``dense0`` and
    the MoE block; the JAX package runs its absorbed form."""
    monkeypatch.setattr(t_transformer, "CHUNKED_ABOVE", 4)
    for (t_logits, t_cache), (j_logits, j_cache) in run_pair(deepseek, 15):
        _close(t_logits, j_logits)
        hold_cache(t_cache, j_cache, TOL)


def test_deepseek_bf16_within_bf16_tolerance(monkeypatch):
    """bf16 logits to 5 % of their largest magnitude at every step whose
    expert choices equal the float32 run's on the same (bf16) parameters.
    Routing is discontinuous: where the k-th and (k+1)-th router
    probabilities of a token lie within bf16's resolution (2^-8) of each
    other, bf16 rounding upstream may pick either expert and move that
    token's logits by O(1).  A step that routes otherwise than float32 must
    show such a tie, and at least three of the four steps are compared."""
    import copy
    import dataclasses

    from repro_torch.models.transformer import Model as TModel

    picks = []
    top_k = t_ffn._top_k

    def spy(probs, k):
        vals, idx = torch.sort(probs.float(), dim=-1, descending=True, stable=True)
        picks.append((idx[..., :k].sort(-1).values, float((vals[..., k - 1] - vals[..., k]).min())))
        return top_k(probs, k)

    monkeypatch.setattr(t_ffn, "_top_k", spy)
    cfg, _, _, _, t_params = pair = model_pair("deepseek-v2-236b", dtype="bfloat16", seed=1)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    pair32 = (cfg32, None, None, TModel(cfg32, device="cpu"), copy.deepcopy(t_params).float())
    runs = []
    for p, with_jax in ((pair, True), (pair32, False)):
        steps = []
        for (t_logits, _), j_out in run_pair(p, 16, with_jax=with_jax):
            steps.append((t_logits, j_out and np.asarray(j_out[0], np.float32), list(picks)))
            picks.clear()
        runs.append(steps)
    compared = 0
    for (t_logits, want, routes), (_, _, routes32) in zip(*runs):
        assert t_logits.dtype == torch.bfloat16
        if all(torch.equal(a[0], b[0]) for a, b in zip(routes, routes32)):
            err = np.abs(t_logits.float().numpy() - want).max()
            assert err <= 0.05 * np.abs(want).max(), err
            compared += 1
        else:
            assert min(margin for _, margin in routes) < 2.0**-8
    assert compared >= 3


def test_deepseek_engine_greedy_tokens_equal_jax(deepseek):
    from repro.serving import ServingConfig as JServingConfig
    from repro.serving import ServingEngine as JServingEngine
    from repro_torch.serving import ServingConfig as TServingConfig
    from repro_torch.serving import ServingEngine as TServingEngine

    cfg, j_model, j_params, t_model, t_params = deepseek
    scfg = dict(max_batch=B, max_prompt_len=14, max_len=19)
    j_eng = JServingEngine(j_model, j_params, JServingConfig(**scfg))
    t_eng = TServingEngine(t_model, t_params, TServingConfig(**scfg))
    rng = np.random.default_rng(17)
    for plen, new in ((9, 4), (14, 3), (5, 4)):
        prompt = rng.integers(1, cfg.vocab_size, size=plen)
        j_eng.submit(prompt, max_new_tokens=new)
        t_eng.submit(prompt, max_new_tokens=new)
    assert t_eng.run_to_completion() == j_eng.run_to_completion()
