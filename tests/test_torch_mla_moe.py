"""MLA (DeepSeek-V2 latent attention) and the mixture-of-experts layer of
the port against the JAX package's on the CPU: MLA with no cache, on the
empty-cache chunked route and in its absorbed decode; the reference's
chunked MLA fault (ROADMAP Queue C); the MoE output, aux loss, routing and
capacity drops.

Inputs made with numpy from a seed; parameters carried over through
``convert``.  Tolerance 1e-4 in float32 (sums in another order), 2e-6 for
the cache latents.  Where the JAX package's own chunked MLA raises, the
port is held to the JAX package's naive form."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import model_pair
from repro.models import attention as j_attn
from repro.models import common as j_common
from repro.models import ffn as j_ffn
from repro_torch import convert
from repro_torch.models import attention as t_attn
from repro_torch.models import common as t_common
from repro_torch.models import ffn as t_ffn
from test_torch_families import _close

TOL = 1e-4


def _pair(rng, shape):
    a = rng.normal(size=shape).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _module(tree, factory):
    """The port's module from ``factory()`` holding the JAX ``tree``."""
    mod = factory()
    sd = convert.tree_to_state_dict(jax.tree_util.tree_map(np.asarray, tree))
    assert set(sd) == set(mod.state_dict())
    mod.load_state_dict(sd)
    return mod


@pytest.fixture(scope="module")
def deepseek():
    return model_pair("deepseek-v2-236b")


@pytest.fixture(scope="module")
def llama4():
    return model_pair("llama4-scout-17b-a16e")


# ----------------------------------------------------------------------
# MLA
# ----------------------------------------------------------------------


def _mla_inputs(cfg, seed, s):
    rng = np.random.default_rng(seed)
    xj, xt = _pair(rng, (2, s, cfg.d_model))
    pos = np.broadcast_to(np.arange(s)[None], (2, s))
    return xj, xt, jnp.asarray(pos), torch.from_numpy(pos)


def _mla_params(pair):
    cfg, _, j_params, _, t_params = pair
    return cfg, jax.tree_util.tree_map(lambda a: a[0], j_params["blocks"])["attn"], \
        t_params.blocks[0].attn


def _mla_caches(cfg, max_len):
    m = cfg.mla
    shapes = ((2, max_len, m.kv_lora_rank), (2, max_len, m.qk_rope_head_dim))
    j = j_attn.MLACache(*(jnp.zeros(sh) for sh in shapes), jnp.int32(0))
    t = t_attn.MLACache(*(torch.zeros(sh) for sh in shapes), 0)
    return j, t


def test_mla_without_cache_matches_jax(deepseek):
    cfg, jp, tp = _mla_params(deepseek)
    xj, xt, pj, pt = _mla_inputs(cfg, 4, 13)
    j_out, _ = j_attn.mla_forward(cfg, jp, xj, positions=pj)
    for chunked in (False, True):
        t_out, none = t_attn.mla_forward(cfg, tp, xt, positions=pt, use_chunked=chunked)
        assert none is None
        _close(t_out, j_out)


def test_mla_empty_cache_chunked_route_and_absorbed_decode_match_jax(deepseek):
    """A 13-token prefill into an empty cache: the port takes the
    decompressed form through the chunked core, the JAX package the
    absorbed form over the cache.  Outputs and latents agree, and three
    absorbed decode steps after them."""
    cfg, jp, tp = _mla_params(deepseek)
    xj, xt, pj, pt = _mla_inputs(cfg, 5, 13)
    j_cache, t_cache = _mla_caches(cfg, 20)
    j_out, j_cache = j_attn.mla_forward(cfg, jp, xj, positions=pj, cache=j_cache)
    t_out, t_cache = t_attn.mla_forward(cfg, tp, xt, positions=pt, cache=t_cache,
                                        use_chunked=True)
    _close(t_out, j_out)
    rng = np.random.default_rng(6)
    for step in range(4):
        assert t_cache.length == int(j_cache.length)
        _close(t_cache.c_kv, j_cache.c_kv, 2e-6)
        _close(t_cache.k_rope, j_cache.k_rope, 2e-6)
        if step == 3:
            break
        xj1, xt1 = _pair(rng, (2, 1, cfg.d_model))
        pos = np.full((2, 1), 13 + step)
        j_out, j_cache = j_attn.mla_forward(cfg, jp, xj1, positions=jnp.asarray(pos),
                                            cache=j_cache)
        t_out, t_cache = t_attn.mla_forward(cfg, tp, xt1, positions=torch.from_numpy(pos),
                                            cache=t_cache)
        _close(t_out, j_out)


def test_reference_chunked_mla_raises_and_the_ports_matches_naive(deepseek):
    """ROADMAP Queue C, in the reference: ``repro``'s chunked attention
    reshapes v with q's head width (``src/repro/models/attention.py:209-211``),
    so its MLA with ``use_chunked=True`` raises on MLA's narrower value heads
    (reduced deepseek-v2: qk 24, v 16).  The port's chunked MLA equals the
    JAX package's naive MLA."""
    cfg, jp, tp = _mla_params(deepseek)
    xj, xt, pj, pt = _mla_inputs(cfg, 7, 40)
    with pytest.raises(TypeError, match="reshape"):
        j_attn.mla_forward(cfg, jp, xj, positions=pj, use_chunked=True)
    want, _ = j_attn.mla_forward(cfg, jp, xj, positions=pj, use_chunked=False)
    got, _ = t_attn.mla_forward(cfg, tp, xt, positions=pt, use_chunked=True)
    _close(got, want)


# ----------------------------------------------------------------------
# Mixture of experts
# ----------------------------------------------------------------------


def _moe(cfg, j_params):
    jp = jax.tree_util.tree_map(lambda a: a[0], j_params["blocks"])["moe"]
    tp = _module(jp, lambda: t_ffn.init_moe(None, cfg, device="meta").to_empty(device="cpu"))
    return jp, tp


@pytest.mark.parametrize("capacity_factor", [1.25, 0.3], ids=["no-drops", "drops"])
@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "llama4-scout-17b-a16e"])
def test_moe_forward_and_aux_match_jax(arch, capacity_factor, deepseek, llama4):
    """Output and Switch aux loss; at capacity factor 0.3 the stable sort
    drops (token, choice) pairs, the same pairs in both packages (a pair
    dropped on one side only would move its token's output by O(1))."""
    import dataclasses

    cfg, _, j_params, _, _ = deepseek if arch.startswith("deepseek") else llama4
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=capacity_factor))
    jp, tp = _moe(cfg, j_params)
    rng = np.random.default_rng(10)
    xj, xt = _pair(rng, (3, 40, cfg.d_model))
    j_out, j_aux = j_ffn.moe_forward(cfg, jp, xj)
    t_out, t_aux = t_ffn.moe_forward(cfg, tp, xt)
    _close(t_out, j_out)
    np.testing.assert_allclose(float(t_aux), float(j_aux), rtol=1e-5)
    # the drops happen, and change the output
    t = 120 * cfg.moe.top_k
    cap = t_ffn._capacity(cfg.moe, 120)
    ids = t_ffn._top_k(torch.softmax(t_common.linear(tp.router, xt.reshape(120, -1)), -1),
                       cfg.moe.top_k)[1]
    dropped = int(sum(max(0, int(n) - cap) for n in torch.bincount(ids.reshape(-1))))
    assert (dropped > 0) == (capacity_factor < 1) and dropped < t


def test_top_k_takes_the_lower_index_first_on_ties():
    probs = np.array([[0.2, 0.3, 0.2, 0.3], [0.25, 0.25, 0.25, 0.25]], np.float32)
    vals, idx = t_ffn._top_k(torch.from_numpy(probs), 3)
    j_vals, j_idx = jax.lax.top_k(jnp.asarray(probs), 3)
    assert idx.tolist() == np.asarray(j_idx).tolist() == [[1, 3, 0], [0, 1, 2]]
    assert np.array_equal(vals.numpy(), np.asarray(j_vals))


def test_moe_gates_and_routing_equal_jax(deepseek):
    """Top-k experts equal and gates to f32 rounding where the router's
    probabilities are not tied."""
    cfg, _, j_params, _, _ = deepseek
    jp, tp = _moe(cfg, j_params)
    rng = np.random.default_rng(11)
    xj, xt = _pair(rng, (64, cfg.d_model))
    jprobs = jax.nn.softmax(j_common.linear(jp["router"], xj), axis=-1)
    j_vals, j_ids = jax.lax.top_k(jprobs, cfg.moe.top_k)
    t_vals, t_ids = t_ffn._top_k(torch.softmax(t_common.linear(tp.router, xt), -1),
                                 cfg.moe.top_k)
    assert t_ids.tolist() == np.asarray(j_ids).tolist()
    np.testing.assert_allclose(t_vals.detach().numpy(), np.asarray(j_vals), rtol=1e-6, atol=1e-7)
