"""The port's layers against the JAX package's on the CPU: M-RoPE, the GQA
layer's cross-attention and sequence-sharded decode layout (the port's
one-token decode path), the xLSTM
blocks, and the flash kernel's plain version and tensor-core arithmetic at
MLA's unequal head widths (q/k 192 or 24, v 128 or 16).

Inputs made with numpy from a seed; parameters carried over through
``convert``.  Tolerance 1e-4 in float32 through a layer, 2e-6 for a single
rotation or attention core on unit inputs, 2e-5 for the head-major plain
flash version; B4's bf16 arithmetic to one bf16 step of the output, as
``test_torch_flash_tc`` states."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import hold_cache, model_pair
from repro.models import attention as j_attn
from repro.models import common as j_common
from repro.models import ssm as j_ssm
from repro_torch.kernels import flash_attention as t_flash
from repro_torch.kernels.ref import flash_attention_plain
from repro_torch.models import attention as t_attn
from repro_torch.models import common as t_common
from repro_torch.models import ssm as t_ssm
from test_torch_families import _close, run_pair
from test_torch_flash_tc import _outside, emulate_tc

TOL = 1e-4


def _pair(rng, shape):
    a = rng.normal(size=shape).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def test_mrope_matches_jax_and_is_rope_on_equal_streams():
    rng = np.random.default_rng(0)
    xj, xt = _pair(rng, (2, 7, 3, 16))
    pos = np.stack([rng.integers(0, 50, (2, 7)) for _ in range(3)], axis=-1)
    sections = (2, 3, 3)
    got = t_common.apply_mrope(xt, torch.from_numpy(pos), 1e6, sections)
    want = j_common.apply_mrope(xj, jnp.asarray(pos), 1e6, sections)
    _close(got, want, 2e-6)
    same = np.repeat(pos[..., :1], 3, axis=-1)
    assert torch.equal(t_common.apply_mrope(xt, torch.from_numpy(same), 1e6, sections),
                       t_common.apply_rope(xt, torch.from_numpy(same[..., 0]), 1e6))
    with pytest.raises(ValueError):
        t_common.apply_mrope(xt, torch.from_numpy(pos), 1e6, (2, 2, 2))


def test_cross_attention_with_and_without_cache_matches_jax():
    """Without a cache the memory is projected in the layer; with one the
    cache holds the projected memory, and the layer's k/v projections of
    its input are skipped (the JAX package computes and ignores them)."""
    pair = model_pair("seamless-m4t-large-v2")
    cfg, _, j_params, _, t_params = pair
    jp = jax.tree_util.tree_map(lambda a: a[0], j_params["dec_blocks"])["cross_attn"]
    tp = t_params.dec_blocks[0].cross_attn
    rng = np.random.default_rng(1)
    hj, ht = _pair(rng, (2, 5, cfg.d_model))
    mj, mt = _pair(rng, (2, 9, cfg.d_model))
    pos = np.broadcast_to(np.arange(5)[None], (2, 5))
    j_out, _ = j_attn.attention_forward(cfg, jp, hj, positions=jnp.asarray(pos),
                                        kv_source=mj, mask_kind="full")
    t_out, none = t_attn.attention_forward(cfg, tp, ht, positions=torch.from_numpy(pos),
                                           kv_source=mt, mask_kind="full")
    assert none is None
    _close(t_out, j_out)
    hd = cfg.resolved_head_dim
    kj = (mj @ jp["wk"]["w"]).reshape(2, 9, cfg.n_kv_heads, hd)
    vj = (mj @ jp["wv"]["w"]).reshape(2, 9, cfg.n_kv_heads, hd)
    kt, vt = (torch.from_numpy(np.asarray(a)) for a in (kj, vj))
    j_out2, _ = j_attn.attention_forward(cfg, jp, hj, positions=jnp.asarray(pos),
                                         cache=j_attn.KVCache(kj, vj, jnp.int32(0)),
                                         kv_source=hj)
    cache = t_attn.KVCache(kt, vt, 0)
    t_out2, same = t_attn.attention_forward(cfg, tp, ht, positions=torch.from_numpy(pos),
                                            cache=cache, kv_source=ht)
    assert same is cache
    _close(t_out2, j_out2)
    _close(t_out2, t_out)          # the cached memory is the same memory


def test_flash_decode_layout_matches_jax_and_naive():
    rng = np.random.default_rng(2)
    qj, qt = _pair(rng, (2, 1, 8, 16))
    kj, kt = _pair(rng, (2, 11, 2, 16))
    vj, vt = _pair(rng, (2, 11, 2, 16))
    got = t_attn._flash_decode_attention(qt, kt, vt, 7, scale=0.25)
    _close(got, j_attn._flash_decode_attention(qj, kj, vj, jnp.int32(7), scale=0.25), 2e-6)
    naive = t_attn.naive_attention(qt, kt, vt, q_pos=torch.tensor([6]), kv_valid_len=7,
                                   scale=0.25)
    _close(got, naive.numpy(), 2e-6)


def test_decode_flash_partitioning_switch_matches_jax():
    """The port decodes in the sequence-sharded layout always; the JAX
    package with its switch on gives the same logits and caches (the
    model-level tests hold the port against the switch off)."""
    pair = model_pair("qwen2-7b")
    j_attn.set_decode_flash_partitioning(True)
    try:
        for (t_logits, t_cache), (j_logits, j_cache) in run_pair(pair, 3):
            _close(t_logits, j_logits)
            hold_cache(t_cache, j_cache, TOL)
    finally:
        j_attn.set_decode_flash_partitioning(False)


@pytest.mark.parametrize("causal,window", [(True, None), (False, 5), (True, 7)])
def test_flash_plain_at_unequal_head_widths_matches_jax_naive(causal, window):
    """q/k heads of 24, v heads of 16, GQA 4:2, head-major, against the JAX
    package's ``naive_attention`` over the same (B, S, H, ·) tensors."""
    rng = np.random.default_rng(8)
    qj, qt = _pair(rng, (2, 19, 4, 24))
    kj, kt = _pair(rng, (2, 23, 2, 24))
    vj, vt = _pair(rng, (2, 23, 2, 16))
    scale = 1 / math.sqrt(24)
    got = flash_attention_plain(qt.transpose(1, 2), kt.transpose(1, 2), vt.transpose(1, 2),
                                causal=causal, window=window, scale=scale)
    want = j_attn.naive_attention(qj, kj, vj, mask_kind="causal" if causal else "full",
                                  window=window, scale=scale)
    assert got.shape == (2, 4, 19, 16)
    _close(got.transpose(1, 2), want, 2e-5)
    assert t_flash.flash_attention_kernel(
        qt.transpose(1, 2), kt.transpose(1, 2), vt.transpose(1, 2)).shape == (2, 4, 19, 16)


def test_tensor_core_arithmetic_at_mla_heads_matches_jax_reference():
    """B4's tensor-core arithmetic (emulated as in ``test_torch_flash_tc``)
    at (hd, hd_v) = (192, 128) against the JAX package's naive attention on
    the same bf16 inputs, scale 1/sqrt(192), causal."""
    rng = np.random.default_rng(9)

    def bf16(shape):
        a = jnp.asarray(rng.normal(size=shape), jnp.bfloat16)
        return a, torch.from_numpy(np.asarray(a.astype(jnp.float32))).bfloat16()

    (qj, qt), (kj, kt), (vj, vt) = bf16((1, 300, 2, 192)), bf16((1, 300, 2, 192)), \
        bf16((1, 300, 2, 128))
    got = emulate_tc(qt.transpose(1, 2), kt.transpose(1, 2), vt.transpose(1, 2),
                     causal=True, window=None)
    assert got.shape == (1, 2, 300, 128)
    f32 = jnp.float32
    want = j_attn.naive_attention(qj.astype(f32), kj.astype(f32), vj.astype(f32))
    worst, share = _outside(got.transpose(1, 2), want)
    assert worst <= 1.0, (worst, share)


@pytest.mark.parametrize("dtype,pair,variant", [
    (torch.bfloat16, (192, 128), "tensor_cores"),
    (torch.float32, (192, 128), "cuda_cores"),
    (torch.bfloat16, (24, 16), "cuda_cores"),
    (torch.bfloat16, (128, 64), "cuda_cores"),
])
def test_variant_is_fixed_by_dtype_and_head_pair(dtype, pair, variant):
    assert t_flash.flash_variant(dtype, *pair) == variant
    assert ((192, 128) in t_flash.FLASH_HEAD_DIMS and (24, 16) in t_flash.FLASH_HEAD_DIMS
            and (128, 64) not in t_flash.FLASH_HEAD_DIMS)


@pytest.fixture(scope="module")
def xlstm():
    return model_pair("xlstm-1.3b")


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_forward_and_step_match_jax(xlstm, kind):
    """A 9-token forward from the initial state, then three one-token steps
    on its state: outputs and every state field."""
    cfg, _, j_params, _, t_params = xlstm
    if kind == "mlstm":
        jp = jax.tree_util.tree_map(lambda a: a[0, 0], j_params["mlstm"])
        tp = t_params.mlstm[0][0]
        j_fwd, j_step, t_fwd, t_step = (j_ssm.mlstm_forward, j_ssm.mlstm_step,
                                        t_ssm.mlstm_forward, t_ssm.mlstm_step)
    else:
        jp = jax.tree_util.tree_map(lambda a: a[0], j_params["slstm"])
        tp = t_params.slstm[0]
        j_fwd, j_step, t_fwd, t_step = (j_ssm.slstm_forward, j_ssm.slstm_step,
                                        t_ssm.slstm_forward, t_ssm.slstm_step)
    rng = np.random.default_rng(12)
    xj, xt = _pair(rng, (2, 9, cfg.d_model))
    j_out, j_st = j_fwd(cfg, jp, xj)
    t_out, t_st = t_fwd(cfg, tp, xt)
    for _ in range(4):
        _close(t_out, j_out)
        for got, want in zip(t_st, j_st):
            _close(got, want)
        xj, xt = _pair(rng, (2, 1, cfg.d_model))
        j_out, j_st = j_step(cfg, jp, xj, j_st)
        t_out, t_st = t_step(cfg, tp, xt, t_st)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_blocks_in_bf16_within_bf16_tolerance(kind):
    """One block in bf16, from the same bf16 input, to 5 % of the output's
    largest magnitude (as ``test_torch_serve.py`` holds bf16 logits)."""
    cfg, _, j_params, _, t_params = model_pair("xlstm-1.3b", dtype="bfloat16", seed=1)
    rng = np.random.default_rng(14)
    x = jnp.asarray(rng.normal(size=(2, 12, cfg.d_model)), jnp.bfloat16)
    xt = torch.from_numpy(np.asarray(x.astype(jnp.float32))).bfloat16()
    if kind == "mlstm":
        jp, tp = jax.tree_util.tree_map(lambda a: a[0, 0], j_params["mlstm"]), t_params.mlstm[0][0]
        want, _ = j_ssm.mlstm_forward(cfg, jp, x)
        got, _ = t_ssm.mlstm_forward(cfg, tp, xt)
    else:
        jp, tp = jax.tree_util.tree_map(lambda a: a[0], j_params["slstm"]), t_params.slstm[0]
        want, _ = j_ssm.slstm_forward(cfg, jp, x)
        got, _ = t_ssm.slstm_forward(cfg, tp, xt)
    want = np.asarray(want, np.float32)
    assert got.dtype == torch.bfloat16
    assert np.abs(got.detach().float().numpy() - want).max() <= 0.05 * np.abs(want).max()
