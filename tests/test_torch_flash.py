"""The port's attention (kernel B4's plain version, the model-layout wrapper,
``chunked_attention``, ``naive_attention``) against the JAX package on the
CPU.  On CPU tensors the flash-attention wrapper runs its plain version;
the CUDA kernel itself is held to that plain version on the card by
``chip_smoke.py``.

Tolerances: float32 2e-5 (sums in another order), bfloat16 2e-2 (one
output rounding to bfloat16), as the JAX package's own kernel tests."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as j_flash_attention
from repro.kernels import ref as j_ref
from repro.kernels.flash_attention import flash_attention_kernel as j_flash_kernel
from repro.models import attention as j_attn
from repro_torch.kernels.flash_attention import LAUNCHES, flash_attention_kernel
from repro_torch.kernels import ops as t_ops
from repro_torch.models import attention as t_attn

FLASH_CASES = [
    # (B, H, Hkv, Sq, Sk, hd, causal, window, dtype, block) — tests/test_kernels.py
    (1, 2, 2, 16, 16, 8, True, None, "float32", 8),
    (2, 4, 2, 33, 47, 16, True, None, "float32", 16),
    (2, 4, 1, 40, 40, 32, True, 8, "float32", 16),
    (1, 8, 8, 64, 64, 64, False, None, "float32", 32),
    (1, 4, 2, 128, 128, 16, True, None, "bfloat16", 64),
    (3, 2, 2, 17, 63, 8, False, 16, "float32", 16),
    (1, 16, 4, 96, 96, 128, True, None, "float32", 32),
]


def _pair(rng, shape, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    a = jnp.asarray(rng.normal(size=shape), getattr(jnp, dtype))
    t = torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(getattr(torch, dtype))
    return a, t


def _close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(
        got.detach().to(torch.float32).numpy(), np.asarray(want, np.float32), atol=tol, rtol=tol
    )


@pytest.mark.parametrize("idx", range(len(FLASH_CASES)))
def test_plain_flash_matches_pallas_kernel_and_reference(idx):
    b, h, hkv, sq, sk, hd, causal, window, dtype, blk = FLASH_CASES[idx]
    rng = np.random.default_rng(100 + idx)
    qj, qt = _pair(rng, (b, h, sq, hd), dtype)
    kj, kt = _pair(rng, (b, hkv, sk, hd), dtype)
    vj, vt = _pair(rng, (b, hkv, sk, hd), dtype)
    got = flash_attention_kernel(qt, kt, vt, causal=causal, window=window)
    assert got.dtype == qt.dtype and got.shape == (b, h, sq, hd)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    pallas = j_flash_kernel(qj, kj, vj, causal=causal, window=window,
                            block_q=blk, block_k=blk)
    _close(got, pallas, tol)
    _close(got, j_ref.flash_reference(qj, kj, vj, causal=causal, window=window), tol)


def test_fully_masked_rows_are_zero_as_in_the_pallas_kernel():
    """Full attention with a window over fewer keys than queries: the last
    query rows see no key at all, and both kernels give them zeros."""
    rng = np.random.default_rng(7)
    qj, qt = _pair(rng, (1, 2, 24, 8), "float32")
    kj, kt = _pair(rng, (1, 2, 6, 8), "float32")
    vj, vt = _pair(rng, (1, 2, 6, 8), "float32")
    got = flash_attention_kernel(qt, kt, vt, causal=False, window=4)
    want = j_flash_kernel(qj, kj, vj, causal=False, window=4, block_q=8, block_k=8)
    _close(got, want, 2e-5)
    assert not got[:, :, 10:].any()


def test_model_layout_wrapper():
    rng = np.random.default_rng(0)
    qj, qt = _pair(rng, (2, 24, 4, 16), "float32")   # (B, S, H, hd)
    kj, kt = _pair(rng, (2, 24, 2, 16), "float32")
    vj, vt = _pair(rng, (2, 24, 2, 16), "float32")
    got = t_ops.flash_attention(qt, kt, vt, causal=True, window=5)
    want = j_flash_attention(qj, kj, vj, causal=True, window=5, block_q=8, block_k=8)
    assert got.shape == (2, 24, 4, 16) and got.is_contiguous()
    _close(got, want, 2e-5)


def test_kernel_wrapper_takes_model_layout_views():
    """``transpose(1, 2)`` views of (B, S, H, hd) tensors go into the
    kernel wrapper as they are (the kernel reads them through strides), and
    the output comes back in q's layout: the model-layout entry point copies
    nothing."""
    rng = np.random.default_rng(4)
    qj, qt = _pair(rng, (2, 4, 30, 16), "float32")   # (B, H, S, hd)
    kj, kt = _pair(rng, (2, 2, 30, 16), "float32")
    vj, vt = _pair(rng, (2, 2, 30, 16), "float32")
    views = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (qt, kt, vt)]
    assert not any(t.is_contiguous() for t in views)
    got = flash_attention_kernel(*views, causal=True, window=7)
    assert got.stride() == views[0].stride()
    want = j_flash_kernel(qj, kj, vj, causal=True, window=7, block_q=8, block_k=8)
    _close(got, want, 2e-5)


@pytest.mark.parametrize("mask_kind,window", [("causal", None), ("causal", 7), ("full", 9)])
def test_chunked_attention_matches_jax(mask_kind, window):
    rng = np.random.default_rng(11)
    qj, qt = _pair(rng, (2, 48, 4, 16), "float32")
    kj, kt = _pair(rng, (2, 48, 2, 16), "float32")   # GQA: 2 query heads per KV head
    vj, vt = _pair(rng, (2, 48, 2, 16), "float32")
    got = t_attn.chunked_attention(qt, kt, vt, mask_kind=mask_kind, window=window)
    want = j_attn.chunked_attention(qj, kj, vj, mask_kind=mask_kind, window=window,
                                    chunk_q=16, chunk_k=16)
    _close(got, want, 2e-5)
    naive = j_attn.naive_attention(qj, kj, vj, mask_kind=mask_kind, window=window)
    _close(t_attn.naive_attention(qt, kt, vt, mask_kind=mask_kind, window=window), naive, 2e-5)


def test_chunked_full_attention_masks_by_index_at_any_length():
    """With ``mask_kind="full"`` and a key count that is not a multiple of
    its chunk, the JAX package's jnp ``chunked_attention`` lets the zero
    keys of its padding into the softmax; the port (like the Pallas kernel
    and ``naive_attention``) masks keys by index and needs no padding."""
    rng = np.random.default_rng(13)
    qj, qt = _pair(rng, (1, 40, 2, 16), "float32")
    kj, kt = _pair(rng, (1, 40, 2, 16), "float32")
    vj, vt = _pair(rng, (1, 40, 2, 16), "float32")
    got = t_attn.chunked_attention(qt, kt, vt, mask_kind="full", window=9)
    _close(got, j_attn.naive_attention(qj, kj, vj, mask_kind="full", window=9), 2e-5)
    _close(got, j_flash_attention(qj, kj, vj, causal=False, window=9, block_q=16,
                                  block_k=16), 2e-5)


def test_naive_attention_with_positions_and_valid_length():
    rng = np.random.default_rng(12)
    qj, qt = _pair(rng, (2, 3, 4, 8), "float32")
    kj, kt = _pair(rng, (2, 10, 4, 8), "float32")
    vj, vt = _pair(rng, (2, 10, 4, 8), "float32")
    q_pos = np.array([5, 6, 7])
    k_pos = np.array([9, 8, 7, 6, 5, 4, 3, 2, 1, 2**30])
    got = t_attn.naive_attention(
        qt, kt, vt, q_pos=torch.from_numpy(q_pos), k_pos=torch.from_numpy(k_pos),
        kv_valid_len=8, window=4)
    want = j_attn.naive_attention(
        qj, kj, vj, q_pos=jnp.asarray(q_pos), k_pos=jnp.asarray(k_pos),
        kv_valid_len=8, window=4)
    _close(got, want, 2e-5)


def test_wrapper_checks_its_inputs():
    q = torch.zeros(1, 4, 8, 16)
    k = torch.zeros(1, 3, 8, 16)
    with pytest.raises(ValueError):
        flash_attention_kernel(q, k, k)                   # 4 heads over 3
    k2 = torch.zeros(1, 2, 8, 16)
    with pytest.raises(TypeError):
        flash_attention_kernel(q.double(), k2.double(), k2.double())
    with pytest.raises(TypeError):
        flash_attention_kernel(q, k2.bfloat16(), k2)      # mixed dtypes
    with pytest.raises(ValueError):
        flash_attention_kernel(q, k2.transpose(2, 3).contiguous().transpose(2, 3), k2)
    with pytest.raises(ValueError):
        flash_attention_kernel(q, k2, k2, window=-1)
    assert LAUNCHES["flash_attention_kernel"] == 0        # CPU: never the kernel
