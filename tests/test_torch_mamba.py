"""The port's Mamba2 path (kernel B5's plain version, the model-layout
wrapper, ``mamba2_forward`` and ``mamba2_step``) against the JAX package on
the CPU.  On CPU tensors the scan wrapper runs its plain version; the CUDA
kernel itself is held to that plain version on the card by
``chip_smoke.py``.

Tolerances: the scan 1e-4, the layer 2e-4 (float32 sums in another order,
compounded over the chunks), as the JAX package's own kernel tests."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHITECTURES, reduce_config
from repro.kernels import mamba_chunk_scan as j_scan
from repro.kernels import ref as j_ref
from repro.models import ssm as j_ssm
from repro_torch import convert
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduce_config as t_reduce_config
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels.mamba_scan import LAUNCHES, mamba_chunk_scan_kernel
from repro_torch.models import ssm as t_ssm

MAMBA_CASES = [
    # (B, S, H, P, N, chunk) — tests/test_kernels.py
    (1, 8, 1, 4, 2, 4),
    (2, 32, 3, 8, 4, 8),
    (1, 64, 2, 16, 16, 16),
    (2, 24, 4, 8, 8, 24),      # single chunk
    (1, 128, 1, 32, 8, 32),
]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.detach().to(torch.float32).numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("idx", range(len(MAMBA_CASES)))
def test_plain_scan_matches_pallas_kernel_and_token_recurrence(idx):
    b, s, h, p, n, chunk = MAMBA_CASES[idx]
    rng = np.random.default_rng(200 + idx)
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.05, 1.0, size=(b, s, h)).astype(np.float32)
    ld = -rng.uniform(0.01, 0.8, size=(b, s, h)).astype(np.float32)
    bm = rng.normal(size=(b, s, n)).astype(np.float32)
    cm = rng.normal(size=(b, s, n)).astype(np.float32)
    h0 = rng.normal(size=(b, h, p, n)).astype(np.float32)
    y, h_t = t_ops.mamba_chunk_scan(*map(_t, (x, dt, ld, bm, cm, h0)), chunk=chunk)
    assert y.shape == (b, s, h, p) and h_t.shape == (b, h, p, n)

    y_k, h_k = j_scan(*map(jnp.asarray, (x, dt, ld, bm, cm, h0)), chunk=chunk)
    _close(y, y_k, 1e-4)
    _close(h_t, h_k, 1e-4)

    q = min(chunk, s)
    nc = s // q
    y_r, h_r = j_ref.mamba_chunk_scan_reference(
        jnp.asarray(x).reshape(b, nc, q, h, p).transpose(0, 3, 1, 2, 4),
        jnp.asarray(dt).reshape(b, nc, q, h).transpose(0, 3, 1, 2),
        jnp.asarray(ld).reshape(b, nc, q, h).transpose(0, 3, 1, 2),
        jnp.asarray(bm).reshape(b, nc, q, n),
        jnp.asarray(cm).reshape(b, nc, q, n),
        jnp.asarray(h0),
    )
    _close(y, y_r.transpose(0, 2, 3, 1, 4).reshape(b, s, h, p), 1e-4)
    _close(h_t, h_r, 1e-4)


def test_scan_takes_the_models_strided_views():
    """x, Bm and Cm as slices of one (B, S, H P + 2 N) projection and dt /
    ld step-major, as ``mamba2_forward`` hands them over: the kernel wrapper
    takes the views as they are, gives the contiguous copies' result, and
    returns y step-major, so ``ops.mamba_chunk_scan`` copies nothing."""
    b, s, h, p, n, q = 2, 32, 3, 8, 4, 8
    nc = s // q
    rng = np.random.default_rng(9)
    xbc = rng.normal(size=(b, s, h * p + 2 * n)).astype(np.float32)
    dt = rng.uniform(0.05, 1.0, size=(b, s, h)).astype(np.float32)
    ld = -rng.uniform(0.01, 0.8, size=(b, s, h)).astype(np.float32)
    h0 = rng.normal(size=(b, h, p, n)).astype(np.float32)
    x, bm, cm = torch.split(_t(xbc), [h * p, n, n], dim=-1)
    views = (x.reshape(b, nc, q, h, p).permute(0, 3, 1, 2, 4),
             _t(dt).reshape(b, nc, q, h).permute(0, 3, 1, 2),
             _t(ld).reshape(b, nc, q, h).permute(0, 3, 1, 2),
             bm.reshape(b, nc, q, n), cm.reshape(b, nc, q, n), _t(h0))
    assert not any(t.is_contiguous() for t in views[:5])
    y, h_t = mamba_chunk_scan_kernel(*views)
    y_c, h_c = mamba_chunk_scan_kernel(*(t.contiguous() for t in views))
    _close(y, y_c.numpy(), 1e-6)
    _close(h_t, h_c.numpy(), 1e-6)

    y_m, h_m = t_ops.mamba_chunk_scan(x.reshape(b, s, h, p), _t(dt), _t(ld), bm, cm,
                                      _t(h0), chunk=q)
    assert y_m.is_contiguous()
    sl = (xbc[..., :h * p].reshape(b, s, h, p), dt, ld, xbc[..., h * p:h * p + n],
          xbc[..., h * p + n:], h0)
    y_k, h_k = j_scan(*map(jnp.asarray, sl), chunk=q)
    _close(y_m, y_k, 1e-4)
    _close(h_m, h_k, 1e-4)


def test_scan_wrappers_check_their_inputs():
    x = torch.zeros(1, 2, 3, 4, 5)
    dt = torch.zeros(1, 2, 3, 4)
    bm = torch.zeros(1, 3, 4, 6)
    h0 = torch.zeros(1, 2, 5, 6)
    y, h = mamba_chunk_scan_kernel(x, dt, dt, bm, bm, h0)
    assert y.shape == x.shape and h.shape == h0.shape
    with pytest.raises(TypeError):
        mamba_chunk_scan_kernel(x.double(), dt, dt, bm, bm, h0)
    with pytest.raises(ValueError):
        mamba_chunk_scan_kernel(x, dt, dt, bm[:, :2].contiguous(), bm, h0)
    with pytest.raises(ValueError):
        t_ops.mamba_chunk_scan(torch.zeros(1, 10, 2, 4), torch.zeros(1, 10, 2),
                               torch.zeros(1, 10, 2), torch.zeros(1, 10, 3),
                               torch.zeros(1, 10, 3), torch.zeros(1, 2, 4, 3), chunk=4)
    assert LAUNCHES["mamba_chunk_scan_kernel"] == 0          # CPU: never the kernel


# ----------------------------------------------------------------------
# The layer, on reduced zamba2 in float32 with the JAX parameters carried over
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def layer():
    j_cfg = reduce_config(ARCHITECTURES["zamba2-1.2b"], dtype="float32")
    t_cfg = t_reduce_config(t_get_config("zamba2-1.2b"), dtype="float32")
    assert dataclasses.asdict(j_cfg) == dataclasses.asdict(t_cfg)
    j_p = j_ssm.init_mamba2(jax.random.PRNGKey(3), j_cfg)
    t_p = t_ssm.init_mamba2(torch.Generator().manual_seed(0), t_cfg, device="cpu")
    t_p.load_state_dict(convert.tree_to_state_dict(jax.tree_util.tree_map(np.asarray, j_p)))
    return j_cfg, t_cfg, j_p, t_p


def _state(rng, cfg, b):
    d_inner, n_heads, n_state = t_ssm._mamba_dims(cfg)
    h = rng.normal(size=(b, n_heads, cfg.mamba_headdim, n_state)).astype(np.float32)
    conv = rng.normal(size=(b, cfg.ssm_conv - 1, d_inner + 2 * n_state)).astype(np.float32)
    return h, conv


@pytest.mark.parametrize("s_len,with_state", [(37, True), (37, False), (32, True), (9, True)])
def test_mamba2_forward_matches_jax(layer, s_len, with_state):
    """37 is not a multiple of the chunk (16): right padding with dt = 0 and
    the conv state taken at the last real token; 9 is under one chunk."""
    j_cfg, t_cfg, j_p, t_p = layer
    rng = np.random.default_rng(s_len)
    x = rng.normal(size=(2, s_len, t_cfg.d_model)).astype(np.float32)
    h, conv = _state(rng, t_cfg, 2)
    j_st = j_ssm.MambaState(jnp.asarray(h), jnp.asarray(conv)) if with_state else None
    t_st = t_ssm.MambaState(_t(h), _t(conv)) if with_state else None
    y_j, st_j = j_ssm.mamba2_forward(j_cfg, j_p, jnp.asarray(x), j_st)
    y_t, st_t = t_ssm.mamba2_forward(t_cfg, t_p, _t(x), t_st)
    assert y_t.shape == (2, s_len, t_cfg.d_model)
    _close(y_t, y_j, 2e-4)
    _close(st_t.h, st_j.h, 2e-4)
    _close(st_t.conv, st_j.conv, 2e-4)


def test_mamba2_step_matches_jax(layer):
    j_cfg, t_cfg, j_p, t_p = layer
    rng = np.random.default_rng(5)
    h, conv = _state(rng, t_cfg, 3)
    j_st = j_ssm.MambaState(jnp.asarray(h), jnp.asarray(conv))
    t_st = t_ssm.MambaState(_t(h), _t(conv))
    for _ in range(3):
        x = rng.normal(size=(3, 1, t_cfg.d_model)).astype(np.float32)
        y_j, j_st = j_ssm.mamba2_step(j_cfg, j_p, jnp.asarray(x), j_st)
        y_t, t_st = t_ssm.mamba2_step(t_cfg, t_p, _t(x), t_st)
        _close(y_t, y_j, 2e-4)
        _close(t_st.h, j_st.h, 2e-4)
        _close(t_st.conv, j_st.conv, 2e-4)
