"""``Model.train_loss`` and its gradients against the JAX package's.

Every family's reduced config in float32, the JAX parameters carried into
the port (``convert.model_params_from_jax``), one seeded batch: the loss and
its parts, and every parameter's gradient against
``jax.value_and_grad(repro Model.train_loss)`` (the JAX gradient tree mapped
to the port's names through the same function).  Then ``remat`` on and off
(the same numbers), the chunked cross-entropy (``vocab_chunk``) against
the JAX package's, and the plain backwards of the two kernels (autograd through the plain versions)
against ``jax.vjp`` of ``repro``'s ``chunked_attention`` and of its token
recurrence of the Mamba2 scan.  The chunked attention route at ``s > 4096``
and MoE's capacity drops are in ``test_torch_train_routes.py``.

Tolerances: the loss to 1e-5 relative; each gradient's max abs error to
1e-4 of that gradient's max abs value (float32 sums in another order
through two layers and their backward).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import model_pair
from repro.kernels.ref import mamba_chunk_scan_reference
from repro.models import attention as j_attn
from repro_torch import convert
from repro_torch.kernels import ops
from repro_torch.kernels.ref import mamba_chunk_scan_bwd_plain

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
FAMILIES = ("qwen2-7b", "deepseek-v2-236b", "qwen2-vl-72b", "seamless-m4t-large-v2",
            "zamba2-1.2b", "xlstm-1.3b")


def make_batch(cfg, b: int, s: int, seed: int = 0) -> dict:
    """A seeded numpy batch: tokens, next-token labels (the last of each row
    and a few others -100), and the frontend's embeddings."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, cfg.vocab_size, size=(b, s)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((b, 1), -100, np.int32)], axis=1)
    labels[:, 3] = -100
    batch = {"tokens": tokens, "labels": labels}
    key = {"vision_patches": "patch_embeds", "audio_frames": "frame_embeds"}.get(cfg.frontend)
    if key:
        batch[key] = (rng.standard_normal((b, cfg.frontend_seq, cfg.d_model)) * 0.02
                      ).astype(np.float32)
    return batch


def jax_value_and_grad(j_model, j_params, batch):
    fn = jax.jit(jax.value_and_grad(lambda p, bt: j_model.train_loss(p, bt), has_aux=True))
    (loss, parts), grads = fn(j_params, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), {k: float(v) for k, v in parts.items()}, grads


def torch_value_and_grad(t_model, t_params, batch):
    tb = {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
          for k, v in batch.items()}
    loss, parts = t_model.train_loss(t_params, tb)
    names = [k for k, p in t_params.named_parameters()]
    grads = torch.autograd.grad(loss, list(t_params.parameters()))
    return (float(loss.detach()), {k: float(v.detach()) for k, v in parts.items()},
            dict(zip(names, grads)))


def hold_grads(t_grads, j_grads, cfg):
    want = convert.model_params_from_jax(jax.tree_util.tree_map(np.asarray, j_grads), cfg)
    assert set(want) == set(t_grads)
    worst = 0.0
    for name, w in want.items():
        g = t_grads[name].detach().float()
        scale = float(w.abs().max())
        err = float((g - w.float()).abs().max())
        assert err <= GRAD_TOL * scale + 1e-9, (name, err, scale)
        worst = max(worst, err / max(scale, 1e-30))
    return worst


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    cfg, j_model, j_params, t_model, t_params = model_pair(request.param)
    batch = make_batch(cfg, 2, 24)
    return cfg, j_model, j_params, t_model, t_params, batch


def test_train_loss_and_every_gradient_match_jax(family):
    cfg, j_model, j_params, t_model, t_params, batch = family
    j_loss, j_parts, j_grads = jax_value_and_grad(j_model, j_params, batch)
    t_loss, t_parts, t_grads = torch_value_and_grad(t_model, t_params, batch)
    assert abs(t_loss - j_loss) <= LOSS_TOL * abs(j_loss)
    for key in ("nll", "aux"):
        assert abs(t_parts[key] - j_parts[key]) <= LOSS_TOL * max(abs(j_parts[key]), 1e-6)
    if cfg.family == "moe":
        assert t_parts["aux"] > 0
    hold_grads(t_grads, j_grads, cfg)


def test_remat_gives_the_same_numbers(family):
    cfg, _, _, t_model, t_params, batch = family
    runs = []
    for remat in (True, False):
        t_model.remat = remat
        runs.append(torch_value_and_grad(t_model, t_params, batch))
    t_model.remat = True
    (l1, p1, g1), (l2, p2, g2) = runs
    assert l1 == l2 and p1 == p2
    assert all(torch.equal(g1[k], g2[k]) for k in g1)


@pytest.mark.parametrize("arch", ["qwen2-7b", "zamba2-1.2b"])
def test_vocab_chunked_cross_entropy_matches_jax(arch):
    """``vocab_chunk`` 96 over a vocabulary of 256: three chunks, the last
    padded by 32 columns, in both packages; the port's chunked loss also
    equals its unchunked one."""
    cfg, j_model, j_params, t_model, t_params = model_pair(arch)
    batch = make_batch(cfg, 2, 20, seed=1)
    plain = torch_value_and_grad(t_model, t_params, batch)
    j_model.vocab_chunk = t_model.vocab_chunk = 96
    j_loss, _, j_grads = jax_value_and_grad(j_model, j_params, batch)
    t_loss, _, t_grads = torch_value_and_grad(t_model, t_params, batch)
    assert abs(t_loss - j_loss) <= LOSS_TOL * abs(j_loss)
    assert abs(t_loss - plain[0]) <= LOSS_TOL * abs(plain[0])
    hold_grads(t_grads, j_grads, cfg)


@pytest.mark.parametrize("causal,window,hkv,s", [(True, None, 2, 150), (True, 40, 4, 150),
                                                 (False, 33, 1, 160)])
def test_plain_flash_backward_matches_jax_vjp(causal, window, hkv, s):
    """Autograd through B4's plain version (``ops.flash_attention`` on CPU
    tensors, model layout) against ``jax.vjp`` of ``repro``'s
    ``chunked_attention`` at small chunks (several query and key chunks).
    Full attention takes a length that is a multiple of the key chunk:
    ``repro``'s ``chunked_attention`` zero-pads the keys to it and masks
    the padding only by the causal mask, so under "full" its padded keys
    take part in the softmax (ROADMAP Queue C)."""
    rng = np.random.default_rng(5)
    b, h, hd = 2, 4, 16
    q, k, v = (rng.standard_normal(sh).astype(np.float32)
               for sh in ((b, s, h, hd), (b, s, hkv, hd), (b, s, hkv, hd)))
    dout = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    kind = "causal" if causal else "full"
    _, vjp = jax.vjp(lambda q_, k_, v_: j_attn.chunked_attention(
        q_, k_, v_, mask_kind=kind, window=window, chunk_q=64, chunk_k=32), q, k, v)
    want = vjp(jnp.asarray(dout))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = ops.flash_attention(*leaves, causal=causal, window=window)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(dout))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()


def test_plain_mamba_backward_matches_jax_vjp():
    """Autograd through B5's plain version against ``jax.vjp`` of ``repro``'s
    token recurrence of the same scan, with a state carried in and the
    final state's gradient given; dt = 0 on the padded tail."""
    rng = np.random.default_rng(6)
    b, h, nc, q, p, n = 2, 3, 3, 16, 8, 6
    dt = rng.uniform(0.05, 1.0, (b, h, nc, q)).astype(np.float32)
    dt[:, :, -1, 10:] = 0.0
    ld = (-rng.uniform(0.01, 0.8, (b, h, nc, q)) * dt).astype(np.float32)
    x, bm, cm, h0 = (rng.standard_normal(sh).astype(np.float32) for sh in
                     ((b, h, nc, q, p), (b, nc, q, n), (b, nc, q, n), (b, h, p, n)))
    dy = rng.standard_normal((b, h, nc, q, p)).astype(np.float32)
    dh = rng.standard_normal((b, h, p, n)).astype(np.float32)
    _, vjp = jax.vjp(mamba_chunk_scan_reference, x, dt, ld, bm, cm, h0)
    want = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    got = mamba_chunk_scan_bwd_plain(*(torch.from_numpy(a) for a in (x, dt, ld, bm, cm, h0)),
                                     torch.from_numpy(dy), torch.from_numpy(dh))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-4 * max(1.0, np.abs(w).max())
