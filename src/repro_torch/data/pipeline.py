"""Deterministic synthetic data pipeline, host-sharded.

The same stream as the JAX package's ``data/pipeline.py``: batch ``i`` of a
run is a pure function of (seed, step, host), drawn with numpy from
``SeedSequence([seed, step, host])`` in the same order, so the tokens,
labels and frontend embeddings are ``==`` the JAX package's.  Tokens follow
a skewed unigram distribution with a short-range Markov successor, so the
training loss has signal to descend.  The batches are tensors on the
caller's device: tokens and labels as int64 (PyTorch's index type), the
frontends' patch or frame embeddings in the model's dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.mcop_phase import require_device

__all__ = ["DataConfig", "SyntheticLMDataset", "make_batch_shapes"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    vocab_size: int
    seed: int = 0
    num_hosts: int = 1
    host_index: int = 0
    ignore_id: int = -100


def _embed_dtype(mc: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if mc.dtype == "bfloat16" else torch.float32


class SyntheticLMDataset:
    """Deterministic, indexable stream of LM batches on ``device`` (default
    the GPU; without one this raises ``KernelError``).

    ``batch(step)`` is a pure function: calling it twice, on any host
    subset, in any order, yields identical data.  Per-host slicing takes
    ``global_batch // num_hosts`` rows.
    """

    def __init__(self, cfg: DataConfig, model_cfg: ModelConfig | None = None, *,
                 device: str | torch.device = "cuda"):
        if cfg.global_batch % cfg.num_hosts:
            raise ValueError("global_batch must divide num_hosts")
        self.cfg = cfg
        self.model_cfg = model_cfg
        self.device = require_device(device)
        self._zipf = self._unigram(cfg.vocab_size)

    @staticmethod
    def _unigram(v: int) -> np.ndarray:
        ranks = np.arange(1, v + 1, dtype=np.float64)
        p = 1.0 / ranks
        return p / p.sum()

    # ------------------------------------------------------------------
    def _batch_numpy(self, step: int) -> dict:
        """The batch of ``step`` as numpy arrays (int32 tokens and labels,
        float32 embeddings before the cast to the model's dtype)."""
        cfg = self.cfg
        local = cfg.global_batch // cfg.num_hosts
        rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step, cfg.host_index]))
        # skewed unigram draw + Markov smoothing: the next token correlates
        # with the previous one, a learnable bigram structure
        base = rng.choice(cfg.vocab_size, size=(local, cfg.seq_len), p=self._zipf)
        carry = rng.random((local, cfg.seq_len)) < 0.3
        tokens = base.copy()
        tokens[:, 1:] = np.where(
            carry[:, 1:],
            (tokens[:, :-1] * 31 + 17) % cfg.vocab_size,  # deterministic successor
            base[:, 1:],
        )
        tokens = tokens.astype(np.int32)
        labels = np.concatenate(
            [tokens[:, 1:], np.full((local, 1), cfg.ignore_id, np.int32)], axis=1)
        out = {"tokens": tokens, "labels": labels}
        mc = self.model_cfg
        for frontend, key in (("vision_patches", "patch_embeds"),
                              ("audio_frames", "frame_embeds")):
            if mc is not None and mc.frontend == frontend:
                n = mc.frontend_seq or 16
                out[key] = rng.standard_normal((local, n, mc.d_model)).astype(np.float32) * 0.02
        return out

    def batch(self, step: int) -> dict:
        out = {}
        for key, arr in self._batch_numpy(step).items():
            t = torch.from_numpy(arr)
            if key in ("tokens", "labels"):
                out[key] = t.to(device=self.device, dtype=torch.int64)
            else:
                out[key] = t.to(_embed_dtype(self.model_cfg)).to(self.device)
        return out

    # ------------------------------------------------------------------
    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1

    def take(self, n: int, start: int = 0) -> Iterator[dict]:
        for s in range(start, start + n):
            yield self.batch(s)


def make_batch_shapes(model_cfg: ModelConfig, seq_len: int, global_batch: int) -> dict:
    """Stand-ins for one training batch on the ``meta`` device (shapes and
    dtypes only), as the JAX package's ``ShapeDtypeStruct``\\ s."""
    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    shapes = {"tokens": meta((global_batch, seq_len), torch.int64),
              "labels": meta((global_batch, seq_len), torch.int64)}
    n = model_cfg.frontend_seq or 16
    if model_cfg.frontend == "vision_patches":
        shapes["patch_embeds"] = meta((global_batch, n, model_cfg.d_model),
                                      _embed_dtype(model_cfg))
    if model_cfg.frontend == "audio_frames":
        shapes["frame_embeds"] = meta((global_batch, n, model_cfg.d_model),
                                      _embed_dtype(model_cfg))
    return shapes
