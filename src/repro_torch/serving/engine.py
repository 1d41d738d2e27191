"""Batched serving engine: KV-cache slots + wave-admission scheduler.

The engine owns a fixed pool of ``max_batch`` cache slots (one decode
cache built by ``Model.init_cache``).  Requests flow through a FIFO
admission queue; each engine step either

* **prefills** a new wave of admitted requests (one batched prefill,
  prompts left-padded to the wave's longest so every prompt ends at the
  same position), or
* **decodes** every slot one token (one batched ``decode_step`` over the
  whole pool; finished slots keep decoding a pad token and are ignored).

Per-slot state is host metadata; token and cache state stay on the
model's device.  ``extras`` (the frontends' ``patch_embeds`` or
``frame_embeds``) go with every prefill, as in the JAX package's engine.  Sampling draws from a ``torch.Generator`` seeded with
``rng_seed`` on that device: greedy (temperature 0) tokens equal the JAX
package's engine's for equal logits, sampled ones follow the same
distribution but not the same numbers.
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from repro_torch.models.transformer import Model

__all__ = ["Request", "RequestState", "ServingConfig", "ServingEngine"]


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray            # (prompt_len,) int32
    max_new_tokens: int
    temperature: float = 0.0      # 0 → greedy
    eos_id: int | None = None


@dataclasses.dataclass
class RequestState:
    request: Request
    slot: int
    generated: list[int] = dataclasses.field(default_factory=list)
    done: bool = False

    @property
    def uid(self) -> int:
        return self.request.uid


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    max_batch: int = 8
    max_prompt_len: int = 128
    max_len: int = 256            # prompt + generation capacity per slot
    pad_id: int = 0


class ServingEngine:
    def __init__(self, model: Model, params, cfg: ServingConfig, *,
                 extras: dict | None = None, rng_seed: int = 0):
        self.model = model
        self.params = params
        self.cfg = cfg
        self.queue: deque[Request] = deque()
        self.active: dict[int, RequestState] = {}       # slot → state
        self.finished: dict[int, RequestState] = {}     # uid → state
        self._uid = 0

        # one pooled cache with one scalar length: slots advance in
        # lockstep, so a wave is admitted only when the pool is empty
        self.cache = model.init_cache(cfg.max_batch, cfg.max_len)
        self.device = torch.device(model.device)
        self.extras = {k: v.to(self.device) for k, v in (extras or {}).items()}
        self._gen = torch.Generator(device=self.device).manual_seed(rng_seed)
        self._tokens = torch.full((cfg.max_batch, 1), cfg.pad_id, dtype=torch.long,
                                  device=self.device)
        self._active_mask = np.zeros(cfg.max_batch, bool)

    # ------------------------------------------------------------------
    def submit(self, prompt: np.ndarray, *, max_new_tokens: int = 32,
               temperature: float = 0.0, eos_id: int | None = None) -> int:
        uid = self._uid
        self._uid += 1
        if len(prompt) > self.cfg.max_prompt_len:
            raise ValueError("prompt longer than max_prompt_len")
        self.queue.append(
            Request(uid, np.asarray(prompt, np.int32), max_new_tokens, temperature, eos_id)
        )
        return uid

    # ------------------------------------------------------------------
    def _admit(self) -> list[RequestState]:
        """Move queued requests into free slots; returns admitted states."""
        free = [s for s in range(self.cfg.max_batch) if not self._active_mask[s]]
        admitted: list[RequestState] = []
        while free and self.queue:
            req = self.queue.popleft()
            slot = free.pop(0)
            st = RequestState(req, slot)
            self.active[slot] = st
            self._active_mask[slot] = True
            admitted.append(st)
        return admitted

    def _sample(self, logits: torch.Tensor, temps: np.ndarray) -> np.ndarray:
        out = torch.argmax(logits, dim=-1)  # first maximum wins ties
        if (temps > 0).any():
            t = torch.as_tensor(np.maximum(temps, 1e-6), dtype=torch.float32,
                                device=logits.device)[:, None]
            probs = torch.softmax(logits.to(torch.float32) / t, dim=-1)
            sampled = torch.multinomial(probs, 1, generator=self._gen)[:, 0]
            out = torch.where(torch.as_tensor(temps > 0, device=logits.device), sampled, out)
        return out.cpu().numpy().astype(np.int32)

    # ------------------------------------------------------------------
    def step(self) -> bool:
        """One engine iteration.  Returns True while work remains.

        Admission model: waves.  A wave is admitted only when the pool is
        empty (the shared scalar cache length advances in lockstep); within
        a wave, sequences retire as they finish.
        """
        if not self.active and self.queue:
            # ---- new wave: reset cache, admit, batch-prefill ------------
            self.cache = self.model.init_cache(self.cfg.max_batch, self.cfg.max_len)
            admitted = self._admit()
            plen = max(len(st.request.prompt) for st in admitted)
            toks = np.full((self.cfg.max_batch, plen), self.cfg.pad_id, np.int64)
            for st in admitted:
                # left-pad so every prompt ends at position plen-1
                p = st.request.prompt
                toks[st.slot, plen - len(p):] = p
            logits, self.cache = self.model.prefill(
                self.params, {"tokens": torch.from_numpy(toks).to(self.device), **self.extras},
                self.cache,
            )
            temps = np.array([
                self.active[s].request.temperature if self._active_mask[s] else 0.0
                for s in range(self.cfg.max_batch)
            ])
            self._push_tokens(self._sample(logits, temps))
            return True

        if self.active:
            # ---- decode one token for the whole pool --------------------
            logits, self.cache = self.model.decode_step(self.params, self._tokens, self.cache)
            temps = np.array([
                self.active[s].request.temperature if s in self.active else 0.0
                for s in range(self.cfg.max_batch)
            ])
            self._push_tokens(self._sample(logits, temps))
            return True

        return bool(self.queue)

    def _push_tokens(self, nxt: np.ndarray) -> None:
        new_tok = np.full((self.cfg.max_batch, 1), self.cfg.pad_id, np.int64)
        for slot in list(self.active):
            st = self.active[slot]
            tok = int(nxt[slot])
            st.generated.append(tok)
            req = st.request
            if (req.eos_id is not None and tok == req.eos_id) or len(
                st.generated
            ) >= req.max_new_tokens:
                st.done = True
                self.finished[st.uid] = st
                del self.active[slot]
                self._active_mask[slot] = False
            else:
                new_tok[slot, 0] = tok
        self._tokens = torch.from_numpy(new_tok).to(self.device)

    # ------------------------------------------------------------------
    def run_to_completion(self, max_steps: int = 10_000) -> dict[int, list[int]]:
        steps = 0
        while (self.active or self.queue) and steps < max_steps:
            self.step()
            steps += 1
        return {uid: st.generated for uid, st in sorted(self.finished.items())}
