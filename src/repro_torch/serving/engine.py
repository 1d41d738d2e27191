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

Observability (both optional, pure observers, as the broker's): a
``tracer`` (:class:`~repro_torch.obs.trace.Tracer`) is made the active one
for each step, which is one ``engine.prefill`` or ``engine.decode`` span
with the model's spans (``model.*``) inside it; ``metrics`` (a
:class:`~repro_torch.obs.metrics.MetricsRegistry`) counts prompt, padded
and generated tokens and steps by kind.  ``docs/PORT.md`` (section 6)
lists them.  With neither attached a step builds no span and opens no
profiler range.
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from repro_torch.models.transformer import Model
from repro_torch.obs import trace
from repro_torch.obs.metrics import NULL_COUNTER, MetricsRegistry

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


def _nbytes(tree) -> int:
    """Bytes of the tensors of a cache (nested dicts of tensors)."""
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    return tree.nbytes if isinstance(tree, torch.Tensor) else 0


class ServingEngine:
    def __init__(self, model: Model, params, cfg: ServingConfig, *,
                 extras: dict | None = None, rng_seed: int = 0,
                 tracer: trace.Tracer | None = None,
                 metrics: MetricsRegistry | None = None):
        self.model = model
        self.params = params
        self.cfg = cfg
        self.queue: deque[Request] = deque()
        self.active: dict[int, RequestState] = {}       # slot → state
        self.finished: dict[int, RequestState] = {}     # uid → state
        self._uid = 0
        self.tracer = tracer
        self._wave = -1               # index of the current wave
        self._decode_index = 0        # decode steps of the current wave so far

        def counter(name, **labels):
            return NULL_COUNTER if metrics is None else metrics.counter(name, **labels)

        self._c_prompt = counter("serve_prompt_tokens")
        self._c_padded = counter("serve_padded_tokens")
        self._c_generated = counter("serve_generated_tokens")
        self._c_prefills = counter("serve_steps", kind="prefill")
        self._c_decodes = counter("serve_steps", kind="decode")

        # one pooled cache with one scalar length: slots advance in
        # lockstep, so a wave is admitted only when the pool is empty
        self.cache = model.init_cache(cfg.max_batch, cfg.max_len)
        self._cache_bytes = _nbytes(self.cache)
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
        if self.tracer is None:
            return self._step()
        with self.tracer.activate():
            return self._step()

    def _step(self) -> bool:
        if not self.active and self.queue:
            # ---- new wave: reset cache, admit, batch-prefill ------------
            self._wave += 1
            self._decode_index = 0
            with trace.span("engine.prefill", wave=self._wave) as sp:
                with trace.span("engine.init_cache", bytes=self._cache_bytes):
                    self.cache = self.model.init_cache(self.cfg.max_batch, self.cfg.max_len)
                with trace.span("engine.admit"):
                    admitted = self._admit()
                plen = max(len(st.request.prompt) for st in admitted)
                prompt_tokens = sum(len(st.request.prompt) for st in admitted)
                padded_tokens = self.cfg.max_batch * plen
                sp.set(requests=len(admitted), prompt_tokens=prompt_tokens,
                       padded_tokens=padded_tokens, longest=plen)
                with trace.span("engine.pack"):
                    toks = np.full((self.cfg.max_batch, plen), self.cfg.pad_id, np.int64)
                    for st in admitted:
                        # left-pad so every prompt ends at position plen-1
                        p = st.request.prompt
                        toks[st.slot, plen - len(p):] = p
                    toks = torch.from_numpy(toks).to(self.device)
                logits, self.cache = self.model.prefill(
                    self.params, {"tokens": toks, **self.extras}, self.cache)
                with trace.span("engine.sample"):
                    temps = np.array([
                        self.active[s].request.temperature if self._active_mask[s] else 0.0
                        for s in range(self.cfg.max_batch)
                    ])
                    nxt = self._sample(logits, temps)
                with trace.span("engine.push"):
                    self._push_tokens(nxt)
            self._c_prompt.inc(prompt_tokens)
            self._c_padded.inc(padded_tokens)
            self._c_generated.inc(len(admitted))
            self._c_prefills.inc()
            return True

        if self.active:
            # ---- decode one token for the whole pool --------------------
            self._decode_index += 1
            generated = len(self.active)
            with trace.span("engine.decode", wave=self._wave, step=self._decode_index,
                            active=generated):
                logits, self.cache = self.model.decode_step(self.params, self._tokens,
                                                            self.cache)
                with trace.span("engine.sample"):
                    temps = np.array([
                        self.active[s].request.temperature if s in self.active else 0.0
                        for s in range(self.cfg.max_batch)
                    ])
                    nxt = self._sample(logits, temps)
                with trace.span("engine.push"):
                    self._push_tokens(nxt)
            self._c_generated.inc(generated)
            self._c_decodes.inc()
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
