"""Driver of traffic kind ``closed_waves``: requests through the port's
``ServingEngine`` from a closed queue that is kept at least ``max_batch``
deep, so the engine admits a full wave of ``max_batch`` the moment the last
one finishes.

Traffic keys: ``max_batch``; ``prompt_lengths``, the multiset of
prompt lengths of every block of ``max_batch`` consecutive requests (each
block takes them in its own order, drawn from the seed, so every seed asks
for the same work); ``new_tokens`` (greedy); ``warmup_waves`` (served in
set-up, not counted); ``trace_units`` (engine steps traced: a wave is one
prefill and ``new_tokens - 1`` decodes); ``check_requests`` (how many of
the window's requests the reference reads, the longest among them) and
``check_batch`` (rows the reference runs at once).  Prompt tokens are drawn
uniformly from 1 .. V-1.

A unit of the window is one engine step, timed on the host: a step ends
when its sampled tokens reach the host.  The window closes at the end of
the first step, ``seconds`` after its start or later, that leaves no
request in flight.  Its rate counts the prompt tokens of the requests that
finished in it; padding counts for nothing."""

from __future__ import annotations

import gc

import numpy as np
import torch

from bench.harness import program
from bench.harness import weights as weights_lib
from bench.harness.cell import load_module
from bench.harness.window import Window
from bench.reference import serve as ref_serve


class Requests:
    """The request stream of a seed: blocks of ``max_batch`` prompts."""

    def __init__(self, traffic: dict, vocab: int, seed: int):
        self.t = traffic
        self.vocab = vocab
        self.rng = np.random.default_rng(weights_lib.derived_seed(seed, "requests"))

    def block(self) -> list[np.ndarray]:
        lengths = self.rng.permutation(np.asarray(self.t["prompt_lengths"]))
        return [self.rng.integers(1, self.vocab, size=int(n), dtype=np.int64) for n in lengths]


class Driver:
    kind = "serve"

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, device
        t = self.t = cell.traffic
        self.family = load_module("families", cell.model["family"])
        self.kernels = list(self.family.prefill_launches(cell.model, t["max_batch"],
                                                        max(t["prompt_lengths"])))
        self.window = None
        self.requests = {}          # uid -> {"prompt", "pad", "in_window"}
        self.decode_ms: list = []
        self.prefill_ms: list = []
        self.traced_prefills: list = []
        self.traced_decodes: list = []   # (real lengths of the wave, decode index) each
        self._wave = (0, [])
        self._decode_j = 0

    # ------------------------------------------------------------------
    def setup(self) -> None:
        from repro_torch.serving import ServingConfig, ServingEngine

        t = self.t
        longest = max(t["prompt_lengths"])
        self.cfg, self.model, params, self.specs = program.build(self.cell.config, self.seed,
                                                                 self.device)
        self.engine = ServingEngine(self.model, params, ServingConfig(
            max_batch=t["max_batch"], max_prompt_len=longest,
            max_len=longest + t["new_tokens"] + 1), rng_seed=self.seed)
        self.pad_id = self.engine.cfg.pad_id
        self.stream = Requests(t, self.cfg.vocab_size, self.seed)
        self._in_window = False
        for _ in range(t["warmup_waves"]):
            self._top_up()
            self.engine.step()
            while self.engine.active:
                self.engine.step()

    def _top_up(self) -> None:
        while len(self.engine.queue) < self.t["max_batch"]:
            for prompt in self.stream.block():
                uid = self.engine.submit(prompt, max_new_tokens=self.t["new_tokens"])
                self.requests[uid] = {"prompt": prompt, "pad": None}

    def _step(self) -> str:
        """One engine step; returns ``"prefill"`` or ``"decode"``."""
        e = self.engine
        if not e.active and e.queue:
            e.step()
            plen = max(len(st.request.prompt) for st in e.active.values())
            real = []
            for st in e.active.values():
                info = self.requests[st.uid]
                info["pad"], info["in_window"] = plen - len(info["prompt"]), self._in_window
                real.append(len(info["prompt"]))
            self._wave, self._decode_j = (plen, real), 0
            return "prefill"
        e.step()
        self._decode_j += 1
        return "decode"

    # ------------------------------------------------------------------
    def measure(self, seconds: float, tracer) -> None:
        win = self.window = Window(seconds)
        self._in_window = True
        win.start()
        i = 0
        while True:
            self._top_up()
            traced = not tracer.done
            tracer.before_unit()
            t0 = win.unit_start()
            kind = self._step()
            t1 = win.clock()
            if tracer.after_unit(i) and traced:
                if kind == "prefill":
                    self.traced_prefills.append(self._wave)
                else:
                    self.traced_decodes.append((self._wave[1], self._decode_j))
            i += 1
            (self.decode_ms if kind == "decode" else self.prefill_ms).append((t1 - t0) * 1e3)
            if win.unit_end(t0, idle=not self.engine.active):
                break
        self.done_in_window = [uid for uid, st in self.engine.finished.items()
                               if self.requests[uid].get("in_window")]
        win.add_work(sum(len(self.requests[u]["prompt"]) for u in self.done_in_window))
        self.served = {u: list(self.engine.finished[u].generated) for u in self.done_in_window}

    def release(self) -> None:
        del self.engine, self.model
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------------
    @property
    def attempted(self) -> int:
        return len(self.done_in_window)

    @property
    def failed(self) -> int:
        return sum(1 for u in self.done_in_window
                   if len(self.served[u]) != self.t["new_tokens"])

    def end_to_end(self) -> dict:
        return {"prompt_tokens_per_s": self.window.rate()}

    def layer_context(self, tracer) -> dict:
        m, mb = self.cell.model, self.t["max_batch"]
        launches: dict = {}
        flops = 0.0
        for plen, real in self.traced_prefills:
            for k, v in self.family.prefill_launches(m, mb, plen).items():
                launches.setdefault(k, []).extend(v)
            flops += sum(self.family.forward_flops(m, n, 1) for n in real)
        # the j-th decode step of a wave serves each of its requests the
        # token at its real position n - 1 + j
        for real, j in self.traced_decodes:
            flops += sum(self.family.decode_flops(m, n - 1 + j) for n in real)
        return {"kind": "serve", "launches": launches, "traced_flops": flops,
                "spans": {"decode_step_ms": self.decode_ms, "prefill_ms": self.prefill_ms}}

    def check(self) -> dict:
        """``{name: (value, detail)}``: the widest gap of a served token's
        reference logit below the reference's best (``logit_gap``), over
        ``check_requests`` of the window's requests drawn from the seed, the
        longest among them."""
        t = self.t
        weights = weights_lib.draw(self.specs, self.cell.config["init"], self.seed, self.device)
        family = load_module("reference", self.cell.model["family"])
        gaps, where = [], []
        for rows, served, group in self.rows(self.pick()):
            ref = ref_serve.reference_logits(family, weights, self.cell.model, rows,
                                             t["new_tokens"], batch=t["check_batch"])
            gaps.append(ref_serve.served_gaps(ref, served).cpu())
            where.extend(group)
            del ref
        gaps = torch.cat(gaps)
        at = int(gaps.argmax())
        k = gaps.shape[1]
        return {"logit_gap": (float(gaps.max()), f"request {where[at // k]} token {at % k}")}

    def pick(self) -> list:
        """The requests the check reads: ``check_requests`` of those that
        finished in the window, drawn from the seed, the longest among
        them."""
        uids = sorted(self.done_in_window)
        longest = max(uids, key=lambda u: len(self.requests[u]["prompt"]))
        rng = np.random.default_rng(weights_lib.derived_seed(self.seed, "sample"))
        rest = [u for u in uids if u != longest]
        return [longest] + list(rng.choice(rest, size=min(len(rest),
                                                          self.t["check_requests"] - 1),
                                           replace=False))

    def rows(self, uids) -> list:
        """``(rows, served, uids)`` for ``uids`` grouped by the length of
        the row the engine ran (its left padding, the prompt, every served
        token but the last); ``served``: the served tokens."""
        by_width: dict = {}
        for u in uids:
            info, gen = self.requests[u], self.served[u]
            row = np.concatenate([np.full(info["pad"], self.pad_id, np.int64), info["prompt"],
                                  np.asarray(gen[:-1], np.int64)])
            by_width.setdefault(len(row), []).append((row, gen, u))
        to = dict(device=self.device, dtype=torch.long)
        return [(torch.as_tensor(np.stack([r for r, _, _ in g]), **to),
                 torch.as_tensor(np.asarray([s for _, s, _ in g]), **to), [u for _, _, u in g])
                for _, g in sorted(by_width.items())]
