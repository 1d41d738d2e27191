"""Driver of traffic kind ``train``: the port's training step
(``repro_torch.train.make_train_step`` over ``Model.train_loss``, AdamW,
deterministic algorithms on as ``launch/train.py`` sets them) on batches the
benchmark draws from the seed.

Traffic keys: ``batch`` and ``seq_len`` (one microbatch of ``batch`` rows),
``n_micro``, ``optimizer`` (``AdamWConfig``'s fields), ``data`` (each row's
Zipf exponent over the vocabulary by rank, cycled over the rows, and a
successor rule: with probability ``successor_p`` a token is ``(prev *
successor_mul + successor_add) mod V``), ``check_steps`` (the steps set-up
runs and the reference follows) and ``trace_units`` (steps traced).

Set-up builds the step, its model and optimizer state once, and runs the
first ``check_steps`` steps through the same call and feed the window uses
(the warm-up; every row differs).  It keeps the signs of the first
gradient as the optimizer got it (from its first moment after one step:
``mu / (1 - b1)``) and the norm of each parameter's change after the last
of them.  The window then runs whole steps of the same object; a step ends
when its loss is read on the host.  After the window the reference follows
the first steps from the same weights and batches, drawn again."""

from __future__ import annotations

import gc
import statistics

import torch

from bench.harness import program
from bench.harness import weights as weights_lib
from bench.harness.cell import load_module
from bench.harness.window import Window
from bench.reference import train as ref_train


class Feed:
    """Token batches of (batch, seq_len) drawn on the device from the seed;
    each call to ``next()`` gives new rows."""

    def __init__(self, data: dict, vocab: int, batch: int, seq: int, seed: int, device):
        self.data, self.vocab, self.batch, self.seq = data, vocab, batch, seq
        self.gen = torch.Generator(device=device).manual_seed(
            weights_lib.derived_seed(seed, "data"))
        ranks = torch.arange(1, vocab + 1, dtype=torch.float64)
        exps = data["zipf_exponents"]
        probs = torch.stack([ranks ** -exps[r % len(exps)] for r in range(batch)])
        self.probs = (probs / probs.sum(dim=1, keepdim=True)).to(torch.float32).to(device)
        self.device = device

    def next(self) -> dict:
        d = self.data
        base = torch.multinomial(self.probs, self.seq + 1, replacement=True, generator=self.gen)
        carry = torch.rand(base.shape, generator=self.gen, device=self.device) < d["successor_p"]
        succ = (base * d["successor_mul"] + d["successor_add"]) % self.vocab
        toks = torch.cat([base[:, :1], torch.where(carry[:, 1:], succ[:, :-1], base[:, 1:])], 1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _leaf_norms(names, tensor_of) -> dict:
    """``{name: norm of tensor_of(name)}``, one leaf alive at a time."""
    names = list(names)
    norms = torch.stack([torch.linalg.vector_norm(tensor_of(n).float()) for n in names])
    return dict(zip(names, norms.tolist()))


def leaf_gaps(prog: dict, ref: dict, keep: list) -> dict:
    """``|prog - ref| / max(ref, median ref)`` of each leaf of ``keep``: a
    gap of norms, measured against the leaf's reference norm or the median
    leaf's, whichever is larger."""
    med = statistics.median(ref[k] for k in keep)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in keep}


class Driver:
    kind = "train"

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, device
        t = cell.traffic
        self.batch, self.seq = t["batch"], t["seq_len"]
        self.family = load_module("families", cell.model["family"])
        self.kernels = list(self.family.train_launches(cell.model, self.batch, self.seq))
        self.window = None
        self.losses: list = []

    # ------------------------------------------------------------------
    def setup(self) -> None:
        from repro_torch.train import AdamWConfig, TrainConfig, init_train_state, make_train_step

        t = self.cell.traffic
        torch.use_deterministic_algorithms(True)
        cfg, self.model, params, self.specs = program.build(self.cell.config, self.seed,
                                                            self.device)
        tcfg = TrainConfig(optimizer=AdamWConfig(**t["optimizer"]), n_micro=t["n_micro"])
        self.state = init_train_state(params, tcfg)
        self.step_fn = make_train_step(self.model.train_loss, tcfg)
        self.feed = Feed(t["data"], cfg.vocab_size, self.batch, self.seq, self.seed, self.device)
        for i in range(t["check_steps"]):
            self._step()
            if i == 0:
                # the signs of the first gradient as the optimizer got it
                # (``mu / (1 - b1)``), kept on the host (int8)
                self.sign1 = {n: torch.sign(m).to(torch.int8).cpu()
                              for n, m in self.state.opt_state["mu"].items()}
        start = weights_lib.draw(self.specs, self.cell.config["init"], self.seed, self.device)
        now = dict(self.state.params.named_parameters())
        self.change = _leaf_norms(now, lambda n: now[n].detach().float() - start[n].float())
        del start, now

    def _step(self) -> dict:
        s = self.state
        s.params, s.opt_state, s.comp_state, m = self.step_fn(
            s.params, s.opt_state, s.comp_state, self.feed.next(), None)
        return m

    # ------------------------------------------------------------------
    def measure(self, seconds: float, tracer) -> None:
        tokens = self.batch * self.seq
        win = self.window = Window(seconds)
        win.start()
        i = 0
        while True:
            tracer.before_unit()
            t0 = win.unit_start()
            self.losses.append(float(self._step()["loss"]))   # the step's end on the device
            tracer.after_unit(i)
            i += 1
            if win.unit_end(t0, tokens):
                break

    def release(self) -> None:
        del self.state, self.step_fn, self.model, self.feed
        gc.collect()
        torch.use_deterministic_algorithms(False)
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------------
    @property
    def attempted(self) -> int:
        return len(self.losses)

    @property
    def failed(self) -> int:
        return sum(1 for x in self.losses if x != x or abs(x) == float("inf"))

    def end_to_end(self) -> dict:
        return {"train_tokens_per_s": self.window.rate()}

    def layer_context(self, tracer) -> dict:
        m = self.cell.model
        step_flops = self.family.train_flops(m, self.batch, self.seq)
        launches = {k: [(s, n * tracer.units) for s, n in v]
                    for k, v in self.family.train_launches(m, self.batch, self.seq).items()}
        return {"kind": "train", "launches": launches, "traced_flops": step_flops * tracer.units,
                "spans": {}}

    def check(self) -> dict:
        """The numbers the cell's limits compare (``readings``), against the
        reference's first steps from the same weights and batches, drawn
        again."""
        ref = ref_train.train_steps(*reference_inputs(self.cell, self.seed, self.device,
                                                      self.specs))
        return readings({"sign1": self.sign1, "change": self.change}, ref)


def reference_inputs(cell, seed: int, device, specs) -> tuple:
    """``(family, weights, model, batches, optimizer)``: the reference's
    arguments for the first steps of ``seed``, drawn again from it."""
    t = cell.traffic
    weights = weights_lib.draw(specs, cell.config["init"], seed, device)
    feed = Feed(t["data"], cell.model["vocab_size"], t["batch"], t["seq_len"], seed, device)
    batches = [(b["tokens"], b["labels"]) for b in (feed.next() for _ in range(t["check_steps"]))]
    return (load_module("reference", cell.model["family"]), weights, cell.model, batches,
            t["optimizer"])


# Elements whose reference magnitude is at or under this quantile of their
# leaf's are left out of the sign flips: bfloat16 rounding flips the
# elements near zero, a coarser precision or a wrong batch large ones too.
LARGE_QUANTILE = 0.5


def kept_leaves(ref: dict) -> list:
    """The leaves the numbers read: those whose reference gradient's norm is
    a thousandth of the median leaf's or more (round-off alone moves the
    others under Adam)."""
    norms = {n: float(torch.linalg.vector_norm(g)) for n, g in ref["grad1"].items()}
    med = statistics.median(norms.values())
    return [n for n, g in norms.items() if g >= 1e-3 * med]


def sign_flips(sign1: dict, grad1: dict, keep: list, quantile: float | None) -> tuple:
    """``(flips, elements)``: of the elements of ``keep`` whose reference
    gradient's magnitude (``grad1``) is above its leaf's ``quantile`` (all
    of them for None), those whose sign in ``sign1`` differs."""
    flips = total = 0
    for k in keep:
        g = grad1[k].flatten()
        a = g.abs()
        if quantile is None:
            mask = torch.ones_like(a, dtype=torch.bool)
        else:
            mask = a > a.kthvalue(max(1, int(quantile * a.numel()))).values
        s = sign1[k].flatten().to(g.device)
        flips += int((s[mask] != torch.sign(g[mask]).to(s.dtype)).sum())
        total += int(mask.sum())
    return flips, total


def readings(run: dict, ref: dict) -> dict:
    """``{name: (value, detail)}``, the numbers the cell's limits compare:
    ``large_sign_flips``, the share of the first gradient's elements whose
    sign differs from the reference's, among those whose reference
    magnitude is above their leaf's median (first order in each element's
    error, where a gap of norms is second order in random errors); and
    ``change_median_leaf``, the median leaf's gap of the change's norm after
    the steps.  ``run``: the first gradient's signs (``sign1``, int8) and
    each leaf's change's norm (``change``)."""
    keep = kept_leaves(ref)
    flips, total = sign_flips(run["sign1"], ref["grad1"], keep, LARGE_QUANTILE)
    change = leaf_gaps(run["change"], ref["change"], keep)
    return {"large_sign_flips": (flips / total, f"of {total} elements"),
            "change_median_leaf": (statistics.median(change.values()), "")}
