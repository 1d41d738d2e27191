"""The plain reference against the port's plain path (its kernels' plain
versions on the CPU), at reduced widths in float32, before it judges the
chip: prefill and decode logits through the port's caches, and a training
step's loss and gradients.  The hybrid case runs past the attention window
(4 096) so that the window, the port's chunked route and its ring cache
are held to the reference too."""

import pytest
import torch

from bench.harness import program
from bench.harness import weights as weights_lib
from bench.harness.cell import BENCH, load_json, load_module
from bench.reference.common import Weights, cross_entropy, logits_at
from bench.tests.tiny import SMALL

CASES = {  # configuration, sequence length, rows
    "hybrid": ("zamba2-1.2b", 40, 2),
    "hybrid-window": ("zamba2-1.2b", 4100, 1),
    "dense": ("qwen2-7b", 40, 2),
}


def f32_config(name: str, **model) -> dict:
    config = load_json(BENCH / "configs" / f"{name}.json")
    config["model"].update(SMALL[config["model"]["family"]], dtype="float32", **model)
    return config


def built(config: dict, seed: int = 5):
    cfg, model, params, specs = program.build(config, seed, "cpu")
    return model, params, weights_lib.draw(specs, config["init"], seed, "cpu")


@pytest.mark.parametrize("case", sorted(CASES))
def test_prefill_and_decode_logits_match_the_reference(case):
    name, s, b = CASES[case]
    config = f32_config(name, n_layers=2) if case == "hybrid-window" else f32_config(name)
    m = config["model"]
    model, params, w = built(config)
    gen = torch.Generator().manual_seed(3)
    steps = 3
    tokens = torch.randint(1, m["vocab_size"], (b, s + steps), generator=gen)
    cache = model.init_cache(b, s + steps + 1)
    logits, cache = model.prefill(params, {"tokens": tokens[:, :s]}, cache)
    got = [logits]
    for j in range(steps):
        logits, cache = model.decode_step(params, tokens[:, s + j:s + j + 1], cache)
        got.append(logits)
    got = torch.stack(got, dim=1)
    family = load_module("reference", m["family"])
    h = family.hidden(Weights(w), tokens[:, :s + steps], m)
    want = logits_at(Weights(w), h, m, torch.arange(s - 1, s + steps))
    assert torch.allclose(got, want, atol=2e-4, rtol=1e-4), float((got - want).abs().max())


@pytest.mark.parametrize("name", ["zamba2-1.2b", "qwen2-7b"])
def test_train_loss_and_gradients_match_the_reference(name):
    config = f32_config(name)
    m = config["model"]
    model, params, w = built(config)
    gen = torch.Generator().manual_seed(4)
    toks = torch.randint(0, m["vocab_size"], (2, 49), generator=gen)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    loss, _ = model.train_loss(params, batch)
    names = [n for n, _ in params.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in params.named_parameters()])
    ref = {n: t.detach().clone().requires_grad_(True) for n, t in w.items()}
    family = load_module("reference", m["family"])
    ref_loss = cross_entropy(logits_at(Weights(ref), family.hidden(Weights(ref), batch["tokens"],
                                                                   m, checkpoint=True), m),
                             batch["labels"])
    ref_loss.backward()
    assert float(loss.detach()) == pytest.approx(float(ref_loss.detach()), rel=1e-5)
    for n, g in zip(names, grads):
        r = ref[n].grad
        err = float(torch.linalg.vector_norm(g - r))
        assert err <= 1e-4 * float(torch.linalg.vector_norm(r)) + 1e-7, (n, err)
