"""The port's examples (``examples/torch_*.py``) against the JAX package's
(``examples/*.py``), both run in this process on the CPU.

* quickstart and adaptive_offload: standard output ``==``, line for line
  (host float64 pricing; placements under the float32 parity contract).
* serve_lm: the command line, the placement report and the count of
  requests and tokens ``==``; the tokens themselves differ by design
  (temperature 0.7, and each package seeds its own weights).
* train_lm: the placement report and the parameter count ``==``, finite
  losses, a checkpoint written, and a second run on the same directory
  resuming from it.
"""

import importlib.util
import math
import pathlib
import re
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


def load(rel: str):
    """A script of the repository as a module (not run as ``__main__``)."""
    spec = importlib.util.spec_from_file_location(
        "script_" + rel.replace("/", "_")[:-3], ROOT / rel)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run(capsys, fn, *args) -> list[str]:
    capsys.readouterr()
    assert fn(*args) in (0, None)
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("name", ["quickstart", "adaptive_offload"])
def test_stdout_equals_the_jax_examples(capsys, name):
    want = run(capsys, load(f"examples/{name}.py").main)
    got = run(capsys, load(f"examples/torch_{name}.py").main, ["--device", "cpu"])
    assert got == want
    assert len(want) > 15


def test_adaptive_offload_solves_and_replays_warm(capsys):
    """The lines the example exists for: repartitions served from the
    cache, the broker's solves, and zero dispatches on the warm restart."""
    out = run(capsys, load("examples/torch_adaptive_offload.py").main, ["--device", "cpu"])
    assert "→ 4/7 observations triggered repartitioning (threshold+cooldown hysteresis)" in out
    broker = next(line for line in out if line.startswith("12 users x 10 ticks"))
    assert re.search(r"→ (\d+) solves in (\d+) dispatches", broker).groups() != ("0", "0")
    assert ("→ restart + warm cache, same day replayed: 0 solver dispatches, "
            "hit rate 100%") in out


def test_serve_lm_reports_as_the_jax_example(capsys):
    want = run(capsys, load("examples/serve_lm.py").main)
    got = run(capsys, load("examples/torch_serve_lm.py").main, ["--device", "cpu"])
    assert got[0] == want[0].replace("python -m repro.launch.serve",
                                     "python -m repro_torch.launch.serve")
    assert got[1] == want[1] and got[1].startswith("[serve] MCOP placement:")
    head = "[serve] 12 requests, 192 tokens in "   # 12 requests of 16 new tokens
    assert want[2].startswith(head) and got[2].startswith(head)
    assert got[2].endswith(" on cpu")
    reqs = [line for line in got if line.startswith("[serve]   req ")]
    assert len(reqs) == 3
    for line in reqs:
        tokens = [int(t) for t in re.search(r"\[([\d, ]+)\]", line).group(1).split(",")]
        assert len(tokens) == 12 and all(0 <= t < 256 for t in tokens)


def _losses(lines: list[str]) -> list[float]:
    return [float(m.group(1)) for line in lines
            if (m := re.match(r"\[train\] step +\d+ loss (\S+) ", line))]


def test_train_lm_reports_as_the_jax_example_and_resumes(capsys, monkeypatch, tmp_path):
    monkeypatch.setattr(sys, "argv", ["train_lm.py", "--steps", "3",
                                      "--ckpt-dir", str(tmp_path / "jax")])
    want = run(capsys, load("examples/train_lm.py").main)
    example = load("examples/torch_train_lm.py")
    ckpt = tmp_path / "port"
    got = run(capsys, example.main, ["--steps", "3", "--ckpt-dir", str(ckpt),
                                     "--device", "cpu"])
    assert got[0] == want[0].replace("python -m repro.launch.train",
                                     "python -m repro_torch.launch.train").replace(
        str(tmp_path / "jax"), str(ckpt))
    placement = [line for line in want if line.startswith("[train] MCOP placement:")]
    assert len(placement) == 1 and placement[0] in got
    params = [line for line in want if re.match(r"\[train\] qwen2-7b: [\d.]+M params$", line)]
    assert params == ["[train] qwen2-7b: 0.1M params"]
    assert params[0] + " on cpu" in got
    losses = _losses(got)
    assert len(losses) == 2 and all(math.isfinite(v) for v in losses)   # steps 0 and 2
    assert got[-1].startswith("[train] done: loss ")
    assert [p.name for p in ckpt.iterdir()] == ["step_000000003"]

    again = run(capsys, example.main, ["--steps", "4", "--ckpt-dir", str(ckpt),
                                       "--device", "cpu"])
    assert "[train] resumed from step 3" in again
    assert [line for line in again if line.startswith("[train] step ")][0].startswith(
        "[train] step     3 loss ")
    assert all(math.isfinite(v) for v in _losses(again))
    assert sorted(p.name for p in ckpt.iterdir()) == ["step_000000003", "step_000000004"]


def test_train_lm_states_the_model_it_trains():
    """The docstring names what ``--reduced`` builds (about 0.1M
    parameters), not the JAX example's "~100M"."""
    doc = " ".join(load("examples/torch_train_lm.py").__doc__.split())
    assert "0.1M parameters" in doc and "100M" not in doc
