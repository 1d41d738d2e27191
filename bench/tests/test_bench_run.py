"""Whole runs of the harness on the CPU at a tiny size (the look for a GPU
skipped; the port's plain versions stand in for its kernels): a sound run
is correct, a run with the timed path broken underneath is not, the result
line has the contract's keys, and without a GPU nothing is measured."""

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from bench.harness.cell import ROOT
from bench.harness.main import execute
from bench.tests import tiny
from bench.tests.tiny import tiny_cell

SEED = 2_400_000_017          # above 2**31: the driver's seeds are large
TRAIN, QWEN, ZAMBA = "zamba2-1.2b.train-8k", "qwen2-7b.docqa-8k", "zamba2-1.2b.docqa-8k"


def run(workload, seed=SEED, **traffic):
    return execute(tiny_cell(workload, **traffic), seed, 0.3, False, "cpu",
                   time.perf_counter())


@pytest.mark.parametrize("workload", [TRAIN, QWEN, ZAMBA])
def test_a_sound_run_is_correct(workload):
    r = run(workload)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0


@pytest.mark.parametrize("workload", [TRAIN, QWEN])
def test_the_line_has_the_contracts_keys(workload):
    r = run(workload)
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(r["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    names = {m["name"] for m in tiny_cell(workload).end_to_end}
    assert {"setup_s", "peak_memory_gb"} <= names
    assert set(r["metrics"]) == names
    assert all(set(v) == {"value", "unit"} for v in r["metrics"].values())
    assert all(set(c) == {"value", "limit", "at"} for c in r["checks"].values())
    json.dumps(r)


def test_the_same_seed_gives_the_same_inputs():
    from bench.drivers.closed_waves import Requests
    from bench.drivers.train import Feed
    from bench.harness import program
    from bench.harness import weights as weights_lib

    cell = tiny_cell(QWEN)
    blocks = [[Requests(cell.traffic, 256, seed).block() for _ in range(3)]
              for seed in (SEED, SEED, SEED + 1)]
    assert all(np.array_equal(a, b) for x, y in zip(blocks[0], blocks[1]) for a, b in zip(x, y))
    assert not all(np.array_equal(a, b) for x, y in zip(blocks[0], blocks[2])
                   for a, b in zip(x, y))
    # every seed asks for the same prompt lengths, in its own order
    assert sorted(map(len, blocks[0][0])) == sorted(map(len, blocks[2][0]))
    _, _, _, specs = program.build(cell.config, SEED, "cpu")
    w = [weights_lib.draw(specs, cell.config["init"], s, "cpu") for s in (SEED, SEED, SEED + 1)]
    assert all(torch.equal(w[0][n], w[1][n]) for n in w[0])
    assert not torch.equal(w[0]["lm_head.w"], w[2]["lm_head.w"])
    t = tiny_cell(TRAIN).traffic
    feeds = [Feed(t["data"], 256, t["batch"], t["seq_len"], SEED, "cpu") for _ in range(2)]
    a, b = feeds[0].next(), feeds[1].next()
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], feeds[0].next()["tokens"])   # every step's rows differ


def test_a_step_that_leaves_the_state_unchanged_is_not_correct(monkeypatch):
    from repro_torch.train import trainer

    monkeypatch.setattr(trainer, "adamw_update",
                        lambda cfg, params, grads, state: (params, state, {
                            "lr": torch.zeros(()), "grad_norm": torch.zeros(())}))
    r = run(TRAIN)
    assert not r["correct"]
    assert r["checks"]["change_median_leaf"]["value"] > r["checks"]["change_median_leaf"]["limit"]


def test_half_the_batch_left_out_is_not_correct(monkeypatch):
    import repro_torch.train as train_pkg

    make = train_pkg.make_train_step

    def halved(loss_fn, cfg):
        def half_loss(params, batch):
            return loss_fn(params, {k: v[: v.shape[0] // 2] for k, v in batch.items()})
        return make(half_loss, cfg)

    monkeypatch.setattr(train_pkg, "make_train_step", halved)
    assert not run(TRAIN)["correct"]


@pytest.mark.parametrize("workload", [QWEN, ZAMBA])
def test_a_token_altered_where_it_is_produced_is_not_correct(monkeypatch, workload):
    from repro_torch.serving import engine

    sample = engine.ServingEngine._sample
    calls = {"n": 0}

    def altered(self, logits, temps):
        out = sample(self, logits, temps)
        calls["n"] += 1
        if calls["n"] % 3 == 2:         # one step in three serves a wrong token
            out = (out + 1) % logits.shape[-1]
        return out

    monkeypatch.setattr(engine.ServingEngine, "_sample", altered)
    r = run(workload)
    assert not r["correct"], r["checks"]


def test_the_control_reads_above_the_program():
    """The float8 control put in the program's place, and half the batch
    left out in it, come out not correct under the harness's own comparison
    and this size's limits, where the program on the same seed is correct
    (at the cells' size the control's readings set the limits: PERF.md)."""
    from bench.controls import control

    out = control.train_control(tiny_cell(TRAIN), SEED, "cpu", faults=("half_batch",))
    assert out["program"]["correct"], out["program"]
    for name in ("control", "half_batch"):
        assert not out[name]["correct"], out[name]
        assert out[name]["checks"]["large_sign_flips"] > tiny.LIMITS["train"]["large_sign_flips"]


@pytest.mark.parametrize("workload", [QWEN, ZAMBA])
def test_the_serving_control_reads_above_the_program(workload):
    """The float8 control, read at each served position by the gap of the
    token it puts first, comes out not correct under the harness's own
    comparison and this size's limits, where the program's tokens on the
    same requests are correct."""
    from bench.controls import control

    out = control.serve_control(tiny_cell(workload, check_requests=8, new_tokens=6), SEED,
                                "cpu", 0.5)
    assert out["requests"] >= 4
    assert out["program"]["correct"], out["program"]
    assert not out["control"]["correct"], out["control"]


def test_a_measuring_run_without_a_gpu_fails(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "bench/run.py", "--workload", QWEN, "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible to this process")
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_without_the_program_the_harness_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "bench/run.py", "--workload", QWEN, "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
