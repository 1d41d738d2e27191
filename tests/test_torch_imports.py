"""The port stands alone: no JAX, nothing of ``repro``, no build on import,
and no silent CPU run when a GPU was asked for."""

import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"
]
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b(?!_)|from\s+repro(\.|\s))",
    re.MULTILINE,
)


def test_port_has_the_expected_modules():
    names = {p.relative_to(ROOT / "src" / "repro_torch").as_posix() for p in PORT_FILES[:-1]}
    for expected in (
        "core/graph.py", "core/cost_models.py", "core/mcop.py", "core/pricing.py",
        "core/baselines.py", "core/placement_cache.py", "core/adaptive.py",
        "core/session_batch.py", "kernels/mcop_phase.py", "kernels/build.py",
        "obs/trace.py", "obs/metrics.py", "service/broker.py",
        "service/session.py", "service/workload.py", "service/scheduler.py",
        "service/faults.py", "service/resilience.py", "convert.py",
    ):
        assert expected in names


@pytest.mark.parametrize(
    "path", PORT_FILES, ids=lambda p: p.relative_to(ROOT).as_posix()
)
def test_no_jax_and_no_repro_import(path):
    hit = FORBIDDEN.search(path.read_text())
    assert hit is None, f"{path}: forbidden import {hit.group(0).strip()!r}"


def test_kernel_sources_are_in_the_tree():
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    assert (csrc / "mcop_sw.cu").is_file()
    assert (csrc / "mcop_fused.cu").is_file()
    assert (csrc / "sw_common.cuh").is_file()


def test_import_and_cpu_solve_do_not_build_or_load_jax(tmp_path):
    """In a fresh interpreter: importing every port module and solving on
    the CPU through the kernel-backed backends never reaches the build
    (no compiler looked for, no library loaded) and pulls in neither jax
    nor repro."""
    code = """
import sys
import repro_torch.core, repro_torch.kernels, repro_torch.obs, repro_torch.service
import repro_torch.convert
from repro_torch.kernels import build
def refuse(*a, **k):
    raise AssertionError("the build was reached on the CPU")
build.load = build.build_all = build.nvcc_path = build._start = refuse
from repro_torch.core import (mcop_batch, solve_envs, paper_example_graph,
                              AppProfile, ResponseTimeModel, Environment)
g = paper_example_graph()
for backend in ("torch", "cuda"):
    assert mcop_batch([g], backend=backend, device="cpu")[0].min_cut == 22.0
p = AppProfile.from_wcg_times(g)
r = solve_envs(p, ResponseTimeModel(), [Environment.symmetric(1.0, 3.0)],
               backend="cuda_fused", device="cpu")
assert r[0].local_mask.shape == (6,)
assert build._LIBS == {}
assert "jax" not in sys.modules and "repro" not in sys.modules
print("ok")
"""
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
    assert not list(tmp_path.iterdir())


def test_default_build_dir_is_inside_the_tree_and_ignored():
    from repro_torch.kernels import build

    assert build.build_dir() == ROOT / "build" / "repro_torch"
    assert "build/" in (ROOT / ".gitignore").read_text().split()


ENTRIES = ["mcop_batch", "solve_envs", "mcop", "price_summary",
           "tick_sessions", "controller", "broker", "resilient_broker"]

_NO_GPU_CODE = """
import json
import numpy as np
import repro_torch.core as T
from repro_torch.service import (BrokerSession, CircuitBreaker, OffloadBroker,
                                 ResiliencePolicy)

g = T.paper_example_graph()
p = T.AppProfile.from_wcg_times(g)
env = T.Environment.symmetric(1.0, 3.0)
model = T.ResponseTimeModel()

def tick_sessions():
    batch = T.SessionBatch.create(2, 6)
    batch.activate(np.array([0, 1]))
    T.tick_sessions(batch, T.EnvArrays.from_envs([env, env]), profile=p,
                    model=model, cache=T.PlacementCache())

def broker(**kw):
    b = OffloadBroker(**kw)
    b.register("app", p, model)
    BrokerSession(b, "app").observe(env)
    b.tick()

runs = {
    "mcop_batch": lambda: T.mcop_batch([g]),
    "solve_envs": lambda: T.solve_envs(p, model, [env]),
    "mcop": lambda: T.mcop(g, backend="cuda"),
    "price_summary": lambda: T.device_price_summary(
        p, model, [env], np.ones((1, 6), bool)),
    "tick_sessions": tick_sessions,
    "controller": lambda: T.AdaptiveController(p, model, backend="cuda").observe(env),
    "broker": broker,
    "resilient_broker": lambda: broker(
        resilience=ResiliencePolicy(breaker=CircuitBreaker())),
}
out = {}
for name, run in runs.items():
    try:
        run()
        out[name] = "returned"
    except BaseException as err:
        out[name] = [c.__name__ for c in type(err).__mro__]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def raised_without_a_gpu(tmp_path_factory):
    """What each entry point does at its default device in an interpreter
    that sees no GPU (any GPU of this machine is hidden from it)."""
    import json

    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "-c", _NO_GPU_CODE], env=env,
                         cwd=tmp_path_factory.mktemp("nogpu"),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("entry", ENTRIES)
def test_device_cuda_raises_without_a_gpu(raised_without_a_gpu, entry):
    """The default device is the GPU; without one the entry points raise
    KernelError (a RuntimeError) — they never fall back to the CPU, not
    even a broker whose resilience policy degrades other failures."""
    assert raised_without_a_gpu[entry][:2] == ["KernelError", "RuntimeError"]


def test_mesh_is_single_device_only():
    import repro_torch.core as T
    from repro_torch.service import OffloadBroker

    g = T.paper_example_graph()
    assert T.mcop_batch([g], backend="torch", device="cpu", mesh=None)[0].min_cut == 22.0
    assert T.mcop_batch([g], backend="torch", device="cpu", mesh=False)[0].min_cut == 22.0
    with pytest.raises(NotImplementedError):
        T.mcop_batch([g], backend="torch", device="cpu", mesh=object())
    with pytest.raises(NotImplementedError):
        OffloadBroker(backend="torch", device="cpu", mesh=object())


def test_backend_names():
    import repro_torch.core as T
    from repro_torch.service import BACKEND_ESCALATION, OffloadBroker

    assert BACKEND_ESCALATION == ("cuda", "torch", "reference")
    for bad in ("jax", "pallas", "cuda_fused"):
        with pytest.raises(ValueError):
            OffloadBroker(backend=bad, device="cpu")
    for bad in ("jax", "pallas", "pallas_fused"):
        with pytest.raises(ValueError):
            T.mcop_batch([T.paper_example_graph()], backend=bad, device="cpu")
