"""The port stands alone: no JAX, nothing of ``repro``, no build on import,
and no silent CPU run when a GPU was asked for."""

import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
# the smoke, and every example and tool of the port
PORT_FILES = SRC_FILES + [ROOT / "chip_smoke.py"] + sorted(
    (ROOT / "examples").glob("torch_*.py")) + sorted((ROOT / "tools").glob("torch_*.py"))
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b(?!_)|from\s+repro(\.|\s))",
    re.MULTILINE,
)


def test_port_has_the_expected_modules():
    names = {p.relative_to(ROOT / "src" / "repro_torch").as_posix() for p in SRC_FILES}
    for expected in (
        "core/graph.py", "core/cost_models.py", "core/mcop.py", "core/pricing.py",
        "core/baselines.py", "core/placement_cache.py", "core/adaptive.py",
        "core/session_batch.py", "kernels/mcop_phase.py", "kernels/build.py",
        "obs/trace.py", "obs/metrics.py", "service/broker.py",
        "service/session.py", "service/workload.py", "service/scheduler.py",
        "service/faults.py", "service/resilience.py", "convert.py",
        "configs/base.py", "configs/__init__.py", "configs/zamba2_1p2b.py",
        "models/common.py", "models/attention.py", "models/ffn.py", "models/ssm.py",
        "models/transformer.py", "kernels/ref.py", "kernels/ops.py",
        "kernels/flash_attention.py", "kernels/mamba_scan.py", "core/placement.py",
        "profilers/program.py", "serving/engine.py", "launch/serve.py",
        "service/wire.py", "service/server.py", "service/client.py",
        "launch/serve_broker.py", "core/mcop_shard.py", "launch/mesh.py",
        "runtime/__init__.py", "runtime/sharding.py", "runtime/elastic.py",
        "profilers/network.py", "profilers/energy.py", "configs/deepseek_v2_236b.py",
        "configs/qwen2_vl_72b.py", "configs/seamless_m4t_large_v2.py", "configs/xlstm_1p3b.py",
        "train/optimizer.py", "train/trainer.py", "data/pipeline.py", "checkpoint/store.py",
        "runtime/compression.py", "launch/train.py", "runtime/pipeline.py",
        "launch/specs.py", "launch/dryrun.py", "kernels/traced.py", "obs/collectives.py",
    ):
        assert expected in names


@pytest.mark.parametrize(
    "path", PORT_FILES, ids=lambda p: p.relative_to(ROOT).as_posix()
)
def test_no_jax_and_no_repro_import(path):
    hit = FORBIDDEN.search(path.read_text())
    assert hit is None, f"{path}: forbidden import {hit.group(0).strip()!r}"


def test_every_example_and_tool_of_the_port_is_checked():
    checked = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for rel in ("examples/torch_quickstart.py", "examples/torch_adaptive_offload.py",
                "examples/torch_serve_lm.py", "examples/torch_train_lm.py",
                "tools/torch_chaos_trace.py", "tools/torch_ipc_smoke.py",
                "tools/torch_kernel_probe.py", "tools/torch_tree_timing.py",
                "tools/torch_dist_ranks.py"):
        assert rel in checked


def test_kernel_sources_are_in_the_tree():
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    assert (csrc / "mcop_sw.cu").is_file()
    assert (csrc / "mcop_fused.cu").is_file()
    assert (csrc / "sw_common.cuh").is_file()
    assert (csrc / "flash_attention.cu").is_file()
    assert (csrc / "mamba_scan.cu").is_file()
    assert (csrc / "mcop_phase.cu").is_file()
    assert (csrc / "flash_attention_bwd.cu").is_file()
    assert (csrc / "mamba_scan_bwd.cu").is_file()
    from repro_torch.kernels import build

    for name in build.KERNEL_SOURCES:
        assert (csrc / f"{name}.cu").is_file()
    assert {"flash_attention", "mamba_scan", "mcop_phase", "flash_attention_bwd",
            "mamba_scan_bwd"} <= set(build.KERNEL_SOURCES)


def test_import_and_cpu_solve_do_not_build_or_load_jax(tmp_path):
    """In a fresh interpreter: importing every port module and solving on
    the CPU through the kernel-backed backends never reaches the build
    (no compiler looked for, no library loaded) and pulls in neither jax
    nor repro."""
    code = """
import sys
import repro_torch.core, repro_torch.kernels, repro_torch.obs, repro_torch.service
import repro_torch.convert, repro_torch.configs, repro_torch.models.transformer
import repro_torch.serving, repro_torch.launch.serve, repro_torch.profilers
import repro_torch.core.placement, repro_torch.launch.serve_broker
import repro_torch.core.mcop_shard, repro_torch.launch.mesh, repro_torch.runtime
import repro_torch.train, repro_torch.data, repro_torch.checkpoint, repro_torch.launch.train
import repro_torch.runtime.pipeline, repro_torch.launch.specs, repro_torch.launch.dryrun
from repro_torch.kernels import build
def refuse(*a, **k):
    raise AssertionError("the build was reached on the CPU")
build.load = build.build_all = build.nvcc_path = build._start = refuse
from repro_torch.core import (mcop_batch, solve_envs, paper_example_graph,
                              AppProfile, ResponseTimeModel, Environment)
g = paper_example_graph()
for backend in ("torch", "cuda"):
    assert mcop_batch([g], backend=backend, device="cpu")[0].min_cut == 22.0
from repro_torch.kernels import mcop_min_cut
assert mcop_min_cut(g.adj, g.w_local, g.w_cloud, g.offloadable, device="cpu")[0] == 22.0
p = AppProfile.from_wcg_times(g)
r = solve_envs(p, ResponseTimeModel(), [Environment.symmetric(1.0, 3.0)],
               backend="cuda_fused", device="cpu")
assert r[0].local_mask.shape == (6,)
import torch
from repro_torch.configs import get_config, reduce_config
from repro_torch.kernels import ops
from repro_torch.models.transformer import Model
x = torch.randn(1, 8, 2, 4)
assert ops.flash_attention(x, x, x, window=3).shape == (1, 8, 2, 4)
dt = torch.rand(1, 8, 2)
y, h = ops.mamba_chunk_scan(x, dt, -dt, x[:, :, 0], x[:, :, 1], torch.zeros(1, 2, 4, 4),
                            chunk=4)
assert y.shape == (1, 8, 2, 4) and h.shape == (1, 2, 4, 4)
from repro_torch.configs import ARCHITECTURES
q, k, v = torch.randn(1, 8, 2, 24), torch.randn(1, 8, 2, 24), torch.randn(1, 8, 2, 16)
assert ops.flash_attention(q, k, v).shape == (1, 8, 2, 16)
for arch in sorted(ARCHITECTURES):   # every family, through the long-prompt route too
    cfg = reduce_config(get_config(arch))
    m = Model(cfg, device="cpu")
    batch = {"tokens": torch.ones(1, 20, dtype=torch.long)}
    if cfg.frontend != "none":
        key = "patch_embeds" if cfg.frontend == "vision_patches" else "frame_embeds"
        batch[key] = torch.zeros(1, 8, cfg.d_model, dtype=torch.bfloat16)
    params = m.init(0)
    logits, cache = m.prefill(params, batch, m.init_cache(1, 24))
    assert logits.shape == (1, 256) and cache["length"] == 20, arch
    logits, cache = m.decode_step(params, torch.ones(1, 1, dtype=torch.long), cache)
    assert logits.shape == (1, 256) and cache["length"] == 21, arch
    if cfg.family == "hybrid":   # a training step's backward on the CPU: plain versions
        batch["labels"] = torch.ones(1, 20, dtype=torch.long)
        loss, _ = m.train_loss(params, batch)
        loss.backward()
        assert params.mamba[0][0].a_log.grad is not None
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
           "tick_sessions", "controller", "broker", "resilient_broker",
           "model_init", "model_cache", "engine", "serve_main", "placement_batch",
           "min_cut", "serve_broker_main", "serve_broker_reference",
           "solver_mesh", "elastic_manager", "sharded_solve_envs", "model_init_moe",
           "engine_extras", "serve_main_encdec", "train_main", "train_dataset",
           "local_mesh", "production_mesh", "dryrun_cell", "example_quickstart",
           "example_adaptive_offload", "example_serve_lm", "example_train_lm",
           "tool_chaos_trace"]

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

import os, tempfile
from repro_torch.kernels import mcop_min_cut
from repro_torch.launch.serve_broker import main as serve_broker_main
sock = os.path.join(tempfile.mkdtemp(), "s.sock")

from repro_torch.configs import get_config, reduce_config, SHAPES
from repro_torch.core.placement import TPUV5E_TIER, plan_placement_batch
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh, make_solver_mesh
from repro_torch.runtime import ElasticMeshManager
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.train import main as train_main
from repro_torch.data import DataConfig, SyntheticLMDataset
from repro_torch.models.transformer import Model
from repro_torch.profilers import stage_specs
from repro_torch.serving import ServingConfig, ServingEngine
from repro_torch.launch.dryrun import run_cell as dryrun_cell

import importlib.util, sys


def script(rel):  # an example's or tool's main, loaded from the repository
    spec = importlib.util.spec_from_file_location(
        rel.replace("/", "_")[:-3], os.path.join(sys.argv[1], rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main

zamba = reduce_config(get_config("zamba2-1.2b"))
vlm = reduce_config(get_config("qwen2-vl-72b"))

runs = {
    "model_init": lambda: Model(zamba).init(0),
    "model_cache": lambda: Model(zamba).init_cache(1, 8),
    "engine": lambda: ServingEngine(Model(zamba), None, ServingConfig()),
    "serve_main": lambda: serve_main(["--arch", "zamba2-1.2b", "--reduced"]),
    "model_init_moe": lambda: Model(reduce_config(get_config("deepseek-v2-236b"))).init(0),
    "engine_extras": lambda: ServingEngine(Model(vlm), None, ServingConfig(), extras={}),
    "serve_main_encdec": lambda: serve_main(["--arch", "seamless-m4t-large-v2", "--reduced"]),
    "train_main": lambda: train_main(["--arch", "zamba2-1.2b", "--reduced", "--steps", "1"]),
    "train_dataset": lambda: SyntheticLMDataset(DataConfig(8, 2, 256), zamba).batch(0),
    "placement_batch": lambda: plan_placement_batch(
        stage_specs(zamba, SHAPES["decode_32k"]), TPUV5E_TIER, TPUV5E_TIER,
        inter_tier_bws=[1e9]),
    "mcop_batch": lambda: T.mcop_batch([g]),
    "solve_envs": lambda: T.solve_envs(p, model, [env]),
    "mcop": lambda: T.mcop(g, backend="cuda"),
    "price_summary": lambda: T.device_price_summary(
        p, model, [env], np.ones((1, 6), bool)),
    "tick_sessions": tick_sessions,
    "min_cut": lambda: mcop_min_cut(g.adj, g.w_local, g.w_cloud, g.offloadable),
    # every CUDA device this process sees: none
    "solver_mesh": lambda: make_solver_mesh(),
    # the training meshes: no GPU, and no process group either
    "local_mesh": lambda: make_local_mesh(),
    "production_mesh": lambda: make_production_mesh(multi_pod=True),
    # the dry run's fake shards on the default device (its fake world is its own)
    "dryrun_cell": lambda: dryrun_cell("qwen2-7b", "decode_32k", multi_pod=False),
    "elastic_manager": lambda: ElasticMeshManager(
        stage_specs(zamba, SHAPES["decode_32k"]), TPUV5E_TIER, TPUV5E_TIER, backend="cuda"),
    # a fleet of four shards on the default device
    "sharded_solve_envs": lambda: T.solve_envs(
        p, model, [env] * 13, mesh=make_solver_mesh(["cuda"] * 4)),
    "serve_broker_main": lambda: serve_broker_main(["--socket", sock]),
    # the default device is the GPU whatever the backend: never a silent host run
    "serve_broker_reference": lambda: serve_broker_main(
        ["--socket", sock, "--backend", "reference"]),
    # the examples and tools of the port at their default device
    "example_quickstart": lambda: script("examples/torch_quickstart.py")([]),
    "example_adaptive_offload": lambda: script("examples/torch_adaptive_offload.py")([]),
    "example_serve_lm": lambda: script("examples/torch_serve_lm.py")([]),
    "example_train_lm": lambda: script("examples/torch_train_lm.py")(
        ["--steps", "1", "--ckpt-dir", os.path.join(tempfile.mkdtemp(), "ck")]),
    "tool_chaos_trace": lambda: script("tools/torch_chaos_trace.py")(
        ["--out", os.path.join(tempfile.mkdtemp(), "t.jsonl")]),
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
    out = subprocess.run([sys.executable, "-c", _NO_GPU_CODE, str(ROOT)], env=env,
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
    """``mesh=`` has the JAX package's contract (``resolve_mesh``): None and
    False solve on one device here, a one-shard mesh collapses to it, and
    anything that is not a ``SolverMesh`` raises ``TypeError``."""
    import repro_torch.core as T
    from repro_torch.launch.mesh import make_solver_mesh
    from repro_torch.service import OffloadBroker

    g = T.paper_example_graph()
    for mesh in (None, False, make_solver_mesh(["cpu"])):
        assert T.mcop_batch([g], backend="torch", device="cpu", mesh=mesh)[0].min_cut == 22.0
        assert OffloadBroker(backend="torch", device="cpu", mesh=mesh).mesh is None
    with pytest.raises(TypeError):
        T.mcop_batch([g], backend="torch", device="cpu", mesh=object())
    with pytest.raises(TypeError):
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
