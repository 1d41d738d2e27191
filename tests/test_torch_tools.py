"""The port's tools (``tools/torch_chaos_trace.py``,
``tools/torch_ipc_smoke.py``) against the JAX package's, on the CPU.

* The chaos trace: the JSONL ``==`` the JAX tool's at the same arguments,
  span for span, once the attributes that name a backend are mapped
  (``docs/PORT.md``); the metrics snapshot and the summary line ``==``;
  ``tools/tracequery.py --json`` of the two files ``==`` and ``--audit``
  rc 0.
* The cross-process smoke in real processes: rc 0, ``tracequery --audit``
  and ``wire_journal --verify`` rc 0, every staged tick reported, and no
  process left behind; with one client, the worker's reports ``==`` a JAX
  in-process batch group fed by the same traffic; without a GPU at the
  default device, a failure with no process left behind.
"""

import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT = 180
BACKENDS = {"jax": "torch", "pallas": "cuda", "pallas_fused": "cuda_fused"}

pytestmark = pytest.mark.service


def load(rel: str):
    spec = importlib.util.spec_from_file_location(
        "script_" + rel.replace("/", "_")[:-3], ROOT / rel)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def port_backends(doc):
    """``doc`` with every ``"backend"`` value named as the port names it."""
    if isinstance(doc, dict):
        return {k: (BACKENDS.get(v, v) if k == "backend" else port_backends(v))
                for k, v in doc.items()}
    if isinstance(doc, list):
        return [port_backends(v) for v in doc]
    return doc


def tool(*args, env=None) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, *map(str, args)], capture_output=True, text=True,
                          timeout=TIMEOUT, cwd=ROOT, env=env)


STORMS = {
    "small": ["--steps", "6", "--users", "8"],
    "degraded": ["--steps", "6", "--users", "8", "--retries", "0", "--rate", "0.3"],
    "calm": ["--steps", "6", "--users", "8", "--rate", "0"],
}


@pytest.mark.parametrize("storm", STORMS)
def test_chaos_trace_equals_the_jax_tools(tmp_path, capsys, storm):
    runs = {}
    for name, rel, extra in (("jax", "tools/chaos_trace.py", []),
                             ("port", "tools/torch_chaos_trace.py", ["--device", "cpu"])):
        out = tmp_path / f"{name}.jsonl"
        metrics = tmp_path / f"{name}.metrics.json"
        capsys.readouterr()
        assert load(rel).main(["--out", str(out), "--metrics-out", str(metrics),
                               *STORMS[storm], *extra]) == 0
        line = capsys.readouterr().out.strip()
        runs[name] = (out, json.loads(metrics.read_text()), line)
    (jax_out, jax_metrics, jax_line), (port_out, port_metrics, port_line) = runs.values()
    want = [port_backends(json.loads(s)) for s in jax_out.read_text().splitlines()]
    got = [json.loads(s) for s in port_out.read_text().splitlines()]
    assert got == want and len(got) > 20
    assert port_metrics == port_backends(jax_metrics)
    assert port_line == jax_line.replace(str(jax_out), str(port_out))
    if storm == "degraded":
        assert " degraded=0 " not in port_line
    if storm == "calm":
        assert " faults=0 " in port_line
    else:
        assert " faults=0 " not in port_line

    summaries = [tool("tools/tracequery.py", "--json", path) for path in (jax_out, port_out)]
    assert all(s.returncode == 0 for s in summaries)
    assert json.loads(summaries[1].stdout) == json.loads(summaries[0].stdout)
    audit = tool("tools/tracequery.py", "--audit", port_out)
    assert audit.returncode == 0, audit.stdout + audit.stderr


def processes_naming(text: str) -> list[str]:
    """Command lines of living processes that name ``text`` (a run's own
    directory), from Linux ``/proc``."""
    left = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            cmd = pathlib.Path(f"/proc/{pid}/cmdline").read_bytes().replace(b"\0", b" ")
        except OSError:
            continue
        if text.encode() in cmd:
            left.append(f"{pid}: {cmd.decode(errors='replace')}")
    return left


def ipc_smoke(out: pathlib.Path, *args, env=None) -> subprocess.CompletedProcess:
    run = tool("tools/torch_ipc_smoke.py", "--dir", out, *args,
               env=env or dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert processes_naming(str(out)) == []
    return run


def test_ipc_smoke_two_clients(tmp_path):
    out = tmp_path / "smoke"
    run = ipc_smoke(out, "--users", "64", "--clients", "2", "--ticks", "3", "--device", "cpu")
    assert run.returncode == 0, run.stdout + run.stderr
    assert "SMOKE ok clients=2 users=64 ticks=3 " in run.stdout
    assert sum(line.startswith("WORKER smoke") and " ok " in line
               for line in run.stdout.splitlines()) == 2
    for name in ("smoke0", "smoke1"):
        reports = json.loads((out / f"{name}.reports.json").read_text())
        assert len(reports) == 3 and all(r["type"] == "batch_report" for r in reports)
    assert sum(r["solved"] for name in ("smoke0", "smoke1")
               for r in json.loads((out / f"{name}.reports.json").read_text())) > 0
    audit = tool("tools/tracequery.py", "--audit", out / "ipc_trace.jsonl")
    assert audit.returncode == 0, audit.stdout + audit.stderr
    verify = tool("tools/wire_journal.py", "--verify", out / "journal.jsonl",
                  "--snapshot-dir", out / "snaps")
    assert verify.returncode == 0, verify.stdout + verify.stderr
    assert (out / "ipc_trace.json").stat().st_size > 0


def test_ipc_smoke_one_client_equals_a_jax_batch_group(tmp_path):
    """One worker alone: its per-tick reports equal, field for field but
    the group's id, a JAX in-process batch group of the same size fed the
    same seeded traffic against the same demo tenant."""
    import repro.core as J
    import repro.service as JS
    from repro_torch.service.server import batch_report_frame

    users, ticks, nodes, seed = 48, 4, 12, 0
    out = tmp_path / "smoke"
    run = ipc_smoke(out, "--users", users, "--clients", 1, "--ticks", ticks,
                    "--nodes", nodes, "--seed", seed, "--device", "cpu")
    assert run.returncode == 0, run.stdout + run.stderr
    got = json.loads((out / "smoke0.reports.json").read_text())

    broker = JS.OffloadBroker(backend="jax")
    broker.register("app", J.AppProfile.from_wcg_times(
        J.random_wcg(nodes, rng=np.random.default_rng(seed))), J.ResponseTimeModel())
    group = broker.register_batch("app", users)
    gen = JS.TrafficGenerator(users, seed=100)
    want = []
    for _ in range(ticks):
        t = gen.step()
        group.observe(t.envs, arrived=np.nonzero(t.arrived)[0],
                      departed=np.nonzero(t.departed)[0])
        broker.tick()
        want.extend(batch_report_frame(got[0]["group"], r) for r in group.drain())
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert sum(r["solved"] for r in got) > 0 and got[-1]["active"] > 0


def test_ipc_smoke_without_a_gpu_fails_and_leaves_nothing(tmp_path):
    """The default device is the GPU: without one the server raises before
    READY, the smoke exits 1, and no process it started is left."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    run = ipc_smoke(tmp_path / "smoke", "--users", "8", "--clients", "2", "--ticks", "1",
                    env=env)
    assert run.returncode == 1
    assert "SMOKE FAIL: server exited before READY" in run.stderr
    assert "KernelError" in run.stderr
