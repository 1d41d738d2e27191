"""The port's serving plane across a process boundary.

* Either package's client against either package's server (servers in a
  thread, ``backend="reference"``, ``device="cpu"``): submits, per-user
  sessions, a batch session group and telemetry over the wire give replies,
  events, tick and batch reports ``==`` those of an in-process ``repro``
  broker fed the same inputs.
* ``python -m repro_torch.launch.serve_broker --device cpu --backend
  reference`` in real subprocesses over unix sockets: a solver SIGKILLed
  mid-tick and restarted on its journal and snapshots answers ``==`` the
  uninterrupted run, and resubmission never double-counts.  Every read is
  timeout-bounded, so a hang is a failure, not a stall.
* An LLM stage-graph tenant (qwen2-7b's stages) over the port's wire:
  replies ``==`` an in-process ``repro`` broker's.
"""

import dataclasses
import json
import os
import pathlib
import signal
import socket
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import repro.core as J
import repro.service as JS
import repro_torch.core as T
import repro_torch.service as TS
from repro_torch.launch.serve_broker import demo_tenant
from repro_torch.service.server import batch_report_frame, tick_report_frame
from repro_torch.service.wire import PROTOCOL_VERSION, FrameStream, env_to_wire

from _torch_parity import event_key, profile_pair

pytestmark = pytest.mark.service

REPO = pathlib.Path(__file__).resolve().parent.parent
TIMEOUT = 30.0
NODES, SEED = 12, 0
PACKAGES = {"repro": (J, JS), "port": (T, TS)}


def _same(a, b) -> bool:
    """Equal as the wire carries them: every float to the bit (NaN too)."""
    return json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


def _sig(reply) -> tuple:
    """Bit-exact signature of a BrokerReply — ``==`` means identical."""
    res = reply.result
    return (
        None if res is None else (struct.pack("<d", res.min_cut),
                                  np.asarray(res.local_mask, bool).tobytes()),
        reply.cache_hit, reply.coalesced, reply.tick, reply.rejected,
        reply.degraded, reply.timed_out,
    )


def _tenants():
    """The demo tenant in both packages, bit-identical arrays."""
    pj = J.AppProfile.from_wcg_times(J.random_wcg(NODES, rng=np.random.default_rng(SEED)))
    pt = profile_pair(pj)
    port_demo, _ = demo_tenant(NODES, SEED)
    assert np.array_equal(pt.t_local, port_demo.t_local)
    return {"repro": (pj, J.ResponseTimeModel()), "port": (pt, T.ResponseTimeModel())}


def _env_in(core, env):
    return core.Environment(**{f: getattr(env, f) for f in J.EnvArrays._fields})


def _drive(core, svc, broker_like, tick, group, *, ticks=8, users=4):
    """The same serving workload against an in-process broker or a client:
    one raw submit, ``users`` sessions and one batch-group observation per
    tick.  Returns every reply, event, tick report and batch report as
    plain comparable values."""
    trace = JS.environment_trace(ticks, seed=5)
    walks = JS.user_traces(users, ticks, seed=2)
    traffic = JS.TrafficGenerator(24, seed=3, arrival_rate=2.0, churn=0.1, initial=16)
    sessions = [svc.BrokerSession(broker_like, "app", threshold=0.15, min_interval=2)
                for _ in range(users)]
    out = {"replies": [], "events": [], "ticks": [], "batch": []}
    for i in range(ticks):
        fut = broker_like.submit("app", _env_in(core, trace[i]))
        for sess, walk in zip(sessions, walks):
            sess.observe(_env_in(core, walk[i]))
        tk = traffic.step()
        # slots as indices: the reference client sends a bool mask as 0/1
        group.observe(tk.envs, arrived=np.flatnonzero(tk.arrived),
                      departed=np.flatnonzero(tk.departed))
        out["ticks"].append(tick())
        assert fut.done
        out["replies"].append(_sig(fut.result))
        for sess in sessions:
            out["events"].extend(event_key(e) for e in sess.drain())
        out["batch"].extend(group.drain())
    return out


class _EnvSubmits:
    """An in-process broker fed what a client sends: a session's solve
    arrives as its environment (``submit``), not as the graph it built
    (``submit_graph`` builds nothing at the tick, so a mixed bin may price
    in another order)."""

    def __init__(self, broker):
        self.broker = broker
        self.backend = broker.backend
        self.tenant = broker.tenant
        self.submit = broker.submit

    def submit_graph(self, name, g, env):
        return self.broker.submit(name, env)


def _in_process_repro(tenant):
    broker = JS.OffloadBroker(backend="reference", clock=lambda: 0.0)
    broker.register("app", *tenant)
    group = broker.register_batch("app", 24, threshold=0.15, min_interval=2)
    out = _drive(J, JS, _EnvSubmits(broker), lambda: tick_report_frame(broker.tick()),
                 group)
    out["batch"] = [batch_report_frame("app#1", r) for r in out["batch"]]
    caches = {"app": dataclasses.asdict(broker.tenant("app").cache.stats)}
    return out, broker.telemetry.summary(), caches


def _serve_in_thread(pkg, tenant, tmp):
    core, svc = PACKAGES[pkg]
    kw = {"device": "cpu"} if pkg == "port" else {}
    broker = svc.OffloadBroker(backend="reference", clock=lambda: 0.0, **kw)
    broker.register("app", *tenant)
    server = svc.SolverServer(broker, address=svc.unix_address(tmp / f"{pkg}.sock"),
                              journal_path=tmp / "journal.jsonl",
                              snapshot_dir=tmp / "snaps", snapshot_every_ticks=3)
    server.bind()
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread


@pytest.mark.parametrize("encoding", JS.wire.supported_encodings())
@pytest.mark.parametrize("client_pkg,server_pkg",
                         [("repro", "port"), ("port", "repro"), ("port", "port")])
def test_cross_package_serving_matches_in_process_repro(tmp_path, client_pkg,
                                                        server_pkg, encoding):
    tenants = _tenants()
    want, want_summary, want_caches = _in_process_repro(tenants["repro"])
    server, thread = _serve_in_thread(server_pkg, tenants[server_pkg], tmp_path)
    try:
        core, svc = PACKAGES[client_pkg]
        client = svc.BrokerClient(server.address, tenants={"app": tenants[client_pkg]},
                                  client="x", encoding=encoding, timeout=TIMEOUT)
        client.connect()
        assert client.backend == "reference" and client.server_tenants == ("app",)
        group = client.register_batch("app", 24, threshold=0.15, min_interval=2)
        got = _drive(core, svc, client, client.tick, group)
        tel = client.telemetry()
        client.close()
    finally:
        server.stop()
        thread.join(timeout=TIMEOUT)
    assert not thread.is_alive()
    assert got["replies"] == want["replies"]
    assert got["events"] == want["events"] and len(want["events"]) > 0
    assert _same(got["ticks"], want["ticks"])
    assert _same(got["batch"], want["batch"]) and len(want["batch"]) == 8
    assert _same(tel["summary"], want_summary)
    assert tel["caches"] == want_caches


@pytest.mark.parametrize("server_pkg", ["port", "repro"])
def test_remote_batch_group_takes_slot_masks(tmp_path, server_pkg):
    """``arrived``/``departed`` as bool masks (what TrafficGenerator gives):
    the port's client sends their indices, so the server's group, of
    either package, sees the slots an in-process group sees."""
    tenants = _tenants()

    def run(observe_and_tick):
        traffic = TS.TrafficGenerator(24, seed=3, arrival_rate=2.0, churn=0.1, initial=16)
        return [observe_and_tick(traffic.step()) for _ in range(4)]

    local = TS.OffloadBroker(backend="reference", device="cpu", clock=lambda: 0.0)
    local.register("app", *tenants["port"])
    lgroup = local.register_batch("app", 24)

    def in_process(tk):
        lgroup.observe(tk.envs, arrived=tk.arrived, departed=tk.departed)
        local.tick()
        return batch_report_frame("app#1", lgroup.drain()[0])

    want = run(in_process)
    server, thread = _serve_in_thread(server_pkg, tenants[server_pkg], tmp_path)
    try:
        client = TS.BrokerClient(server.address, tenants={"app": tenants["port"]},
                                 client="port", timeout=TIMEOUT)
        group = client.register_batch("app", 24)

        def remote(tk):
            group.observe(tk.envs, arrived=tk.arrived, departed=tk.departed)
            client.tick()
            report = group.drain()[0]
            report["group"] = "app#1"
            return report

        got = run(remote)
        client.close()
    finally:
        server.stop()
        thread.join(timeout=TIMEOUT)
    assert _same(got, want) and want[0]["active"] > 2


# ----------------------------------------------------------------------
# the entry point in real subprocesses
# ----------------------------------------------------------------------
def _start_server(tmp: pathlib.Path, *, kill_at_tick=None) -> subprocess.Popen:
    """Launch the port's solver process on the host and block until READY."""
    cmd = [sys.executable, "-m", "repro_torch.launch.serve_broker",
           "--device", "cpu", "--backend", "reference",
           "--socket", str(tmp / "solver.sock"), "--journal", str(tmp / "journal.jsonl"),
           "--snapshot-dir", str(tmp / "snaps"), "--snapshot-every", "7",
           "--nodes", str(NODES), "--seed", str(SEED), "--batch-capacity", "16"]
    if kill_at_tick is not None:
        cmd += ["--kill-at-tick", str(kill_at_tick)]
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True, env=env)
    lines = []

    def wait_ready():
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("READY"):
                return

    reader = threading.Thread(target=wait_ready, daemon=True)
    reader.start()
    reader.join(timeout=TIMEOUT)
    if not lines or not lines[-1].startswith("READY"):
        proc.kill()
        proc.wait()
        raise RuntimeError(f"server never became READY: {lines}")
    assert lines[0].startswith("RECOVERED")
    return proc


def _client(tmp: pathlib.Path, name="drv"):
    return TS.BrokerClient(
        TS.unix_address(tmp / "solver.sock"), tenants={"app": demo_tenant(NODES, SEED)},
        client=name, timeout=TIMEOUT,
        retry=TS.RetryPolicy(max_retries=2, base_backoff_s=0.01, max_backoff_s=0.05),
    )


def _submit_ticks(client, envs, sigs, start=0, until=None):
    for i, env in enumerate(envs[start:until], start):
        fut = client.submit("app", env)
        client.tick()
        assert fut.done, f"request {i} unresolved after its tick"
        sigs[i] = _sig(fut.result)


TRACE = [_env_in(T, e) for e in JS.environment_trace(24, seed=11)]
KILL_I = 15            # the submit whose tick the solver dies inside
KILL_TICK = KILL_I + 1


def test_sigkill_warm_restart_replies_bit_identical(tmp_path):
    # run A: uninterrupted
    dir_a = tmp_path / "a"
    dir_a.mkdir()
    proc = _start_server(dir_a)
    try:
        client = _client(dir_a)
        client.connect()
        assert client.backend == "reference"
        uninterrupted = {}
        _submit_ticks(client, TRACE, uninterrupted)
        client.close()
    finally:
        proc.kill()
        proc.wait()

    # run B: SIGKILL after the broker mutated, before the journal's tick
    # marker; restart on the same journal and snapshots; continue
    dir_b = tmp_path / "b"
    dir_b.mkdir()
    proc = _start_server(dir_b, kill_at_tick=KILL_TICK)
    crashed = {}
    client = _client(dir_b)
    client.connect()
    _submit_ticks(client, TRACE, crashed, until=KILL_I)
    fut = client.submit("app", TRACE[KILL_I])
    with pytest.raises(ConnectionError):
        client.tick()
    proc.wait(timeout=TIMEOUT)
    assert proc.returncode == -signal.SIGKILL

    proc = _start_server(dir_b)
    try:
        client.tick()  # reconnect, resubmit the window, run the lost tick once
        assert fut.done and client.resubmitted >= 1
        crashed[KILL_I] = _sig(fut.result)
        _submit_ticks(client, TRACE, crashed, start=KILL_I + 1)
        assert crashed == uninterrupted

        # resubmitting a resolved id is served from the reply log: reply
        # first, then a replayed ack, and the cache counters do not move
        caches0 = client.telemetry()["caches"]["app"]
        raw = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        raw.settimeout(TIMEOUT)
        raw.connect(str(dir_b / "solver.sock"))
        stream = FrameStream(raw)
        stream.send({"type": "hello", "version": PROTOCOL_VERSION,
                     "encoding": "json", "client": "dup"})
        assert stream.recv(TIMEOUT)["type"] == "hello_ok"
        stream.send({"type": "submit", "id": f"drv-{KILL_I + 1}", "tenant": "app",
                     "env": env_to_wire(TRACE[KILL_I]), "lane": "user",
                     "deadline": None})
        reply = stream.recv(TIMEOUT)
        assert reply["type"] == "reply" and reply["tick"] == KILL_TICK
        ack = stream.recv(TIMEOUT)
        assert ack["type"] == "submit_ok" and ack["replayed"] is True
        stream.send({"type": "bye"})
        stream.close()
        assert client.telemetry()["caches"]["app"] == caches0
        client.close()
    finally:
        proc.kill()
        proc.wait()


def test_reconnect_against_live_server_is_idempotent(tmp_path):
    """A dropped connection mid-window, redialled to the same server, must
    not double-submit: the inflight dedup path.  A repro client on the port
    server's process, so the boundary is crossed by both packages."""
    proc = _start_server(tmp_path)
    try:
        pj = J.AppProfile.from_wcg_times(J.random_wcg(NODES, rng=np.random.default_rng(SEED)))
        client = JS.BrokerClient(JS.unix_address(tmp_path / "solver.sock"),
                                 tenants={"app": (pj, J.ResponseTimeModel())},
                                 client="flaky", timeout=TIMEOUT)
        client.connect()
        futs = [client.submit("app", J.Environment.symmetric(bw, 3.0))
                for bw in (8.0, 1.2, 0.3)]
        client._stream.close()  # the socket dies; the server and its queue live
        client._stream = None
        client.connect()
        assert client.resubmitted == 3
        t0 = time.monotonic()
        client.drain(max_ticks=8)
        assert time.monotonic() - t0 < TIMEOUT
        assert all(f.done for f in futs)
        assert client.telemetry()["summary"]["requests"] == 3
        client.close()
    finally:
        proc.kill()
        proc.wait()


def test_ipc_serves_llm_stage_profile(tmp_path):
    """The serving plane is model-agnostic: qwen2-7b's stage graph as a
    tenant of a port server, driven by a port client, replies ``==`` a JAX
    in-process broker's (both on the f64 reference backend), and the
    revisit is a cache hit."""
    from repro.configs import ARCHITECTURES as J_ARCHS, SHAPES as J_SHAPES
    from repro.core.placement import TPUV5E_TIER as J_TIER, build_stage_wcg as j_stage_wcg
    from repro.profilers.program import stage_specs as j_stage_specs
    from repro_torch.configs import ARCHITECTURES, SHAPES
    from repro_torch.core.placement import TPUV5E_TIER, build_stage_wcg
    from repro_torch.profilers.program import stage_specs

    j_stages = j_stage_specs(J_ARCHS["qwen2-7b"], J_SHAPES["train_4k"], group=8)
    pj = J.AppProfile.from_wcg_times(j_stage_wcg(j_stages, J_TIER, J_TIER))
    stages = stage_specs(ARCHITECTURES["qwen2-7b"], SHAPES["train_4k"], group=8)
    pt = T.AppProfile.from_wcg_times(build_stage_wcg(stages, TPUV5E_TIER, TPUV5E_TIER))
    for field in ("t_local", "data_in", "data_out", "offloadable"):
        assert np.array_equal(getattr(pt, field), getattr(pj, field)), field
    envs = [(bw, 2.0) for bw in (4.0, 0.5, 4.0)]

    local = JS.OffloadBroker(backend="reference", clock=lambda: 0.0)
    local.register("llm", pj, J.ResponseTimeModel())
    want = []
    for bw, f in envs:
        fut = local.submit("llm", J.Environment.symmetric(bw, f))
        local.tick()
        want.append(_sig(fut.result))

    broker = TS.OffloadBroker(backend="reference", device="cpu", clock=lambda: 0.0)
    broker.register("llm", pt, T.ResponseTimeModel())
    server = TS.SolverServer(broker, address=TS.unix_address(tmp_path / "llm.sock"),
                             journal_path=tmp_path / "llm.jsonl",
                             snapshot_dir=tmp_path / "llm_snaps")
    server.bind()
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        client = TS.BrokerClient(server.address, tenants={"llm": (pt, T.ResponseTimeModel())},
                                 client="llm-drv", timeout=TIMEOUT)
        client.connect()
        got = []
        for bw, f in envs:
            fut = client.submit("llm", T.Environment.symmetric(bw, f))
            client.tick()
            got.append(_sig(fut.result))
        client.close()
    finally:
        server.stop()
        thread.join(timeout=TIMEOUT)
    assert not thread.is_alive()
    assert got == want
    assert got[2][1] is True                 # the revisit is a cache hit
    assert got[0][0][1] != got[1][0][1]      # the two links place the stages apart
