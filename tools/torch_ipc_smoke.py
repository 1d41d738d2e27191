#!/usr/bin/env python
"""Cross-process smoke of the PyTorch port: one solver, N client
processes, U batched users.

    PYTHONPATH=src python tools/torch_ipc_smoke.py --users 1000 --clients 2 \
        --ticks 6 --dir /tmp/ipc_smoke [--device cpu]

The counterpart of ``tools/ipc_smoke.py``.  Boots ``python -m
repro_torch.launch.serve_broker`` on a unix socket (``--backend cuda`` on
the GPU, ``--backend torch`` with ``--device cpu``; ``--device`` defaults
to the GPU, and without one the server raises ``KernelError`` and the
smoke fails), then spawns ``--clients`` client processes (this script
re-executed with ``--worker``), each registering a server-side batch
session group of ``U/N`` slots through a ``repro_torch`` ``BrokerClient``
and driving it with seeded ``TrafficGenerator`` churn for ``--ticks``
ticks.  Every worker must see a ``batch_report`` for every tick it
staged; each writes its reports to ``DIR/<name>.reports.json``.  On
success the server is stopped with SIGINT so that it exports its trace
(``DIR/ipc_trace.json`` and ``.jsonl``, for ``tools/tracequery.py
--audit``); its request journal is ``DIR/journal.jsonl`` (for
``tools/wire_journal.py --verify``).

Exit status: 0 only if the server came up, every worker resolved every
staged tick, and the trace files exist.  No process this script started
outlives it, on any exit path.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import queue
import signal
import subprocess
import sys
import threading
import time

READY_TIMEOUT_S = 120.0


# ----------------------------------------------------------------------
# worker: one client process driving U/N batched users
# ----------------------------------------------------------------------

def worker(args) -> int:
    import numpy as np  # deferred: the coordinator stays stdlib-only

    from repro_torch.launch.serve_broker import demo_tenant
    from repro_torch.service import BrokerClient, unix_address
    from repro_torch.service.workload import TrafficGenerator

    client = BrokerClient(
        unix_address(args.socket),
        tenants={args.tenant: demo_tenant(args.nodes, args.seed)},
        client=args.name,
    )
    client.connect()
    group = client.register_batch(args.tenant, args.users)
    gen = TrafficGenerator(args.users, seed=args.traffic_seed)

    reports = []
    for _ in range(args.ticks):
        t = gen.step()
        group.observe(
            t.envs,
            arrived=np.nonzero(t.arrived)[0],
            departed=np.nonzero(t.departed)[0],
        )
        client.tick()
        reports.extend(group.drain())
    # a concurrent client's tick may resolve our stage before our own
    # tick frame lands, but every staged tick must report exactly once
    for _ in range(4):
        if len(reports) >= args.ticks:
            break
        client.tick()
        reports.extend(group.drain())
    client.close()
    if args.reports:
        pathlib.Path(args.reports).write_text(json.dumps(reports) + "\n")

    if len(reports) != args.ticks:
        print(
            f"WORKER {args.name} FAIL: {len(reports)} reports for "
            f"{args.ticks} staged ticks",
            file=sys.stderr,
        )
        return 1
    solved = sum(r["solved"] for r in reports)
    active = reports[-1]["active"]
    print(
        f"WORKER {args.name} ok users={args.users} ticks={args.ticks} "
        f"solved={solved} active_last={active}",
        flush=True,
    )
    return 0


# ----------------------------------------------------------------------
# coordinator: server subprocess + N worker subprocesses
# ----------------------------------------------------------------------

def _wait_ready(server: subprocess.Popen) -> None:
    """Echo the server's lines until READY; fails past READY_TIMEOUT_S or
    when the server exits first (a reader thread, so a silent server
    cannot block the wait)."""
    lines: queue.Queue = queue.Queue()

    def read():
        for line in server.stdout:
            lines.put(line)
            if line.startswith("READY"):
                break
        lines.put(None)

    threading.Thread(target=read, daemon=True).start()
    deadline = time.monotonic() + READY_TIMEOUT_S
    while True:
        try:
            line = lines.get(timeout=max(deadline - time.monotonic(), 0.0))
        except queue.Empty:
            raise RuntimeError("server never became READY") from None
        if line is None:
            raise RuntimeError("server exited before READY")
        print(line, end="", flush=True)
        if line.startswith("READY"):
            return


def _stop(proc: subprocess.Popen) -> None:
    if proc.poll() is None:
        proc.kill()
    proc.wait()


def coordinator(args) -> int:
    out = pathlib.Path(args.dir)
    out.mkdir(parents=True, exist_ok=True)
    sock = out / "solver.sock"
    trace_chrome = out / "ipc_trace.json"
    trace_jsonl = out / "ipc_trace.jsonl"
    src = pathlib.Path(__file__).resolve().parent.parent / "src"
    env = dict(os.environ, PYTHONPATH=str(src))
    backend = "torch" if args.device == "cpu" else "cuda"

    server = subprocess.Popen(
        [
            sys.executable, "-m", "repro_torch.launch.serve_broker",
            "--backend", backend, "--device", args.device,
            "--socket", str(sock),
            "--journal", str(out / "journal.jsonl"),
            "--snapshot-dir", str(out / "snaps"),
            "--nodes", str(args.nodes), "--seed", str(args.seed),
            "--tenant", args.tenant,
            "--trace", str(trace_chrome),
            "--trace-jsonl", str(trace_jsonl),
        ],
        stdout=subprocess.PIPE, text=True, env=env,
    )
    workers: list[subprocess.Popen] = []
    names = [f"smoke{i}" for i in range(args.clients)]
    try:
        try:
            _wait_ready(server)
        except RuntimeError as err:
            print(f"SMOKE FAIL: {err}", file=sys.stderr)
            return 1

        per_client = args.users // args.clients
        for i, name in enumerate(names):
            workers.append(subprocess.Popen(
                [
                    sys.executable, str(pathlib.Path(__file__).resolve()),
                    "--worker",
                    "--socket", str(sock),
                    "--users", str(per_client),
                    "--ticks", str(args.ticks),
                    "--nodes", str(args.nodes), "--seed", str(args.seed),
                    "--tenant", args.tenant,
                    "--name", name,
                    "--traffic-seed", str(100 + i),
                    "--reports", str(out / f"{name}.reports.json"),
                ],
                env=env,
            ))
        try:
            codes = [w.wait(timeout=READY_TIMEOUT_S) for w in workers]
        except subprocess.TimeoutExpired:
            print("SMOKE FAIL: a worker did not finish", file=sys.stderr)
            return 1
        if any(codes):
            print(f"SMOKE FAIL: worker exit codes {codes}", file=sys.stderr)
            return 1

        # graceful shutdown so the tracer exports
        server.send_signal(signal.SIGINT)
        try:
            server.wait(timeout=READY_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            print("SMOKE FAIL: the server ignored SIGINT", file=sys.stderr)
            return 1
    finally:
        for proc in (*workers, server):
            _stop(proc)

    for path in (trace_chrome, trace_jsonl):
        if not path.exists() or not path.stat().st_size:
            print(f"SMOKE FAIL: missing trace {path}", file=sys.stderr)
            return 1
    spans = sum(
        1 for line in trace_jsonl.read_text().splitlines()
        if line.strip() and json.loads(line).get("type") == "span"
    )
    solved = sum(
        r["solved"]
        for name in names
        for r in json.loads((out / f"{name}.reports.json").read_text())
    )
    print(
        f"SMOKE ok clients={args.clients} users={args.users} "
        f"ticks={args.ticks} trace_spans={spans} solved={solved}",
        flush=True,
    )
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--worker", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--reports", help=argparse.SUPPRESS)
    ap.add_argument("--socket", help="unix socket (worker mode)")
    ap.add_argument("--dir", default="ipc_smoke_out",
                    help="scratch/artifact directory (coordinator mode)")
    ap.add_argument("--users", type=int, default=1000,
                    help="total batched users across all clients")
    ap.add_argument("--clients", type=int, default=2)
    ap.add_argument("--ticks", type=int, default=6)
    ap.add_argument("--nodes", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tenant", default="app")
    ap.add_argument("--name", default="smoke")
    ap.add_argument("--traffic-seed", type=int, default=100)
    ap.add_argument("--device", default="cuda",
                    help="where the server solves (default the GPU)")
    args = ap.parse_args(argv)
    if args.worker:
        if not args.socket:
            ap.error("--worker requires --socket")
        return worker(args)
    return coordinator(args)


if __name__ == "__main__":
    sys.exit(main())
