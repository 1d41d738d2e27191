"""Run a solver process: the cross-process serving plane's server half.

    python -m repro_torch.launch.serve_broker --socket /tmp/mcop.sock \
        --journal /tmp/mcop/journal.jsonl --snapshot-dir /tmp/mcop/snaps

Starts a :class:`~repro_torch.service.server.SolverServer` owning an
:class:`~repro_torch.service.broker.OffloadBroker` with one deterministic
demo tenant (a seeded random WCG — any client building the same
``--nodes``/``--seed`` profile with :func:`demo_tenant` gets bit-identical
placements), a write-ahead request journal, and a background snapshot loop.
On start it warm-restarts from whatever journal/snapshots the directory
already holds, so SIGKILL + rerun resumes where the dead process stopped.
Then, from any number of other processes:

    from repro_torch.service import BrokerClient, BrokerSession, unix_address
    client = BrokerClient(unix_address("/tmp/mcop.sock"),
                          tenants={"app": demo_tenant(12, 0)}).connect()
    session = BrokerSession(client, "app")   # the unmodified session class
    session.observe(env); client.tick(); print(session.drain())

A client of the JAX package (``repro.service.BrokerClient``) works the same
way: the wire is the same.

``--backend`` is one of the port's solve backends: ``cuda`` (the
hand-written kernels), ``torch`` (plain tensor code) or ``reference`` (the
host f64 solver); the JAX package's ``examples/serve_broker.py`` calls them
``pallas``, ``jax`` and ``reference``.  Both ``--backend`` and ``--device``
default to the GPU (``cuda``), where that script defaults to
``reference``: as every entry point of this package, the server needs a
GPU unless it is told otherwise, and without one it raises ``KernelError``
before it binds.  ``--device cpu`` runs it on the host (the ``cuda`` and
``torch`` backends then take their plain versions).

``--kill-at-tick N`` is a crash-test hook: the process SIGKILLs *itself*
mid-tick — after the broker state mutates, before the journal tick
append — the exact torn write the warm-restart path must absorb.  The
``RECOVERED`` and ``READY`` lines on standard output are the startup
barrier clients wait on.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys

import numpy as np


def demo_tenant(nodes: int, seed: int):
    """The (profile, cost_model) pair both sides build independently —
    seeded, so server and clients agree without shipping the graph."""
    from repro_torch.core import AppProfile, ResponseTimeModel, random_wcg

    profile = AppProfile.from_wcg_times(
        random_wcg(nodes, rng=np.random.default_rng(seed))
    )
    return profile, ResponseTimeModel()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--socket", help="unix socket path")
    ap.add_argument("--tcp", help="host:port (port 0 = ephemeral)")
    ap.add_argument("--journal", help="write-ahead journal path (JSONL)")
    ap.add_argument("--snapshot-dir", help="placement-cache snapshot dir")
    ap.add_argument("--snapshot-every", type=int, default=8,
                    help="snapshot cadence in ticks")
    ap.add_argument("--tenant", default="app")
    ap.add_argument("--nodes", type=int, default=12, help="demo WCG size")
    ap.add_argument("--seed", type=int, default=0, help="demo WCG seed")
    ap.add_argument("--backend", default="cuda",
                    choices=("reference", "torch", "cuda"))
    ap.add_argument("--device", default="cuda",
                    help="where the solves run (default the GPU)")
    ap.add_argument("--batch-capacity", type=int, default=0,
                    help="also expose a batch session group of this size")
    ap.add_argument("--max-ticks", type=int, default=None,
                    help="exit after serving this many ticks")
    ap.add_argument("--trace", help="export a chrome trace here on exit")
    ap.add_argument("--trace-jsonl",
                    help="export a tracequery-readable JSONL trace on exit")
    ap.add_argument("--kill-at-tick", type=int, default=None,
                    help="crash hook: SIGKILL self mid-tick N")
    args = ap.parse_args(argv)

    if bool(args.socket) == bool(args.tcp):
        ap.error("exactly one of --socket / --tcp is required")

    from repro_torch.kernels.mcop_phase import require_device
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.obs.trace import Tracer
    from repro_torch.service import (
        OffloadBroker, SolverServer, tcp_address, unix_address,
    )

    if args.socket:
        address = unix_address(args.socket)
    else:
        host, _, port = args.tcp.partition(":")
        address = tcp_address(host or "127.0.0.1", int(port or 0))

    device = require_device(args.device)
    broker = OffloadBroker(backend=args.backend, device=device, clock=lambda: 0.0)
    profile, cost_model = demo_tenant(args.nodes, args.seed)
    broker.register(args.tenant, profile, cost_model)

    if args.kill_at_tick is not None:
        real_tick = broker.tick

        def tick_then_die(**kw):
            report = real_tick(**kw)
            if report.tick >= args.kill_at_tick:
                os.kill(os.getpid(), signal.SIGKILL)  # torn mid-tick crash
            return report

        broker.tick = tick_then_die

    tracer = Tracer() if (args.trace or args.trace_jsonl) else None
    server = SolverServer(
        broker,
        address=address,
        journal_path=args.journal,
        snapshot_dir=args.snapshot_dir,
        snapshot_every_ticks=args.snapshot_every,
        tracer=tracer,
        metrics=MetricsRegistry(),
    )
    recovered = server.recover()
    bound = server.bind()
    if args.batch_capacity > 0:
        broker.register_batch(args.tenant, args.batch_capacity)
    # READY is the startup barrier clients wait on; the address matters
    # for --tcp with an ephemeral port
    print(f"RECOVERED {recovered}", flush=True)
    print(f"READY {' '.join(str(p) for p in bound)}", flush=True)
    try:
        server.serve_forever(max_ticks=args.max_ticks)
    except KeyboardInterrupt:
        server.close()
    if args.trace and tracer is not None:
        tracer.export_chrome(args.trace)
    if args.trace_jsonl and tracer is not None:
        tracer.export_jsonl(args.trace_jsonl)
    return 0


if __name__ == "__main__":
    sys.exit(main())
