"""Time the MCOP solve paths of one checkout of the port on the GPU.

Two checkouts compared in one call on one card give a before/after of a
change to the solve paths.  The script loads ``repro_torch`` from
``<tree>/src`` and touches only entry points that checkouts with the
per-phase tier (``kernels.ops.mcop_min_cut``) share, with their default
arguments, so the same script times a parent and its change:

* ``mcop_batch`` over 2048 graphs of 5-200 vertices (``chip_smoke.py``'s
  solve-plane batch, buckets 16/64/256), host seconds with the read-back;
* one broker flush: ``OffloadBroker(backend="cuda")``, a raw-graph tenant
  with the same 2048 graphs queued by ``submit_graph`` (distinct bins),
  host seconds of the ``tick`` that solves and prices them;
* B1 and B2 on symmetric inputs above the packed limit (n = 342, the
  block variant), milliseconds by CUDA events;
* ``mcop_min_cut`` over ``chip_smoke.py``'s 100 graphs of 5-256 vertices,
  host seconds of the whole pass.

Host times are medians of ``--reps`` readings taken after one warm-up.
Run it from the checkout that holds it, once per tree, in turns::

    python3 tools/torch_tree_timing.py --tree _archive/parent --label parent

It prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def median_s(fn, reps: int, setup=None) -> tuple[float, list[float]]:
    """Median host seconds of ``fn(setup())`` over ``reps`` readings, after
    one unrecorded warm-up; ``setup`` runs outside the clock."""
    got = []
    for i in range(reps + 1):
        arg = setup() if setup is not None else None
        t0 = time.perf_counter()
        fn(arg)
        if i:
            got.append(time.perf_counter() - t0)
    return float(np.median(got)), got


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", required=True, help="checkout whose src/ is timed")
    ap.add_argument("--label", required=True)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    sys.path.insert(0, os.path.join(os.path.abspath(args.tree), "src"))
    sys.path.insert(1, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("torch_tree_timing: no CUDA device", file=sys.stderr)
        return 1
    import repro_torch
    from chip_smoke import HETERO, MIN_CUT, cuda_ms, random_batch, random_env_matrix
    from repro_torch.core import random_wcg
    from repro_torch.core.cost_models import Environment
    from repro_torch.core.graph import WCG
    from repro_torch.core.mcop import mcop_batch
    from repro_torch.kernels import mcop_phase as K
    from repro_torch.kernels.ops import mcop_min_cut
    from repro_torch.service import OffloadBroker

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False).stdout.strip().splitlines()[0]
    print(card, flush=True)
    out = {"label": args.label, "package": os.path.dirname(repro_torch.__file__),
           "card": card}

    # the solve plane's 2048 heterogeneous graphs, as chip_smoke.py makes them
    rng = np.random.default_rng(7)
    graphs = []
    for n in rng.integers(HETERO[1], HETERO[2] + 1, HETERO[0]):
        adj, wl, wc, pin = random_batch(rng, 1, int(n))
        graphs.append(WCG(wl[0], wc[0], adj[0], ~pin[0]))
    out["mcop_batch_s"], out["mcop_batch_readings"] = median_s(
        lambda _: mcop_batch(graphs, backend="cuda", device="cuda", buckets=(16, 64, 256)),
        args.reps)

    def queued_broker():
        broker = OffloadBroker(backend="cuda", device="cuda")
        broker.register("raw")
        for i, g in enumerate(graphs):  # a bin each: 10 % steps in both bandwidths
            broker.submit_graph("raw", g, Environment(1.1 ** (i % 64), 1.1 ** (i // 64), 2.0))
        return broker

    def flush(broker):
        report = broker.tick()
        if report.solved != len(graphs):
            raise AssertionError(f"flush solved {report.solved} of {len(graphs)}")

    out["broker_flush_s"], out["broker_flush_readings"] = median_s(
        flush, args.reps, setup=queued_broker)

    # B1 and B2 above the packed limit, symmetric inputs
    n, k = K.packed_limit("cuda") + 1, 256
    adj, wl, wc, pin = (torch.from_numpy(a).cuda() for a in random_batch(rng, k, n))
    out["block_shape"] = [k, n]
    out["b1_block_ms"] = cuda_ms(lambda: K.mcop_stoer_wagner_kernel(adj, wl, wc, pin), reps=3)
    data = adj[0] / 2.0
    prof = (wl[0].contiguous(), data.contiguous(), data.T.contiguous(), pin[0].contiguous())
    env = torch.from_numpy(random_env_matrix(rng, k)).cuda()
    out["b2_block_ms"] = cuda_ms(
        lambda: K.mcop_fused_solve_kernel(*prof, env, kind="weighted"), reps=3)

    # the per-phase tier's 100-graph pass
    lo, hi = MIN_CUT["sizes"]
    sizes = np.exp(np.random.default_rng(MIN_CUT["seed"]).uniform(
        np.log(lo), np.log(hi + 1), MIN_CUT["graphs"])).astype(int)
    sizes[:2] = (lo, hi)
    cut_graphs = [random_wcg(int(s), rng=np.random.default_rng(MIN_CUT["seed"] + i))
                  for i, s in enumerate(sizes)]
    out["min_cut_pass_s"], out["min_cut_pass_readings"] = median_s(
        lambda _: [mcop_min_cut(g.adj, g.w_local, g.w_cloud, g.offloadable, device="cuda")
                   for g in cut_graphs], max(1, args.reps // 2))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
