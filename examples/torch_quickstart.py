"""Quickstart of the PyTorch port: the paper's algorithm on its own worked
example + the face-recognition app, then the same engine placing a 7B LLM
across tiers.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The counterpart of ``examples/quickstart.py``, through ``repro_torch``:
every solve here is the host float64 reference (``mcop_reference``, the
oracles, ``plan_placement``'s default backend), so its output is the JAX
example's, line for line.  The tiers are ``TPUV5E_TIER``, the JAX
package's tier data that ``repro_torch.core.placement`` carries under the
same name.  ``--device`` (default the GPU) is checked before anything
runs, as in every entry point of the port; without a GPU the default
raises ``KernelError``.
"""

import argparse
import dataclasses
import sys

from repro_torch.configs import ARCHITECTURES, SHAPES
from repro_torch.core import (
    brute_force,
    face_recognition_graph,
    full_offloading,
    maxflow_optimal,
    mcop_reference,
    no_offloading,
    offloading_gain,
    paper_example_graph,
)
from repro_torch.core.placement import TPUV5E_TIER, plan_placement
from repro_torch.kernels.mcop_phase import require_device
from repro_torch.profilers.program import stage_specs


def section(title):
    print(f"\n=== {title} " + "=" * max(0, 60 - len(title)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = require_device(args.device)

    # ------------------------------------------------------------------
    section("Paper §5.5 worked example (Figs. 6–11)")
    g = paper_example_graph()
    res = mcop_reference(g)
    print(f"local cost total C_local = {g.local_cost_total:.0f}")
    for i, ph in enumerate(res.phases, 1):
        print(f"  phase {i}: order={' '.join(ph.order):<28s} cut={ph.cut_value:.0f}")
    local = [g.names[i] for i in res.local_indices]
    cloud = [g.names[i] for i in res.cloud_indices]
    print(f"optimal cut = {res.min_cut:.0f}  local={local}  cloud={cloud}")
    print(f"(paper: cut 22, local {{a, c}}, cloud {{b, d, e, f}})")

    # ------------------------------------------------------------------
    section("Face recognition app (Figs. 12–13), F=2, B=1 MB/s")
    fg = face_recognition_graph(speedup=2.0, bandwidth_mbps=1.0)
    fres = mcop_reference(fg)
    no, full = no_offloading(fg), full_offloading(fg)
    print(f"no offloading   : {no.cost:9.1f} ms")
    print(f"full offloading : {full.cost:9.1f} ms")
    print(f"partial (MCOP)  : {fres.min_cut:9.1f} ms  "
          f"gain={offloading_gain(no.cost, fres.min_cut):.1%}")
    print("local:", [fg.names[i] for i in fres.local_indices])
    print("cloud:", [fg.names[i] for i in fres.cloud_indices])

    # ------------------------------------------------------------------
    section("Optimality check against independent oracles")
    b, m = brute_force(fg), maxflow_optimal(fg)
    print(f"brute force={b.cost:.1f}  maxflow={m.cost:.1f}  mcop={fres.min_cut:.1f}")

    # ------------------------------------------------------------------
    # the JAX package's tier data, so that the plan is its plan
    section("Same algorithm placing qwen2-7b stages across two TPU tiers")
    cfg = ARCHITECTURES["qwen2-7b"]
    stages = stage_specs(cfg, SHAPES["train_4k"], group=4)
    plan = plan_placement(
        stages,
        dataclasses.replace(TPUV5E_TIER, name="pod-0", chips=64),
        dataclasses.replace(TPUV5E_TIER, name="pod-1", chips=192),
        device=device,
    )
    print(f"stages={len(stages)}  mcop_cost={plan.mcop_cost:.3e}s/step")
    print(f"contiguous pipeline boundary at stage {plan.contiguous_boundary} "
          f"(penalty {plan.contiguity_penalty:.2e}s)")
    print(f"activation bytes crossing tiers per step: {plan.cut_bytes:.3e}")
    tier0 = [stages[i].name for i in plan.tier_stages(0)][:4]
    print(f"pod-0 keeps: {tier0}{'…' if len(plan.tier_stages(0)) > 4 else ''}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
