"""Energy profiler (paper §6.3).

The paper estimates device energy with a power model (PowerTutor-style
software monitor): per-component powers integrated over activity time.
We keep exactly that structure.  For the paper-reproduction figures the
powers are the HP iPAQ constants (P_m=0.9 W, P_i=0.3 W, P_tr=1.3 W); for
the accelerator-tier instantiation they become per-chip compute/idle/link
watts from :class:`~repro_torch.core.placement.TierSpec`.  Host numpy, a
port of the JAX package's module of the same name.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.cost_models import Environment
from repro_torch.core.graph import WCG

__all__ = ["EnergyReport", "EnergyProfiler"]


@dataclasses.dataclass
class EnergyReport:
    compute_j: float
    idle_j: float
    transfer_j: float

    @property
    def total_j(self) -> float:
        return self.compute_j + self.idle_j + self.transfer_j


class EnergyProfiler:
    """Integrates the power model over a placement's activity timeline.

    Mirrors Eq. 6 exactly: local vertices draw P_m for their local runtime,
    offloaded vertices leave the device idling at P_i for the remote
    runtime, and every cut edge draws P_tr for its transfer time.
    """

    def __init__(self, env: Environment):
        self.env = env

    def measure(self, time_wcg: WCG, local_mask: np.ndarray) -> EnergyReport:
        """``time_wcg`` must be the *response-time* WCG (node=time, edge=time)."""
        local_mask = np.asarray(local_mask, dtype=bool)
        compute = float(time_wcg.w_local[local_mask].sum()) * self.env.p_compute
        idle = float(time_wcg.w_cloud[~local_mask].sum()) * self.env.p_idle
        cut = local_mask[:, None] != local_mask[None, :]
        transfer_t = float((time_wcg.adj * cut).sum() / 2.0)
        transfer = transfer_t * self.env.p_transfer
        return EnergyReport(compute_j=compute, idle_j=idle, transfer_j=transfer)
