"""Network profiler (paper §6.2).

The paper's network profiler measures throughput "by measuring the time
duration when sending a certain amount of data" and continuously monitors
environmental changes.  Here the links being profiled are links between
accelerator pools or a host's PCIe rather than WiFi/3G, but the estimator
is the same: timed transfers folded into an exponentially-weighted moving
average, with variance tracking so the adaptive controller can distinguish
drift from noise.

:class:`SimulatedChannel` plays the role of the physical link: it models a
configurable true bandwidth with multiplicative jitter and regime shifts
(the paper's "user moves to another location"), and *actually moves bytes*
(numpy copies) so the profiler's timing path is exercised end to end.  Host
numpy, a port of the JAX package's module of the same name: under one seed
its draws, estimates and variances are those of that module.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

__all__ = ["SimulatedChannel", "NetworkProfiler", "BandwidthSample"]


@dataclasses.dataclass
class BandwidthSample:
    bytes_moved: int
    seconds: float

    @property
    def bandwidth(self) -> float:
        return self.bytes_moved / max(self.seconds, 1e-12)


class SimulatedChannel:
    """A fake link with a true (hidden) bandwidth and measurement noise.

    ``transfer(nbytes)`` returns the simulated wall time for the transfer
    and performs a real memory copy of the payload so that profiling code
    paths run against actual buffers.
    """

    def __init__(
        self,
        bandwidth: float,
        *,
        jitter: float = 0.05,
        latency: float = 1e-4,
        seed: int = 0,
    ):
        self.true_bandwidth = float(bandwidth)
        self.jitter = jitter
        self.latency = latency
        self._rng = np.random.default_rng(seed)

    def set_bandwidth(self, bandwidth: float) -> None:
        """Regime shift — the paper's environment change."""
        self.true_bandwidth = float(bandwidth)

    def transfer(self, nbytes: int) -> BandwidthSample:
        payload = np.empty(max(1, nbytes // 8), dtype=np.float64)
        _ = payload.copy()  # real data movement, keeps timing honest
        noise = 1.0 + self.jitter * self._rng.standard_normal()
        noise = max(noise, 0.2)
        seconds = self.latency + nbytes / (self.true_bandwidth * noise)
        return BandwidthSample(bytes_moved=nbytes, seconds=seconds)


class NetworkProfiler:
    """EWMA bandwidth estimator with drift detection (paper Fig. 1 input).

    ``alpha`` is the EWMA smoothing factor; ``probe_bytes`` the size of an
    active probe.  Passive samples (real transfers the runtime performed
    anyway) are folded in for free via :meth:`record`.
    """

    def __init__(
        self,
        channel: SimulatedChannel | None = None,
        *,
        alpha: float = 0.3,
        probe_bytes: int = 1 << 20,
    ):
        self.channel = channel
        self.alpha = alpha
        self.probe_bytes = probe_bytes
        self._estimate: float | None = None
        self._var: float = 0.0
        self.samples: list[BandwidthSample] = []

    # ------------------------------------------------------------------
    def record(self, sample: BandwidthSample) -> float:
        bw = sample.bandwidth
        if self._estimate is None:
            self._estimate = bw
        else:
            delta = bw - self._estimate
            self._estimate += self.alpha * delta
            self._var = (1 - self.alpha) * (self._var + self.alpha * delta * delta)
        self.samples.append(sample)
        return self._estimate

    def probe(self) -> float:
        """Active measurement against the attached channel."""
        if self.channel is None:
            raise RuntimeError("no channel attached for active probing")
        t0 = time.perf_counter()
        sample = self.channel.transfer(self.probe_bytes)
        _ = time.perf_counter() - t0  # host-side overhead, unused in sim
        return self.record(sample)

    # ------------------------------------------------------------------
    @property
    def bandwidth(self) -> float:
        if self._estimate is None:
            raise RuntimeError("no samples yet")
        return self._estimate

    @property
    def std(self) -> float:
        return float(np.sqrt(self._var))

    def relative_uncertainty(self) -> float:
        if self._estimate in (None, 0.0):
            return float("inf")
        return self.std / self._estimate
