"""Service layer: the offload broker that turns the solver into a server.

``broker``    — :class:`OffloadBroker`: async multi-tenant coalescing
                front end over ``mcop_batch`` with persistent per-tenant
                placement caches, fused tick pricing and tick telemetry.
``scheduler`` — :class:`WeightedFairScheduler`: deficit-round-robin
                flush order over per-tenant weights, a strict elastic
                priority lane, and backpressure on queued bins.
``session``   — :class:`BrokerSession`: one user's adaptive loop
                (paper Fig. 1) with solves routed through the broker;
                :class:`BatchSessionGroup`: K sessions as one
                array-native SessionBatch ticked vectorized.
``faults``    — :class:`FaultInjector`: seeded deterministic chaos
                (pure function of seed/site/tick/index) for the fault
                sites the broker tick exposes.
``resilience``— :class:`ResiliencePolicy`: retry/backoff, per-request
                deadlines, circuit breaker (cuda→torch→reference on
                the CPU only), and graceful degradation to §4.3-safe
                fallback placements; kernel failures always propagate.
``workload``  — deterministic seeded multi-user environment walks for
                tests, benchmarks and demos, plus the vectorized
                :class:`TrafficGenerator` (Poisson arrivals, geometric
                churn) feeding batched session groups.
``wire``      — length-prefixed JSON/msgpack frame protocol of the
                cross-process serving plane (versioned hello, typed
                error frames, bit-exact float64 round trips); the same
                bytes as the JAX package's, so either side may be either
                package.
``server``    — :class:`SolverServer`: the solver process owning the
                GPU and the broker, with a write-ahead request journal,
                background snapshot loop, and journaled warm restart.
``client``    — :class:`BrokerClient`: sessions over unix/TCP sockets
                with graceful reconnect and idempotent resubmission.
"""

from repro_torch.service.broker import (
    BrokerReply,
    BrokerTelemetry,
    OffloadBroker,
    PlacementFuture,
    TickReport,
)
from repro_torch.service.client import BrokerClient, ClientFuture, RemoteBatchGroup
from repro_torch.service.faults import (
    FAULT_KINDS,
    FAULT_SITES,
    FaultDecision,
    FaultInjector,
    InjectedFault,
    ScriptedFaultInjector,
)
from repro_torch.service.resilience import (
    BACKEND_ESCALATION,
    CircuitBreaker,
    InjectedClock,
    ResiliencePolicy,
    RetryPolicy,
)
from repro_torch.service.scheduler import QueueEntry, WeightedFairScheduler
from repro_torch.service.server import Journal, SolverServer, tcp_address, unix_address
from repro_torch.service.session import BatchSessionGroup, BrokerSession
from repro_torch.service.wire import (
    PROTOCOL_VERSION,
    BadFrame,
    FrameStream,
    FrameTooLarge,
    RemoteError,
    TruncatedFrame,
    VersionMismatch,
    WireError,
    decode_frame,
    encode_frame,
)
from repro_torch.service.workload import (
    DEFAULT_REGIMES,
    Regime,
    TrafficGenerator,
    TrafficTick,
    WorkloadReport,
    environment_trace,
    run_batch_workload,
    run_workload,
    user_traces,
)

__all__ = [
    "BrokerReply",
    "BrokerTelemetry",
    "OffloadBroker",
    "PlacementFuture",
    "TickReport",
    "FAULT_KINDS",
    "FAULT_SITES",
    "FaultDecision",
    "FaultInjector",
    "InjectedFault",
    "ScriptedFaultInjector",
    "BACKEND_ESCALATION",
    "CircuitBreaker",
    "InjectedClock",
    "ResiliencePolicy",
    "RetryPolicy",
    "QueueEntry",
    "WeightedFairScheduler",
    "BrokerSession",
    "BatchSessionGroup",
    "PROTOCOL_VERSION",
    "WireError",
    "BadFrame",
    "FrameTooLarge",
    "TruncatedFrame",
    "VersionMismatch",
    "RemoteError",
    "FrameStream",
    "encode_frame",
    "decode_frame",
    "SolverServer",
    "Journal",
    "unix_address",
    "tcp_address",
    "BrokerClient",
    "ClientFuture",
    "RemoteBatchGroup",
    "DEFAULT_REGIMES",
    "Regime",
    "TrafficGenerator",
    "TrafficTick",
    "WorkloadReport",
    "environment_trace",
    "run_batch_workload",
    "run_workload",
    "user_traces",
]
