"""Client side of the cross-process serving plane.

:class:`BrokerClient` connects to a
:class:`~repro_torch.service.server.SolverServer` (or to the JAX package's
server: the wire is the same) over a unix or TCP socket and duck-types the
slice of :class:`~repro_torch.service.broker.OffloadBroker` that
:class:`~repro_torch.service.session.BrokerSession` consumes — ``backend``,
``tenant()``, ``submit_graph()`` — so the *existing* session class runs
unchanged against a remote solver:

    client = BrokerClient(unix_address(sock), tenants={"app": (profile, cm)})
    client.connect()
    session = BrokerSession(client, "app")   # unmodified class
    session.observe(env); client.tick(); session.drain()

Determinism: ``submit_graph`` ships only the six-scalar environment —
the server's deferred-build path reconstructs the WCG from its own copy
of the profile bit-identically (the in-process broker already relies on
this equivalence), and JSON float64 round-trips are exact, so a
cross-process session's events ``==`` an in-process session's.

Resilience across the socket (the broker's retry policy, one layer up):

* **Graceful reconnect** — any transport failure (ECONNRESET, EOF
  mid-frame, a poisoned stream) tears the socket down and redials under
  the client's :class:`~repro_torch.service.resilience.RetryPolicy`; backoff
  sleeps go through the injected clock so tests advance time instead of
  waiting.
* **Idempotent resubmission** — every submit carries a client-unique
  request id and is remembered until its reply lands.  After a
  reconnect (including against a *restarted, warm-started* server) the
  unresolved window is resubmitted verbatim; the server's reply log and
  inflight dedup make this safe — replayed ids are acknowledged with
  ``replayed=True`` and never double-count cache stats.

Every frame exchange runs under a ``wire.frame`` tracer span with
``transport``/``type`` labels, mirroring the server side, so a
cross-process trace shows both halves of each round trip.
"""

from __future__ import annotations

import os
import socket
import time
from typing import Callable

import numpy as np

from repro_torch.core.cost_models import Environment
from repro_torch.obs.trace import NULL_SPAN, Tracer
from repro_torch.service.resilience import RetryPolicy
from repro_torch.service.wire import (
    DEFAULT_MAX_FRAME,
    PROTOCOL_VERSION,
    FrameStream,
    RemoteError,
    TruncatedFrame,
    VersionMismatch,
    WireError,
    env_to_wire,
    supported_encodings,
    wire_to_reply,
)

__all__ = ["BrokerClient", "ClientFuture", "RemoteBatchGroup", "connect"]


class ClientFuture:
    """Client-side :class:`~repro_torch.service.broker.PlacementFuture` twin:
    resolved when the server's reply frame for its request id arrives
    (usually during :meth:`BrokerClient.tick`)."""

    __slots__ = ("id", "_reply")

    def __init__(self, rid: str):
        self.id = rid
        self._reply = None

    @property
    def done(self) -> bool:
        return self._reply is not None

    def set(self, reply) -> None:
        if self._reply is not None:
            raise RuntimeError(f"future {self.id} already resolved")
        self._reply = reply

    @property
    def result(self):
        if self._reply is None:
            raise RuntimeError(
                f"future {self.id} not resolved yet; run client.tick()"
            )
        return self._reply


class _RemoteTenant:
    """What ``BrokerSession`` reads off ``broker.tenant(name)`` — the
    client-local copy of the tenant's profile + cost model."""

    __slots__ = ("name", "profile", "cost_model")

    def __init__(self, name, profile, cost_model):
        self.name = name
        self.profile = profile
        self.cost_model = cost_model


def _slot_indices(slots) -> list[int]:
    """Slots as the wire carries them: indices.  A bool mask (as
    ``TrafficGenerator`` gives) becomes the indices of its True entries —
    sent as 0/1 integers it would name slots 0 and 1 instead."""
    slots = np.asarray(slots)
    if slots.dtype == bool:
        slots = np.flatnonzero(slots)
    return [int(i) for i in slots]


class RemoteBatchGroup:
    """Proxy for a server-side :class:`~repro_torch.service.session.BatchSessionGroup`.

    ``observe`` stages one tick of per-session environment arrays on the
    server (``arrived``/``departed`` as index arrays or bool masks, as
    :meth:`BatchSessionGroup.observe` takes them); the group is resolved inside the server's next broker tick
    and its summary arrives as a ``batch_report`` frame, surfaced here
    by :meth:`drain` as plain dicts (``active``/``due``/``hits``/
    ``solved``/``coalesced``/``degraded``/``min_cut``/``gain``).
    """

    def __init__(self, client: "BrokerClient", gid: str, capacity: int):
        self.client = client
        self.id = gid
        self.capacity = capacity
        self._reports: list[dict] = []

    def observe(self, envs, *, arrived=None, departed=None) -> None:
        frame = {
            "type": "observe_batch",
            "group": self.id,
            "envs": {
                f: [float(v) for v in getattr(envs, f)]
                for f in type(envs)._fields
            },
        }
        if arrived is not None:
            frame["arrived"] = _slot_indices(arrived)
        if departed is not None:
            frame["departed"] = _slot_indices(departed)
        self.client._call(frame, "observe_ok")

    def drain(self) -> list[dict]:
        reports = self._reports
        self._reports = []
        return reports


class BrokerClient:
    """One connection to a remote solver; N sessions ride on it.

    Parameters:
      address:  ``("unix", path)`` or ``("tcp", host, port)``.
      tenants:  name → ``(profile, cost_model)`` — the client-local
                tenant metadata sessions need.  Must mirror the server's
                registration (the hello handshake cross-checks names).
      client:   name stamped on request ids and trace spans; defaults
                to ``pid<os.getpid()>``.
      encoding: proposed wire encoding; the server may fall back to
                ``"json"``.
      retry:    reconnect policy (attempts + backoff); default
                ``RetryPolicy()``.
      timeout:  per-read socket timeout — no reply can hang forever.
      sleep/clock: injectable for deterministic tests: ``sleep`` is
                called with each backoff (tests pass
                ``InjectedClock().advance``), ``clock`` timestamps
                spans only.
    """

    def __init__(
        self,
        address: tuple,
        *,
        tenants: dict | None = None,
        client: str | None = None,
        encoding: str = "json",
        max_frame: int = DEFAULT_MAX_FRAME,
        retry: RetryPolicy | None = None,
        timeout: float = 30.0,
        tracer: Tracer | None = None,
        sleep: Callable[[float], None] = time.sleep,
        clock: Callable[[], float] = time.monotonic,
    ):
        if address[0] not in ("unix", "tcp"):
            raise ValueError(f"unknown address family {address[0]!r}")
        if encoding not in supported_encodings():
            raise ValueError(f"encoding {encoding!r} not available here")
        self.address = address
        self.transport = address[0]
        self.name = client if client is not None else f"pid{os.getpid()}"
        self.encoding = encoding
        self.max_frame = int(max_frame)
        self.retry = retry if retry is not None else RetryPolicy()
        self.timeout = float(timeout)
        self.tracer = tracer
        self._sleep = sleep
        self.clock = clock
        self._tenants: dict[str, _RemoteTenant] = {}
        for tname, (profile, cm) in (tenants or {}).items():
            self._tenants[tname] = _RemoteTenant(tname, profile, cm)
        self._stream: FrameStream | None = None
        self.backend: str | None = None
        # what BrokerSession hands its controller: the client solves nothing
        # (the server does), so the sessions' host-side state never needs a GPU
        self.device = "cpu"
        self.server_tenants: tuple[str, ...] = ()
        self.server_tick: int = 0
        self._seq = 0
        # id → ClientFuture plus the submit frame to replay on reconnect
        self._unresolved: dict[str, ClientFuture] = {}
        self._submits: dict[str, dict] = {}
        self._groups: dict[str, RemoteBatchGroup] = {}
        self.reconnects = 0
        self.resubmitted = 0

    # -- the OffloadBroker surface BrokerSession consumes ---------------
    def tenant(self, name: str) -> _RemoteTenant:
        return self._tenants[name]

    def submit_graph(self, name: str, g, env: Environment) -> ClientFuture:
        """Session-facing submit: the graph is dropped on the floor —
        the server rebuilds it from its own profile copy, bit-identically
        (same deferred-build path the in-process broker uses)."""
        return self.submit(name, env)

    # -- connection lifecycle -------------------------------------------
    def _span(self, name: str, **attrs):
        return (
            self.tracer.span(name, **attrs)
            if self.tracer is not None
            else NULL_SPAN
        )

    def _dial(self) -> FrameStream:
        if self.transport == "unix":
            sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            sock.settimeout(self.timeout)
            sock.connect(self.address[1])
        else:
            sock = socket.create_connection(
                (self.address[1], self.address[2]), timeout=self.timeout
            )
        stream = FrameStream(
            sock, encoding="json", max_frame=self.max_frame
        )
        stream.send(
            {
                "type": "hello",
                "version": PROTOCOL_VERSION,
                "encoding": self.encoding,
                "client": self.name,
            }
        )
        frame = stream.recv(self.timeout)
        if frame is None:
            raise TruncatedFrame("server closed during handshake")
        if frame["type"] == "error":
            stream.close()
            if frame.get("code") == "version_mismatch":
                raise VersionMismatch(frame.get("message", ""))
            raise RemoteError(frame.get("code", "server_error"),
                              frame.get("message", ""))
        if frame["type"] != "hello_ok":
            stream.close()
            raise RemoteError("server_error",
                              f"expected hello_ok, got {frame['type']!r}")
        stream.encoding = frame.get("encoding", "json")
        self.backend = frame.get("backend")
        self.server_tenants = tuple(frame.get("tenants", ()))
        self.server_tick = int(frame.get("tick", 0))
        missing = [t for t in self._tenants if t not in self.server_tenants]
        if missing:
            stream.close()
            raise RemoteError(
                "unknown_tenant",
                f"server is missing tenants {missing}",
            )
        return stream

    def connect(self) -> "BrokerClient":
        """Dial + hello handshake (idempotent).  A dial onto a fresh
        connection always replays the unresolved submit window — the
        server dedups, so this is free on a live server and exactly what
        a warm-restarted one needs."""
        if self._stream is None:
            with self._span(
                "wire.connect", transport=self.transport, client=self.name
            ):
                self._stream = self._dial()
                self._resubmit_window()
        return self

    def close(self) -> None:
        if self._stream is not None:
            try:
                self._stream.send({"type": "bye"})
            except (OSError, WireError):
                pass
            self._stream.close()
            self._stream = None

    def _drop_stream(self) -> None:
        if self._stream is not None:
            self._stream.close()
            self._stream = None

    def _reconnect(self) -> None:
        """Redial under the retry policy, then replay the unresolved
        submit window (the server dedups replayed ids)."""
        last: Exception | None = None
        for attempt in range(self.retry.attempts):
            try:
                self._stream = self._dial()
                break
            except (OSError, TruncatedFrame) as err:
                last = err
                self._drop_stream()
                if attempt + 1 < self.retry.attempts:
                    self._sleep(self.retry.backoff(attempt))
        else:
            raise ConnectionError(
                f"reconnect to {self.address} failed after "
                f"{self.retry.attempts} attempts"
            ) from last
        self.reconnects += 1
        self._resubmit_window()

    def _resubmit_window(self) -> None:
        """Replay every unresolved submit on the current connection.
        Idempotent server-side: known ids are acked ``replayed=True``
        (already-resolved ones push their stored reply first) without
        touching the journal, the queue, or the cache counters."""
        for rid in list(self._unresolved):
            frame = self._submits.get(rid)
            if frame is None:
                continue
            self._stream.send(frame)
            self.resubmitted += 1
            self._await("submit_ok", id=rid)

    # -- frame plumbing --------------------------------------------------
    def _dispatch(self, frame: dict) -> None:
        """Route an asynchronous server push (reply / batch_report)."""
        ftype = frame["type"]
        if ftype == "reply":
            fut = self._unresolved.pop(frame.get("id"), None)
            self._submits.pop(frame.get("id"), None)
            if fut is not None and not fut.done:
                fut.set(wire_to_reply(frame))
        elif ftype == "batch_report":
            group = self._groups.get(frame.get("group"))
            if group is not None:
                group._reports.append(frame)
        elif ftype == "error":
            raise RemoteError(
                frame.get("code", "server_error"), frame.get("message", "")
            )

    def _await(self, expect: str, **match) -> dict:
        """Read frames (dispatching pushes) until one of type ``expect``
        whose fields match ``match`` arrives."""
        while True:
            frame = self._stream.recv(self.timeout)
            if frame is None:
                raise TruncatedFrame("server closed the connection")
            if frame["type"] == expect and all(
                frame.get(k) == v for k, v in match.items()
            ):
                return frame
            self._dispatch(frame)

    def _call(self, frame: dict, expect: str, **match) -> dict:
        """One request/response round trip with transparent reconnect.

        A transport failure mid-call redials and retries the call once
        on the fresh connection — safe because every mutating frame is
        idempotent on the server (journaled ids dedup, ticks are
        client-driven and a torn tick frame was either applied or not;
        the retried tick then simply runs the next tick, which the
        caller was about to request anyway).
        """
        self.connect()
        with self._span(
            "wire.frame",
            type=frame["type"],
            transport=self.transport,
            client=self.name,
        ):
            try:
                self._stream.send(frame)
                return self._await(expect, **match)
            except (OSError, TruncatedFrame):
                self._drop_stream()
                self._reconnect()
                self._stream.send(frame)
                return self._await(expect, **match)

    # -- serving API -----------------------------------------------------
    def submit(
        self,
        name: str,
        env: Environment,
        *,
        lane: str = "user",
        deadline: int | None = None,
    ) -> ClientFuture:
        """Remote :meth:`~repro_torch.service.broker.OffloadBroker.submit`:
        returns a future resolved by a later :meth:`tick`.  The ack is
        synchronous — once this returns, the request is journaled
        server-side and survives a solver crash."""
        if name not in self._tenants:
            raise KeyError(f"tenant {name!r} not configured on this client")
        self._seq += 1
        rid = f"{self.name}-{self._seq}"
        frame = {
            "type": "submit",
            "id": rid,
            "tenant": name,
            "env": env_to_wire(env),
            "lane": lane,
            "deadline": deadline,
        }
        fut = ClientFuture(rid)
        self._unresolved[rid] = fut
        self._submits[rid] = frame
        self._call(frame, "submit_ok", id=rid)
        # a rejected/replayed submit may already have pushed the reply
        return fut

    def tick(self, *, budget: int | None = None) -> dict:
        """Drive one broker tick; replies for every request resolved by
        it are dispatched into their futures before this returns.

        Exactly-once across crashes: a tick frame is NOT blindly
        replayed after a reconnect.  The client remembers the server
        tick it expects to drive; if the hello of the fresh connection
        (to a warm-restarted server whose journal replay re-ran the
        interrupted tick) already shows that tick, the call returns a
        synthetic ``tick_report`` instead of burning an extra tick —
        keeping reply tick numbers aligned with an uninterrupted run,
        whichever side of the journal append the crash landed on.
        """
        expected = self.server_tick + 1
        frame: dict = {"type": "tick"}
        if budget is not None:
            frame["budget"] = budget

        def already_ran() -> dict:
            return {"type": "tick_report", "tick": self.server_tick,
                    "replayed": True}

        self.connect()
        if self.server_tick >= expected:
            # a reconnect (here or in a failed earlier call) landed on a
            # server that already ran this tick — don't run another
            return already_ran()
        with self._span(
            "wire.frame", type="tick", transport=self.transport,
            client=self.name,
        ):
            try:
                self._stream.send(frame)
                report = self._await("tick_report")
            except (OSError, TruncatedFrame):
                self._drop_stream()
                self._reconnect()
                if self.server_tick >= expected:
                    return already_ran()
                self._stream.send(frame)
                report = self._await("tick_report")
        self.server_tick = int(report.get("tick", self.server_tick))
        return report

    def drain(self, *, max_ticks: int = 1024) -> int:
        """Tick until every outstanding future is resolved (the remote
        analogue of :meth:`OffloadBroker.drain`).  Returns ticks run."""
        ran = 0
        while self._unresolved and ran < max_ticks:
            self.tick()
            ran += 1
        if self._unresolved:
            raise RuntimeError(
                f"{len(self._unresolved)} futures unresolved after "
                f"{ran} ticks"
            )
        return ran

    def register_batch(
        self,
        name: str,
        capacity: int,
        *,
        threshold: float = 0.10,
        min_interval: int = 1,
    ) -> RemoteBatchGroup:
        """Attach a server-side batch session group; returns its proxy."""
        ok = self._call(
            {
                "type": "register_batch",
                "tenant": name,
                "capacity": int(capacity),
                "threshold": float(threshold),
                "min_interval": int(min_interval),
            },
            "register_ok",
        )
        group = RemoteBatchGroup(self, ok["group"], int(capacity))
        self._groups[ok["group"]] = group
        return group

    def telemetry(self, *, metrics: bool = False) -> dict:
        """Server-side broker telemetry summary (+ cache stats, and the
        metrics-registry snapshot when ``metrics=True``)."""
        return self._call({"type": "telemetry", "metrics": metrics},
                          "telemetry_report")

    def snapshot(self) -> int:
        """Force a server snapshot pass; returns the covered journal seq."""
        return int(self._call({"type": "snapshot"}, "snapshot_ok")["seq"])

    def ping(self) -> None:
        """Liveness probe + flush barrier."""
        self._seq += 1
        nonce = f"{self.name}-ping-{self._seq}"
        self._call({"type": "ping", "nonce": nonce}, "pong", nonce=nonce)

    @property
    def unresolved(self) -> int:
        return len(self._unresolved)

    def __enter__(self) -> "BrokerClient":
        return self.connect()

    def __exit__(self, *exc) -> None:
        self.close()


def connect(address: tuple, **kwargs) -> BrokerClient:
    """``BrokerClient(address, **kwargs).connect()`` in one call."""
    return BrokerClient(address, **kwargs).connect()
