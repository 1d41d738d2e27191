"""Solver process: the wire-protocol front end that owns the device.

The management-plane / solver-worker split: one :class:`SolverServer`
process owns the GPU and the
:class:`~repro_torch.service.broker.OffloadBroker`; N client processes
host sessions (:mod:`repro_torch.service.client`) and talk
:mod:`repro_torch.service.wire` frames over a unix or TCP socket.  With
``backend="cuda"`` every solve of a tick (object-session flushes and the
``solve_envs`` flush of a batch group) launches its kernel in this
process.

Durability plane — what makes a crashed solver warm-startable:

* **Request journal** — every *accepted* submit is appended to a JSONL
  journal (write-ahead: the ``submit_ok`` ack is only sent after the
  entry is flushed), and every completed tick appends a tick marker.
  The journal is the replayable truth of what the broker was asked.
* **Background snapshot loop** — every ``snapshot_every_ticks`` ticks
  the server saves each tenant's
  :class:`~repro_torch.core.placement_cache.PlacementCache` (atomic
  ``os.replace`` writes) stamped with the journal sequence number and
  broker tick it covers, then compacts the journal down to the
  uncovered tail.  No caller ever calls ``save_snapshot`` explicitly.
* **Warm restart** — :meth:`SolverServer.recover` loads the snapshots
  (fingerprint-guarded; a foreign or corrupt snapshot cold-starts),
  fast-forwards the broker's tick counter to the snapshot tick, then
  replays the journal tail: re-submitting each journaled request and
  re-running each journaled tick.  On the reference backend the
  replayed replies are BIT-identical to the uninterrupted run — same
  placements, same prices, same tick numbers, same degraded flags; the
  GPU backend's kernels are deterministic, so there too.
* **Idempotent resubmission** — replies are remembered per request id;
  a resubmitted id that was already replayed (or is still queued) is
  acknowledged without re-journaling, re-queueing, or touching the
  cache, so a reconnecting client can blindly resubmit its unresolved
  window and cache stats are never double-counted.

The serve loop is a single-threaded ``selectors`` reactor: frames are
processed in arrival order, ticks are client-driven (a ``tick`` frame
runs exactly one broker tick), and the broker is never entered
concurrently — the determinism that makes cross-process replies
``==``-identical to an in-process broker fed the same submission order.

A :class:`~repro_torch.kernels.build.KernelError` (no device, failed
build, refused launch) is never answered with an error frame: it leaves
the serve loop and ends the process, as it leaves the broker's tick.

Observability: per-frame spans (``wire.frame`` with ``transport`` and
frame-type labels) nest the broker's own tick spans, and wire traffic
feeds ``wire_frames`` / ``wire_bytes`` counters plus a
``wire_frame_handle_s`` histogram when a
:class:`~repro_torch.obs.metrics.MetricsRegistry` is attached.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import selectors
import socket
import time
from typing import Callable

import numpy as np

from repro_torch.core.cost_models import EnvArrays
from repro_torch.core.session_batch import SessionTickReport
from repro_torch.kernels.build import KernelError
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import NULL_SPAN, Tracer
from repro_torch.service.broker import OffloadBroker, TickReport
from repro_torch.service.wire import (
    DEFAULT_MAX_FRAME,
    PROTOCOL_VERSION,
    BadFrame,
    FrameTooLarge,
    TruncatedFrame,
    WireError,
    decode_frame,
    encode_frame,
    error_frame,
    reply_to_wire,
    supported_encodings,
    wire_to_env,
)

__all__ = [
    "Journal",
    "SolverServer",
    "unix_address",
    "tcp_address",
    "tick_report_frame",
    "batch_report_frame",
]

JOURNAL_VERSION = 1


def unix_address(path) -> tuple:
    """Address tuple for a unix-domain socket at ``path``."""
    return ("unix", str(path))


def tcp_address(host: str = "127.0.0.1", port: int = 0) -> tuple:
    """Address tuple for a TCP socket (``port=0`` = ephemeral)."""
    return ("tcp", host, int(port))


def tick_report_frame(report: TickReport) -> dict:
    """The ``tick_report`` frame a server sends for one broker tick."""
    return {
        "type": "tick_report",
        "tick": report.tick,
        "requests": report.requests,
        "cache_hits": report.cache_hits,
        "coalesced": report.coalesced,
        "solved": report.solved,
        "dispatches": report.dispatches,
        "queue_depth": report.queue_depth,
        "degraded": report.degraded,
        "timed_out": report.timed_out,
        "rejected": report.rejected,
        "batch_groups": report.batch_groups,
        "batch_sessions": report.batch_sessions,
        "latency_s": report.latency_s,
    }


def batch_report_frame(gid: str, report: SessionTickReport) -> dict:
    """The ``batch_report`` frame a server pushes for one tick of the
    batch session group ``gid``."""
    degraded = 0 if report.degraded is None else int(report.degraded.sum())
    return {
        "type": "batch_report",
        "group": gid,
        "active": int(report.active.sum()),
        "due": report.due,
        "hits": report.hits,
        "solved": report.solved,
        "coalesced": report.coalesced,
        "degraded": degraded,
        "min_cut": [float(v) for v in report.min_cut],
        "gain": [float(v) for v in report.gain],
    }


class Journal:
    """Append-only JSONL write-ahead log of accepted work.

    Entries carry a monotonic ``seq``; ``replay`` tolerates a truncated
    final line (a SIGKILL mid-append) by skipping undecodable tail
    lines.  ``compact`` atomically rewrites the file keeping only
    entries newer than a sequence number — the snapshot loop's
    retention policy.
    """

    def __init__(self, path, *, fsync: bool = False):
        self.path = pathlib.Path(path)
        self.fsync = bool(fsync)
        self.seq = 0
        self._fh = None

    def open(self) -> None:
        if self._fh is None:
            fresh = not self.path.exists() or self.path.stat().st_size == 0
            self._fh = open(self.path, "a")
            if fresh:
                self.append({"op": "journal", "version": JOURNAL_VERSION})

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def append(self, entry: dict) -> int:
        """Write one entry (auto-assigned ``seq``), flushed before the
        caller proceeds — the write-ahead guarantee the submit ack
        relies on.  Returns the assigned sequence number."""
        self.open()
        self.seq += 1
        entry = {"seq": self.seq, **entry}
        self._fh.write(json.dumps(entry, separators=(",", ":")) + "\n")
        self._fh.flush()
        if self.fsync:
            os.fsync(self._fh.fileno())
        return self.seq

    @staticmethod
    def read(path) -> list[dict]:
        """All decodable entries of a journal file (missing file = []).

        A truncated or corrupt line — the tail a SIGKILL can leave —
        is skipped; entries after it still load (each line stands
        alone), preserving every whole record the kernel accepted.
        """
        path = pathlib.Path(path)
        if not path.exists():
            return []
        entries: list[dict] = []
        try:
            raw = path.read_text()
        except OSError:
            return []
        for line in raw.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                e = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(e, dict) and isinstance(e.get("seq"), int):
                entries.append(e)
        return entries

    def load(self) -> list[dict]:
        """Read the existing entries and adopt the highest seq so new
        appends continue the sequence."""
        entries = self.read(self.path)
        self.seq = max((e["seq"] for e in entries), default=0)
        return entries

    def compact(self, keep_after_seq: int) -> int:
        """Atomically drop entries with ``seq <= keep_after_seq``
        (they are covered by a snapshot).  Returns entries kept."""
        entries = [
            e
            for e in self.read(self.path)
            if e["seq"] > keep_after_seq and e.get("op") != "journal"
        ]
        tmp = self.path.with_name(self.path.name + ".compact.tmp")
        with open(tmp, "w") as f:
            f.write(
                json.dumps(
                    {"seq": 0, "op": "journal", "version": JOURNAL_VERSION},
                    separators=(",", ":"),
                )
                + "\n"
            )
            for e in entries:
                f.write(json.dumps(e, separators=(",", ":")) + "\n")
            f.flush()
            if self.fsync:
                os.fsync(f.fileno())
        was_open = self._fh is not None
        self.close()
        os.replace(tmp, self.path)
        if was_open:
            self._fh = open(self.path, "a")
        return len(entries)


@dataclasses.dataclass
class _Conn:
    sock: socket.socket
    addr: object
    stream_encoding: str = "json"
    buf: bytearray = dataclasses.field(default_factory=bytearray)
    outbox: bytearray = dataclasses.field(default_factory=bytearray)
    ready: bool = False            # hello completed
    name: str = "?"
    closing: bool = False          # close once the outbox drains


class SolverServer:
    """One solver process: wire frames in, broker replies out.

    Parameters:
      broker:   the :class:`~repro_torch.service.broker.OffloadBroker` this
                process owns.  Tenants must be registered *before*
                :meth:`recover` — the journal names tenants, it cannot
                reconstruct their profiles/cost models.
      address:  ``("unix", path)`` or ``("tcp", host, port)`` — see
                :func:`unix_address` / :func:`tcp_address`.
      journal_path: JSONL write-ahead log (``None`` disables the
                durability plane: no journal, no snapshots, no warm
                restart — an ephemeral solver).
      snapshot_dir: directory for per-tenant cache snapshots.
      snapshot_every_ticks: background snapshot cadence; every Nth tick
                the serve loop saves all tenant caches and compacts the
                journal.  Explicit ``snapshot`` frames force a pass.
      compact_journal: rewrite the journal to the uncovered tail at
                each snapshot (default True).
      max_frame: refuse frames larger than this many payload bytes.
      tracer / metrics: optional observability plane (pure observers).
      clock:    serve-loop clock for frame-handling timing only; never
                read unless metrics are attached.
    """

    def __init__(
        self,
        broker: OffloadBroker,
        *,
        address: tuple,
        journal_path=None,
        snapshot_dir=None,
        snapshot_every_ticks: int = 8,
        compact_journal: bool = True,
        fsync: bool = False,
        max_frame: int = DEFAULT_MAX_FRAME,
        tracer: Tracer | None = None,
        metrics: MetricsRegistry | None = None,
        clock: Callable[[], float] = time.perf_counter,
    ):
        if address[0] not in ("unix", "tcp"):
            raise ValueError(f"unknown address family {address[0]!r}")
        if snapshot_every_ticks <= 0:
            raise ValueError("snapshot_every_ticks must be positive")
        self.broker = broker
        self.address = address
        self.transport = address[0]
        self.journal = (
            Journal(journal_path, fsync=fsync)
            if journal_path is not None
            else None
        )
        self.snapshot_dir = (
            pathlib.Path(snapshot_dir) if snapshot_dir is not None else None
        )
        self.snapshot_every_ticks = int(snapshot_every_ticks)
        self.compact_journal = bool(compact_journal)
        self.max_frame = int(max_frame)
        self.tracer = tracer
        self.metrics = metrics
        self.clock = clock
        self._sel: selectors.BaseSelector | None = None
        self._listener: socket.socket | None = None
        self._running = False
        self._ticks_served = 0
        self._snapshot_seq = 0         # journal seq the last snapshot covers
        # request id → unresolved future / wire-encoded reply / owner conn
        self._inflight: dict[str, object] = {}
        self._replies: dict[str, dict] = {}
        self._owners: dict[str, _Conn] = {}
        # server-side batch session groups: gid → (group, tenant)
        self._groups: dict[str, object] = {}
        self._group_owner: dict[str, _Conn] = {}
        self._group_seq = 0

    # -- observability helpers ------------------------------------------
    def _span(self, name: str, **attrs):
        return (
            self.tracer.span(name, **attrs)
            if self.tracer is not None
            else NULL_SPAN
        )

    def _count_frame(self, direction: str, ftype: str, nbytes: int) -> None:
        if self.metrics is None:
            return
        self.metrics.counter(
            "wire_frames",
            direction=direction,
            type=ftype,
            transport=self.transport,
        ).inc()
        self.metrics.counter(
            "wire_bytes", direction=direction, transport=self.transport
        ).inc(nbytes)

    # -- durability plane ------------------------------------------------
    def _tenant_snapshot_path(self, name: str) -> pathlib.Path:
        return self.snapshot_dir / f"{name}.snapshot.json"

    def snapshot_now(self) -> int:
        """One background-loop pass: save every tenant cache (stamped
        with the covered journal seq + broker tick), then compact the
        journal to the uncovered tail.  Returns the covered seq."""
        if self.snapshot_dir is None or self.journal is None:
            return 0
        self.snapshot_dir.mkdir(parents=True, exist_ok=True)
        seq = self.journal.seq
        meta = {"journal_seq": seq, "tick": self.broker._tick}
        for name, t in self.broker._tenants.items():
            t.cache.save(
                self._tenant_snapshot_path(name),
                fingerprint=t.fingerprint,
                meta=meta,
            )
        self._snapshot_seq = seq
        if self.compact_journal:
            self.journal.compact(seq)
        return seq

    def recover(self) -> dict:
        """Warm-start from the persisted snapshots + journal tail.

        Loads each tenant's snapshot (fingerprint-guarded; rejects
        degrade to a cold cache and force a full-journal replay), sets
        the broker's tick counter to the snapshot's tick so replayed
        tick numbers line up with the uninterrupted history, then
        replays the journal tail: submits re-enter the queue in
        journal order and tick markers re-run ``broker.tick()``.
        Replayed replies land in the idempotent reply log, so clients
        resubmitting their unresolved window are answered without any
        re-solving or double-counted cache stats.

        Returns a summary dict (``replayed_submits``,
        ``replayed_ticks``, ``resume_tick``, ``resume_seq``).
        """
        if self.journal is None:
            return {
                "replayed_submits": 0,
                "replayed_ticks": 0,
                "resume_tick": self.broker._tick,
                "resume_seq": 0,
            }
        entries = self.journal.load()
        base_seq = 0
        base_tick = 0
        if self.snapshot_dir is not None and self.broker._tenants:
            metas = []
            for name, t in self.broker._tenants.items():
                _, meta = t.cache.load_with_meta(
                    self._tenant_snapshot_path(name), fingerprint=t.fingerprint
                )
                metas.append(meta)
            # every snapshot pass stamps all tenants with one (seq, tick);
            # a missing/rejected snapshot (meta None) forces replay from 0
            if metas and all(m is not None for m in metas):
                base_seq = min(int(m.get("journal_seq", 0)) for m in metas)
                base_tick = min(int(m.get("tick", 0)) for m in metas)
        self._snapshot_seq = base_seq
        self.broker.restore_tick(base_tick)
        submits = ticks = 0
        for e in entries:
            if e["seq"] <= base_seq:
                continue
            op = e.get("op")
            if op == "submit":
                rid = e.get("id")
                if rid in self._inflight or rid in self._replies:
                    continue
                try:
                    fut = self.broker.submit(
                        e["tenant"],
                        wire_to_env(e["env"]),
                        lane=e.get("lane", "user"),
                        deadline=e.get("deadline"),
                    )
                except Exception:
                    continue  # tenant no longer registered: drop the entry
                submits += 1
                if fut.done:
                    self._replies[rid] = reply_to_wire(fut.result)
                else:
                    self._inflight[rid] = fut
            elif op == "tick":
                self.broker.tick()
                ticks += 1
                self._harvest_resolved()
        return {
            "replayed_submits": submits,
            "replayed_ticks": ticks,
            "resume_tick": self.broker._tick,
            "resume_seq": self.journal.seq,
        }

    def _harvest_resolved(self) -> list[str]:
        """Move freshly resolved futures into the reply log; returns the
        resolved request ids (in insertion order)."""
        done = [
            rid for rid, fut in self._inflight.items() if fut.done
        ]
        for rid in done:
            fut = self._inflight.pop(rid)
            self._replies[rid] = reply_to_wire(fut.result)
        return done

    # -- socket plumbing -------------------------------------------------
    def bind(self) -> tuple:
        """Create + bind + listen; returns the effective address (the
        resolved port for ``("tcp", host, 0)``)."""
        if self.transport == "unix":
            path = self.address[1]
            try:
                os.unlink(path)
            except OSError:
                pass
            sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            sock.bind(path)
        else:
            sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            sock.bind((self.address[1], self.address[2]))
            self.address = ("tcp", *sock.getsockname())
        sock.listen(64)
        sock.setblocking(False)
        self._listener = sock
        self._sel = selectors.DefaultSelector()
        self._sel.register(sock, selectors.EVENT_READ, None)
        if self.journal is not None:
            self.journal.open()
        return self.address

    def close(self) -> None:
        if self._sel is not None:
            for key in list(self._sel.get_map().values()):
                if key.data is not None:
                    self._close_conn(key.data)
            self._sel.close()
            self._sel = None
        if self._listener is not None:
            self._listener.close()
            self._listener = None
        if self.transport == "unix":
            try:
                os.unlink(self.address[1])
            except OSError:
                pass
        if self.journal is not None:
            self.journal.close()

    def stop(self) -> None:
        self._running = False

    def serve_forever(
        self, *, max_ticks: int | None = None, poll_s: float = 0.1
    ) -> None:
        """Reactor loop: accept, read frames, answer.  Returns after
        ``max_ticks`` broker ticks have been served (``None`` = until
        :meth:`stop`)."""
        if self._sel is None:
            self.bind()
        self._running = True
        try:
            while self._running:
                for key, mask in self._sel.select(poll_s):
                    if key.data is None:
                        self._accept()
                    else:
                        conn = key.data
                        if mask & selectors.EVENT_WRITE:
                            self._flush_outbox(conn)
                        if mask & selectors.EVENT_READ:
                            self._on_readable(conn)
                if max_ticks is not None and self._ticks_served >= max_ticks:
                    break
        finally:
            self.close()

    def _accept(self) -> None:
        try:
            sock, addr = self._listener.accept()
        except OSError:
            return
        sock.setblocking(False)
        conn = _Conn(sock, addr)
        self._sel.register(sock, selectors.EVENT_READ, conn)
        if self.metrics is not None:
            self.metrics.gauge(
                "wire_connections", transport=self.transport
            ).add(1)

    def _close_conn(self, conn: _Conn) -> None:
        try:
            self._sel.unregister(conn.sock)
        except (KeyError, ValueError):
            pass
        try:
            conn.sock.close()
        except OSError:
            pass
        for rid, owner in list(self._owners.items()):
            if owner is conn:
                del self._owners[rid]
        for gid, owner in list(self._group_owner.items()):
            if owner is conn:
                del self._group_owner[gid]
        if self.metrics is not None:
            self.metrics.gauge(
                "wire_connections", transport=self.transport
            ).add(-1)

    def _interest(self, conn: _Conn) -> None:
        events = selectors.EVENT_READ
        if conn.outbox:
            events |= selectors.EVENT_WRITE
        try:
            self._sel.modify(conn.sock, events, conn)
        except (KeyError, ValueError):
            pass

    def _send(self, conn: _Conn, frame: dict) -> None:
        try:
            data = encode_frame(
                frame, encoding=conn.stream_encoding, max_frame=self.max_frame
            )
        except WireError:
            data = encode_frame(
                error_frame("server_error", "reply could not be encoded"),
                encoding=conn.stream_encoding,
                max_frame=self.max_frame,
            )
        conn.outbox.extend(data)
        self._count_frame("out", frame.get("type", "?"), len(data))
        self._flush_outbox(conn)

    def _flush_outbox(self, conn: _Conn) -> None:
        while conn.outbox:
            try:
                sent = conn.sock.send(bytes(conn.outbox))
            except BlockingIOError:
                break
            except OSError:
                self._close_conn(conn)
                return
            if sent == 0:
                break
            del conn.outbox[:sent]
        if conn.closing and not conn.outbox:
            self._close_conn(conn)
            return
        self._interest(conn)

    def _fail(self, conn: _Conn, code: str, message: str, *, close: bool,
              **extra) -> None:
        """Best-effort typed error frame; optionally schedule the close
        once it drains (framing errors poison the stream)."""
        self._send(conn, error_frame(code, message, **extra))
        if close:
            conn.closing = True
            self._flush_outbox(conn)

    def _on_readable(self, conn: _Conn) -> None:
        try:
            chunk = conn.sock.recv(65536)
        except BlockingIOError:
            return
        except OSError:
            self._close_conn(conn)
            return
        if not chunk:
            self._close_conn(conn)
            return
        conn.buf.extend(chunk)
        while True:
            try:
                frame, used = decode_frame(
                    bytes(conn.buf), max_frame=self.max_frame
                )
            except TruncatedFrame:
                return  # wait for more bytes
            except (FrameTooLarge, BadFrame) as err:
                # the length prefix cannot be trusted: no resync possible
                self._fail(conn, err.code, str(err), close=True)
                return
            del conn.buf[:used]
            self._handle_frame(conn, frame, used)
            if conn.closing:
                return

    # -- frame dispatch --------------------------------------------------
    def _handle_frame(self, conn: _Conn, frame: dict, nbytes: int) -> None:
        ftype = frame["type"]
        self._count_frame("in", ftype, nbytes)
        timer = (
            self.metrics.timer(
                "wire_frame_handle_s", transport=self.transport
            )
            if self.metrics is not None
            else NULL_SPAN
        )
        with timer, self._span(
            "wire.frame", type=ftype, transport=self.transport,
            client=conn.name,
        ):
            if not conn.ready:
                if ftype == "hello":
                    self._on_hello(conn, frame)
                else:
                    self._fail(
                        conn, "not_ready",
                        f"first frame must be hello, got {ftype!r}",
                        close=True,
                    )
                return
            handler = self._HANDLERS.get(ftype)
            if handler is None:
                self._fail(
                    conn, "unknown_type", f"unknown frame type {ftype!r}",
                    close=False,
                )
                return
            try:
                handler(self, conn, frame)
            except WireError as err:
                self._fail(conn, err.code, str(err), close=False)
            except KernelError:
                raise  # a kernel that cannot run is never answered for
            except Exception as err:  # noqa: BLE001 — serve loop must survive
                self._fail(
                    conn, "server_error",
                    f"{type(err).__name__}: {err}", close=False,
                )

    def _on_hello(self, conn: _Conn, frame: dict) -> None:
        version = frame.get("version")
        if version != PROTOCOL_VERSION:
            self._fail(
                conn, "version_mismatch",
                f"server speaks v{PROTOCOL_VERSION}, client sent {version!r}",
                close=True, server_version=PROTOCOL_VERSION,
            )
            return
        proposed = frame.get("encoding", "json")
        encoding = proposed if proposed in supported_encodings() else "json"
        conn.stream_encoding = encoding
        conn.name = str(frame.get("client", conn.name))
        conn.ready = True
        self._send(
            conn,
            {
                "type": "hello_ok",
                "version": PROTOCOL_VERSION,
                "encoding": encoding,
                "encodings": list(supported_encodings()),
                "backend": self.broker.backend,
                "tenants": sorted(self.broker._tenants),
                "max_frame": self.max_frame,
                "tick": self.broker._tick,
            },
        )

    def _on_submit(self, conn: _Conn, frame: dict) -> None:
        rid = frame.get("id")
        if not isinstance(rid, str) or not rid:
            raise BadFrame("submit needs a non-empty string 'id'")
        tenant = frame.get("tenant")
        if tenant not in self.broker._tenants:
            self._fail(
                conn, "unknown_tenant", f"no tenant {tenant!r}",
                close=False, id=rid,
            )
            return
        # idempotent resubmission: an id we already answered is served
        # from the reply log; an id still queued just re-binds its owner.
        # Neither touches the journal, the queue, or the cache counters.
        # reply rides BEFORE the ack so the client's future is already
        # resolved when the synchronous submit() returns — mirroring the
        # in-process broker, where an immediately-resolved future (e.g.
        # backpressure rejection) is .done at submit time.
        stored = self._replies.get(rid)
        if stored is not None:
            self._send(conn, {"type": "reply", "id": rid, **stored})
            self._send(conn, {"type": "submit_ok", "id": rid,
                              "replayed": True})
            return
        if rid in self._inflight:
            self._owners[rid] = conn
            self._send(conn, {"type": "submit_ok", "id": rid,
                              "replayed": True})
            return
        if self.broker._tenants[tenant].profile is None:
            self._fail(
                conn, "bad_request",
                f"tenant {tenant!r} has no profile; raw-graph submission "
                "is not supported over the wire", close=False, id=rid,
            )
            return
        env = wire_to_env(frame.get("env") or {})
        lane = frame.get("lane", "user")
        deadline = frame.get("deadline")
        if self.journal is not None:
            self.journal.append(
                {
                    "op": "submit",
                    "id": rid,
                    "tenant": tenant,
                    "env": frame["env"],
                    "lane": lane,
                    "deadline": deadline,
                }
            )
        fut = self.broker.submit(tenant, env, lane=lane, deadline=deadline)
        if fut.done:  # immediate backpressure rejection
            self._replies[rid] = reply_to_wire(fut.result)
            self._send(conn, {"type": "reply", "id": rid,
                              **self._replies[rid]})
        else:
            self._inflight[rid] = fut
            self._owners[rid] = conn
        self._send(conn, {"type": "submit_ok", "id": rid, "replayed": False})

    def _on_tick(self, conn: _Conn, frame: dict) -> None:
        budget = frame.get("budget")
        report = self.broker.tick(budget=budget)
        self._ticks_served += 1
        if self.journal is not None:
            self.journal.append({"op": "tick", "tick": report.tick})
        for rid in self._harvest_resolved():
            owner = self._owners.pop(rid, None)
            if owner is not None:
                self._send(
                    owner,
                    {"type": "reply", "id": rid, **self._replies[rid]},
                )
        self._flush_group_reports()
        self._send(conn, tick_report_frame(report))
        if (
            self.journal is not None
            and self.snapshot_dir is not None
            and self._ticks_served % self.snapshot_every_ticks == 0
        ):
            with self._span("wire.snapshot", transport=self.transport):
                self.snapshot_now()

    def _on_register_batch(self, conn: _Conn, frame: dict) -> None:
        tenant = frame.get("tenant")
        if tenant not in self.broker._tenants:
            self._fail(conn, "unknown_tenant", f"no tenant {tenant!r}",
                       close=False)
            return
        capacity = frame.get("capacity")
        if not isinstance(capacity, int) or capacity <= 0:
            raise BadFrame("register_batch needs a positive int 'capacity'")
        group = self.broker.register_batch(
            tenant,
            capacity,
            threshold=float(frame.get("threshold", 0.10)),
            min_interval=int(frame.get("min_interval", 1)),
        )
        self._group_seq += 1
        gid = f"{tenant}#{self._group_seq}"
        self._groups[gid] = group
        self._group_owner[gid] = conn
        self._send(
            conn,
            {"type": "register_ok", "group": gid, "capacity": capacity},
        )

    def _on_observe_batch(self, conn: _Conn, frame: dict) -> None:
        gid = frame.get("group")
        group = self._groups.get(gid)
        if group is None:
            self._fail(conn, "unknown_group", f"no batch group {gid!r}",
                       close=False)
            return
        envs = frame.get("envs")
        try:
            arrays = EnvArrays(
                *[
                    np.asarray(envs[f], dtype=np.float64)
                    for f in EnvArrays._fields
                ]
            )
        except (KeyError, TypeError, ValueError) as err:
            raise BadFrame(f"malformed envs: {err}") from None
        group.observe(
            arrays,
            arrived=frame.get("arrived"),
            departed=frame.get("departed"),
        )
        self._group_owner[gid] = conn
        self._send(conn, {"type": "observe_ok", "group": gid})

    def _flush_group_reports(self) -> None:
        """Push each just-ticked group's summary to its owner."""
        for gid, group in self._groups.items():
            for report in group.drain():
                owner = self._group_owner.get(gid)
                if owner is not None:
                    self._send(owner, batch_report_frame(gid, report))

    def _on_telemetry(self, conn: _Conn, frame: dict) -> None:
        caches = {
            name: dataclasses.asdict(t.cache.stats)
            for name, t in self.broker._tenants.items()
        }
        out = {
            "type": "telemetry_report",
            "summary": self.broker.telemetry.summary(),
            "caches": caches,
            "tick": self.broker._tick,
            "inflight": len(self._inflight),
            "journal_seq": self.journal.seq if self.journal else 0,
        }
        if frame.get("metrics") and self.metrics is not None:
            out["metrics"] = self.metrics.snapshot()
        self._send(conn, out)

    def _on_snapshot(self, conn: _Conn, frame: dict) -> None:
        seq = self.snapshot_now()
        self._send(conn, {"type": "snapshot_ok", "seq": seq})

    def _on_ping(self, conn: _Conn, frame: dict) -> None:
        self._send(conn, {"type": "pong", "nonce": frame.get("nonce")})

    def _on_bye(self, conn: _Conn, frame: dict) -> None:
        conn.closing = True
        self._flush_outbox(conn)

    _HANDLERS = {
        "submit": _on_submit,
        "tick": _on_tick,
        "register_batch": _on_register_batch,
        "observe_batch": _on_observe_batch,
        "telemetry": _on_telemetry,
        "snapshot": _on_snapshot,
        "ping": _on_ping,
        "bye": _on_bye,
    }
