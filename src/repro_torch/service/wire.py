"""Length-prefixed frame protocol for the cross-process serving plane.

The transport of the broker tick machinery, the same protocol as the JAX
package's ``repro.service.wire``: for the same frame dict both encode the
same bytes, so a client of either package talks to a server of the other.
A *frame* is one protocol message:

    +----------------+-----------+----------------------+
    | 4B big-endian  | 1B        | payload              |
    | payload length | encoding  | (json or msgpack)    |
    +----------------+-----------+----------------------+

The payload decodes to a dict carrying a ``"type"`` key.  Frame types:

==================  ==================================================
``hello``           client → server: protocol ``version``, proposed
                    ``encoding``, ``client`` name.
``hello_ok``        server → client: accepted ``version``/``encoding``,
                    broker ``backend``, registered ``tenants``,
                    ``max_frame``, supported ``encodings``.
``submit``          client → server: ``id`` (request id), ``tenant``,
                    ``env`` (six float64 scalars), ``lane``,
                    optional ``deadline`` (ticks).
``submit_ok``       server → client: ``id`` journaled and queued
                    (``replayed=True`` when the id was already known —
                    the idempotent-resubmission ack).
``reply``           server → client: resolved
                    :class:`~repro_torch.service.broker.BrokerReply` for
                    ``id`` (``min_cut`` + ``local_mask`` + flags).
``tick``            client → server: run one broker tick.
``tick_report``     server → client: the tick's
                    :class:`~repro_torch.service.broker.TickReport` summary.
``observe_batch``   client → server: stage one tick of EnvArrays rows
                    on a server-side batch session group.
``batch_report``    server → client: the group's per-tick summary.
``telemetry``       client → server: request telemetry;
``telemetry_report``server → client: broker telemetry summary +
                    cache stats + optional metrics-registry snapshot.
``snapshot``        client → server: force a snapshot pass now.
``snapshot_ok``     server → client: snapshot written (``seq``).
``ping``/``pong``   liveness + flush barrier (a ``pong`` proves every
                    earlier pushed frame was delivered).
``error``           either direction: typed failure — ``code`` below.
``bye``             client → server: clean close.
==================  ==================================================

Error codes (``ERROR_CODES``): ``version_mismatch``, ``bad_frame``,
``too_large``, ``unknown_type``, ``unknown_tenant``, ``unknown_group``,
``bad_request``, ``not_ready``, ``server_error``.  Framing-level errors
(``bad_frame``/``too_large``) poison the byte stream — the peer sends a
best-effort error frame and disconnects, because there is no way to
resynchronize on a corrupt length prefix.  Frame-content errors
(``unknown_*``/``bad_request``) keep the connection open.

Determinism contract: JSON float64 round-trips are exact (shortest
round-trip repr), so an :class:`~repro_torch.core.cost_models.Environment`
or a reply's ``min_cut`` crossing the wire is BIT-identical on both
sides — what makes the cross-process parity and crash-recovery tests
``==``-exact.  msgpack (optional, negotiated at hello) carries float64
natively and is exact too.
"""

from __future__ import annotations

import json
import socket
import struct
from typing import Tuple

import numpy as np

from repro_torch.core.cost_models import Environment
from repro_torch.core.mcop import MCOPResult
from repro_torch.service.broker import BrokerReply

try:  # optional wire encoding; JSON is always available
    import msgpack as _msgpack

    HAVE_MSGPACK = True
except ModuleNotFoundError:  # pragma: no cover — minimal container
    _msgpack = None
    HAVE_MSGPACK = False

__all__ = [
    "PROTOCOL_VERSION",
    "DEFAULT_MAX_FRAME",
    "ENCODINGS",
    "ERROR_CODES",
    "WireError",
    "BadFrame",
    "FrameTooLarge",
    "TruncatedFrame",
    "VersionMismatch",
    "RemoteError",
    "encode_frame",
    "decode_frame",
    "FrameStream",
    "env_to_wire",
    "wire_to_env",
    "reply_to_wire",
    "wire_to_reply",
    "error_frame",
    "supported_encodings",
]

PROTOCOL_VERSION = 1

# 4-byte length + 1-byte encoding tag
_HEADER = struct.Struct("!IB")
HEADER_SIZE = _HEADER.size

# A frame larger than this is refused on both encode and decode: the
# serving plane moves scalars and (n,)-bool masks, never tensors, so a
# multi-megabyte frame is a protocol violation, not a big request.
DEFAULT_MAX_FRAME = 1 << 20

ENCODINGS = {"json": 0, "msgpack": 1}
_ENCODING_NAMES = {v: k for k, v in ENCODINGS.items()}

ERROR_CODES = (
    "version_mismatch",
    "bad_frame",
    "too_large",
    "unknown_type",
    "unknown_tenant",
    "unknown_group",
    "bad_request",
    "not_ready",
    "server_error",
)


def supported_encodings() -> tuple[str, ...]:
    """Encodings this process can decode (JSON always; msgpack when
    the optional dependency is importable)."""
    return ("json", "msgpack") if HAVE_MSGPACK else ("json",)


class WireError(Exception):
    """Base protocol failure; ``code`` names the typed error frame the
    peer should see."""

    code = "bad_frame"


class BadFrame(WireError):
    """Undecodable payload, unknown encoding tag, or a non-dict frame."""

    code = "bad_frame"


class FrameTooLarge(WireError):
    """Declared (or would-be encoded) length past the max-frame bound."""

    code = "too_large"


class TruncatedFrame(WireError):
    """EOF mid-frame: the peer vanished between a header and its payload."""

    code = "bad_frame"


class VersionMismatch(WireError):
    """Hello carried an unsupported protocol version."""

    code = "version_mismatch"


class RemoteError(WireError):
    """An ``error`` frame received from the peer, re-raised locally."""

    def __init__(self, code: str, message: str = ""):
        super().__init__(f"{code}: {message}" if message else code)
        self.code = code
        self.message = message


def error_frame(code: str, message: str = "", **extra) -> dict:
    """Build a typed ``error`` frame (``code`` must be a known code)."""
    if code not in ERROR_CODES:
        raise ValueError(f"unknown error code {code!r}")
    frame = {"type": "error", "code": code, "message": message}
    frame.update(extra)
    return frame


# ----------------------------------------------------------------------
# codec
# ----------------------------------------------------------------------
def encode_frame(
    obj: dict, *, encoding: str = "json", max_frame: int = DEFAULT_MAX_FRAME
) -> bytes:
    """Serialize one frame (header + payload).  Raises
    :class:`FrameTooLarge` when the encoded payload would exceed
    ``max_frame`` and :class:`BadFrame` for an unknown encoding."""
    tag = ENCODINGS.get(encoding)
    if tag is None:
        raise BadFrame(f"unknown encoding {encoding!r}")
    if encoding == "msgpack":
        if not HAVE_MSGPACK:
            raise BadFrame("msgpack encoding requested but not installed")
        payload = _msgpack.packb(obj, use_bin_type=True)
    else:
        payload = json.dumps(obj, separators=(",", ":")).encode()
    if len(payload) > max_frame:
        raise FrameTooLarge(
            f"frame payload {len(payload)}B exceeds max {max_frame}B"
        )
    return _HEADER.pack(len(payload), tag) + payload


def decode_frame(
    buf: bytes, *, max_frame: int = DEFAULT_MAX_FRAME
) -> Tuple[dict, int]:
    """Decode one frame from the head of ``buf``.

    Returns ``(frame, consumed_bytes)``.  Raises :class:`TruncatedFrame`
    when ``buf`` holds less than one whole frame (callers with a live
    stream treat that as "read more"), :class:`FrameTooLarge` /
    :class:`BadFrame` on protocol violations.
    """
    if len(buf) < HEADER_SIZE:
        raise TruncatedFrame(f"{len(buf)}B is shorter than a frame header")
    length, tag = _HEADER.unpack_from(buf)
    if length > max_frame:
        raise FrameTooLarge(
            f"declared payload {length}B exceeds max {max_frame}B"
        )
    end = HEADER_SIZE + length
    if len(buf) < end:
        raise TruncatedFrame(f"payload truncated at {len(buf) - HEADER_SIZE}B")
    payload = buf[HEADER_SIZE:end]
    name = _ENCODING_NAMES.get(tag)
    if name is None:
        raise BadFrame(f"unknown encoding tag {tag}")
    try:
        if name == "msgpack":
            if not HAVE_MSGPACK:
                raise BadFrame("msgpack frame received but not installed")
            obj = _msgpack.unpackb(payload, raw=False)
        else:
            obj = json.loads(payload.decode())
    except BadFrame:
        raise
    except Exception as err:  # undecodable payload, whatever the cause
        raise BadFrame(f"undecodable {name} payload: {err}") from None
    if not isinstance(obj, dict) or not isinstance(obj.get("type"), str):
        raise BadFrame("frame payload is not a dict with a 'type'")
    return obj, end


class FrameStream:
    """Blocking framed view over a connected socket.

    One instance per connection per side.  ``send`` writes one whole
    frame; ``recv`` returns the next frame, ``None`` on a clean EOF at
    a frame boundary, and raises :class:`TruncatedFrame` on EOF
    mid-frame, :class:`FrameTooLarge`/:class:`BadFrame` on corrupt
    bytes (after which the stream is unusable — there is no resync).
    ``socket.timeout`` propagates so callers can bound every read.
    """

    def __init__(
        self,
        sock: socket.socket,
        *,
        encoding: str = "json",
        max_frame: int = DEFAULT_MAX_FRAME,
    ):
        if encoding not in ENCODINGS:
            raise BadFrame(f"unknown encoding {encoding!r}")
        self.sock = sock
        self.encoding = encoding
        self.max_frame = int(max_frame)
        self._buf = bytearray()
        self.bytes_in = 0
        self.bytes_out = 0

    def send(self, frame: dict) -> int:
        data = encode_frame(
            frame, encoding=self.encoding, max_frame=self.max_frame
        )
        self.sock.sendall(data)
        self.bytes_out += len(data)
        return len(data)

    def recv(self, timeout: float | None = None) -> dict | None:
        """Next frame (``None`` = clean EOF).  ``timeout`` overrides the
        socket timeout for this read only."""
        if timeout is not None:
            self.sock.settimeout(timeout)
        while True:
            try:
                frame, used = decode_frame(
                    bytes(self._buf), max_frame=self.max_frame
                )
            except TruncatedFrame:
                chunk = self.sock.recv(65536)
                if not chunk:
                    if self._buf:
                        raise TruncatedFrame(
                            f"EOF with {len(self._buf)}B of partial frame"
                        ) from None
                    return None
                self.bytes_in += len(chunk)
                self._buf.extend(chunk)
                continue
            del self._buf[:used]
            return frame

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


# ----------------------------------------------------------------------
# value serialization (bit-exact float64 round trips)
# ----------------------------------------------------------------------
_ENV_FIELDS = (
    "bandwidth_up",
    "bandwidth_down",
    "speedup",
    "p_compute",
    "p_idle",
    "p_transfer",
)


def env_to_wire(env: Environment) -> dict:
    return {f: float(getattr(env, f)) for f in _ENV_FIELDS}


def wire_to_env(d: dict) -> Environment:
    try:
        return Environment(**{f: float(d[f]) for f in _ENV_FIELDS})
    except (KeyError, TypeError, ValueError) as err:
        raise BadFrame(f"malformed env: {err}") from None


def reply_to_wire(reply) -> dict:
    """Serialize a :class:`~repro_torch.service.broker.BrokerReply`.

    ``phases`` are deliberately dropped: they are solver provenance, not
    part of the serving contract, and every existing consumer
    (controllers, sessions, fallbacks) treats them as optional.
    """
    res = reply.result
    return {
        "result": None
        if res is None
        else {
            "min_cut": float(res.min_cut),
            "local_mask": [int(b) for b in np.asarray(res.local_mask, bool)],
        },
        "cache_hit": bool(reply.cache_hit),
        "coalesced": bool(reply.coalesced),
        "tick": int(reply.tick),
        "rejected": bool(reply.rejected),
        "degraded": bool(reply.degraded),
        "timed_out": bool(reply.timed_out),
    }


def wire_to_reply(d: dict):
    """Rehydrate a :class:`~repro_torch.service.broker.BrokerReply`."""
    try:
        res = d["result"]
        result = (
            None
            if res is None
            else MCOPResult(
                min_cut=float(res["min_cut"]),
                local_mask=np.asarray(res["local_mask"], dtype=bool),
                phases=[],
            )
        )
        return BrokerReply(
            result,
            cache_hit=bool(d["cache_hit"]),
            coalesced=bool(d["coalesced"]),
            tick=int(d["tick"]),
            rejected=bool(d["rejected"]),
            degraded=bool(d["degraded"]),
            timed_out=bool(d["timed_out"]),
        )
    except (KeyError, TypeError, ValueError) as err:
        raise BadFrame(f"malformed reply: {err}") from None
