"""The port's wire protocol against the JAX package's, byte for byte.

For the same frame dict ``repro_torch.service.wire.encode_frame`` must give
the bytes ``repro.service.wire.encode_frame`` gives (JSON, and msgpack where
it is installed); environments and replies cross bit-exactly in both
directions; hostile bytes give the same typed errors on both sides; and a
live port server answers the protocol's edge cases as the JAX server does.
Every socket read is timeout-bounded.
"""

import dataclasses
import socket
import struct
import threading

import numpy as np
import pytest

import repro.core as J
import repro.service.wire as JW
import repro_torch.core as T
import repro_torch.service.wire as TW
from repro.core.mcop import MCOPResult as JResult
from repro.service.broker import BrokerReply as JReply
from repro_torch.core.mcop import MCOPResult as TResult
from repro_torch.service import OffloadBroker, SolverServer, unix_address
from repro_torch.service.broker import BrokerReply as TReply

pytestmark = pytest.mark.service

TIMEOUT = 10.0

_ENV = {"bandwidth_up": 1 / 3, "bandwidth_down": 2.25, "speedup": np.pi,
        "p_compute": 0.7, "p_idle": 0.01, "p_transfer": 0.3}
_REPLY = {"result": {"min_cut": 1 / 7, "local_mask": [1, 0, 1]},
          "cache_hit": True, "coalesced": False, "tick": 41, "rejected": False,
          "degraded": True, "timed_out": False}

# one frame of every type the protocol has, as the servers and clients build them
FRAMES = {
    "hello": {"type": "hello", "version": 1, "encoding": "json", "client": "c"},
    "hello_ok": {"type": "hello_ok", "version": 1, "encoding": "json",
                 "encodings": ["json", "msgpack"], "backend": "cuda",
                 "tenants": ["app"], "max_frame": 1 << 20, "tick": 3},
    "submit": {"type": "submit", "id": "c-1", "tenant": "app", "env": _ENV,
               "lane": "user", "deadline": None},
    "submit_ok": {"type": "submit_ok", "id": "c-1", "replayed": False},
    "reply": {"type": "reply", "id": "c-1", **_REPLY},
    "reply_none": {"type": "reply", "id": "c-2", **_REPLY, "result": None},
    "tick": {"type": "tick", "budget": 4},
    "tick_report": {"type": "tick_report", "tick": 4, "requests": 9,
                    "cache_hits": 2, "coalesced": 3, "solved": 4, "dispatches": 1,
                    "queue_depth": 9, "degraded": 0, "timed_out": 0, "rejected": 0,
                    "batch_groups": 1, "batch_sessions": 17, "latency_s": 0.0},
    "register_batch": {"type": "register_batch", "tenant": "app", "capacity": 8,
                       "threshold": 0.15, "min_interval": 2},
    "register_ok": {"type": "register_ok", "group": "app#1", "capacity": 8},
    "observe_batch": {"type": "observe_batch", "group": "app#1",
                      "envs": {k: [v, v / 3] for k, v in _ENV.items()},
                      "arrived": [0, 1], "departed": [5]},
    "observe_ok": {"type": "observe_ok", "group": "app#1"},
    "batch_report": {"type": "batch_report", "group": "app#1", "active": 2,
                     "due": 2, "hits": 0, "solved": 1, "coalesced": 1,
                     "degraded": 0, "min_cut": [0.1 + 0.2, float("inf")],
                     "gain": [1e-300, -0.0]},
    "telemetry": {"type": "telemetry", "metrics": True},
    "telemetry_report": {"type": "telemetry_report",
                         "summary": {"ticks": 3, "hit_rate": 0.25},
                         "caches": {"app": {"hits": 1, "misses": 3}},
                         "tick": 3, "inflight": 0, "journal_seq": 12},
    "snapshot": {"type": "snapshot"},
    "snapshot_ok": {"type": "snapshot_ok", "seq": 12},
    "ping": {"type": "ping", "nonce": "c-ping-3"},
    "pong": {"type": "pong", "nonce": "c-ping-3"},
    "error": {"type": "error", "code": "unknown_tenant", "message": "no tenant 'x'",
              "id": "c-9"},
    "bye": {"type": "bye"},
}

ENCODINGS = [e for e in ("json", "msgpack") if e in JW.supported_encodings()]


def _bits(x: float) -> bytes:
    return struct.pack("<d", x)


def test_protocol_constants_and_error_codes_match():
    assert TW.PROTOCOL_VERSION == JW.PROTOCOL_VERSION
    assert TW.DEFAULT_MAX_FRAME == JW.DEFAULT_MAX_FRAME
    assert TW.HEADER_SIZE == JW.HEADER_SIZE
    assert TW.ENCODINGS == JW.ENCODINGS
    assert TW.ERROR_CODES == JW.ERROR_CODES
    assert TW.supported_encodings() == JW.supported_encodings()
    for name in ("WireError", "BadFrame", "FrameTooLarge", "TruncatedFrame",
                 "VersionMismatch"):
        assert getattr(TW, name).code == getattr(JW, name).code
    for code in TW.ERROR_CODES:
        assert TW.error_frame(code, "m", id="x") == JW.error_frame(code, "m", id="x")
    with pytest.raises(ValueError):
        TW.error_frame("made_up_code")


@pytest.mark.parametrize("encoding", ENCODINGS)
@pytest.mark.parametrize("name", sorted(FRAMES))
def test_frames_are_byte_identical(name, encoding):
    frame = FRAMES[name]
    data = TW.encode_frame(frame, encoding=encoding)
    assert data == JW.encode_frame(frame, encoding=encoding)
    out, used = TW.decode_frame(data)
    want, want_used = JW.decode_frame(data)
    assert used == want_used == len(data)
    # floats decode to the same bits (the frames hold inf and -0.0: compare
    # through the encoder, which is exact)
    assert TW.encode_frame(out, encoding=encoding) == data
    assert JW.encode_frame(want, encoding=encoding) == data


@pytest.mark.parametrize("seed", range(4))
def test_env_round_trip_is_bit_exact_across_packages(seed):
    rng = np.random.default_rng(seed)
    vals = np.exp(rng.uniform(-300, 300, 6)) if seed % 2 else rng.uniform(1e-3, 10, 6)
    fields = [f.name for f in dataclasses.fields(J.Environment)]
    env_j = J.Environment(**dict(zip(fields, map(float, vals))))
    env_t = T.Environment(**dict(zip(fields, map(float, vals))))
    wire = {"type": "submit", "env": TW.env_to_wire(env_t)}
    wire_j = {"type": "submit", "env": JW.env_to_wire(env_j)}
    assert TW.encode_frame(wire) == JW.encode_frame(wire_j)
    for decode, encoded in ((TW.wire_to_env, wire_j), (JW.wire_to_env, wire)):
        back = decode(JW.decode_frame(JW.encode_frame(encoded))[0]["env"])
        assert [_bits(getattr(back, f)) for f in fields] == [
            _bits(getattr(env_j, f)) for f in fields]
    with pytest.raises(TW.BadFrame):
        TW.wire_to_env({"bandwidth_up": 1.0})


@pytest.mark.parametrize("solved", [True, False])
def test_reply_round_trip_is_bit_exact_across_packages(solved):
    mask = np.array([True, False, True, True])

    def reply(R, M):
        res = M(min_cut=1 / 7, local_mask=mask, phases=[]) if solved else None
        return R(res, cache_hit=True, coalesced=False, tick=41, degraded=solved,
                 timed_out=not solved)

    wire_t = {"type": "reply", "id": "c-1", **TW.reply_to_wire(reply(TReply, TResult))}
    wire_j = {"type": "reply", "id": "c-1", **JW.reply_to_wire(reply(JReply, JResult))}
    assert wire_t == wire_j
    assert TW.encode_frame(wire_t) == JW.encode_frame(wire_j)
    for decode in (TW.wire_to_reply, JW.wire_to_reply):
        out = decode(TW.decode_frame(TW.encode_frame(wire_t))[0])
        assert (out.cache_hit, out.coalesced, out.tick, out.rejected, out.degraded,
                out.timed_out) == (True, False, 41, False, solved, not solved)
        if solved:
            assert _bits(out.result.min_cut) == _bits(1 / 7)
            assert np.array_equal(out.result.local_mask, mask)
        else:
            assert out.result is None
    assert type(TW.wire_to_reply(wire_j)) is TReply
    with pytest.raises(TW.BadFrame):
        TW.wire_to_reply({"result": None})


def _outcome(decode, blob):
    try:
        frame, used = decode(blob)
    except Exception as err:  # noqa: BLE001 — the class is what is compared
        return type(err).__name__, getattr(err, "code", None)
    return TW.encode_frame(frame), used


def test_hostile_bytes_give_the_same_typed_errors():
    """Truncation at every offset, malformed payloads, oversized headers,
    seeded garbage and bit flips: the port's decoder ends each exactly as
    the reference's does, and only ever in a WireError or a frame."""
    valid = TW.encode_frame({"type": "submit", "id": "x" * 32})
    blobs = [valid[:cut] for cut in range(len(valid) + 1)]
    blobs += [
        struct.pack("!IB", 4, 0) + b"nope",
        struct.pack("!IB", 4, 9) + b"\0\0\0\0",
        struct.pack("!IB", 2, 0) + b"[]",
        struct.pack("!IB", 2, 0) + b"{}",
        struct.pack("!IB", 12, 0) + b'{"type": 42}',
        struct.pack("!IB", TW.DEFAULT_MAX_FRAME + 1, 0),
    ]
    rng = np.random.default_rng(1234)
    blobs += [rng.bytes(int(rng.integers(0, 96))) for _ in range(128)]
    for _ in range(128):
        flipped = bytearray(valid)
        flipped[int(rng.integers(len(valid)))] ^= int(rng.integers(1, 256))
        blobs.append(bytes(flipped))
    for blob in blobs:
        got = _outcome(TW.decode_frame, blob)
        assert got == _outcome(JW.decode_frame, blob)
        assert isinstance(got[1], int) or got[0] in (
            "BadFrame", "FrameTooLarge", "TruncatedFrame")
    with pytest.raises(TW.FrameTooLarge):
        TW.encode_frame({"type": "t", "blob": "x" * TW.DEFAULT_MAX_FRAME})


# ----------------------------------------------------------------------
# a live port server (in a thread), bounded reads
# ----------------------------------------------------------------------
@pytest.fixture
def live_server(tmp_path):
    profile = T.AppProfile.from_wcg_times(T.random_wcg(10, rng=np.random.default_rng(0)))
    broker = OffloadBroker(backend="reference", device="cpu", clock=lambda: 0.0)
    broker.register("app", profile, T.ResponseTimeModel())
    server = SolverServer(broker, address=unix_address(tmp_path / "srv.sock"),
                          journal_path=tmp_path / "journal.jsonl",
                          snapshot_dir=tmp_path / "snaps")
    server.bind()
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield server
    server.stop()
    thread.join(timeout=TIMEOUT)
    assert not thread.is_alive()


def _raw(server, **hello):
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    sock.settimeout(TIMEOUT)
    sock.connect(server.address[1])
    stream = TW.FrameStream(sock)
    stream.send({"type": "hello", "version": TW.PROTOCOL_VERSION,
                 "encoding": "json", "client": "conformance", **hello})
    return stream


def test_server_refuses_a_wrong_version_and_closes(live_server):
    stream = _raw(live_server, version=TW.PROTOCOL_VERSION + 13)
    reply = stream.recv(TIMEOUT)
    assert (reply["type"], reply["code"]) == ("error", "version_mismatch")
    assert reply["server_version"] == TW.PROTOCOL_VERSION
    assert stream.recv(TIMEOUT) is None
    stream.close()


@pytest.mark.parametrize("attack", ["garbage", "oversized"])
def test_server_answers_framing_errors_then_disconnects(live_server, attack):
    stream = _raw(live_server)
    ok = stream.recv(TIMEOUT)
    assert ok["type"] == "hello_ok" and ok["tenants"] == ["app"]
    assert ok["backend"] == "reference"
    stream.sock.sendall(b"\xff" * 64 if attack == "garbage"
                        else struct.pack("!IB", TW.DEFAULT_MAX_FRAME + 1, 0))
    reply = stream.recv(TIMEOUT)
    assert reply["type"] == "error" and reply["code"] == "too_large"
    assert stream.recv(TIMEOUT) is None
    stream.close()


def test_server_content_errors_keep_the_connection_open(live_server):
    stream = _raw(live_server)
    assert stream.recv(TIMEOUT)["type"] == "hello_ok"
    env = TW.env_to_wire(T.Environment.symmetric(2.0, 3.0))
    for frame, code in (
        ({"type": "frobnicate"}, "unknown_type"),
        ({"type": "submit", "id": "q-1", "tenant": "ghost", "env": env},
         "unknown_tenant"),
        ({"type": "submit", "tenant": "app"}, "bad_frame"),
        ({"type": "observe_batch", "group": "none#1", "envs": {}}, "unknown_group"),
    ):
        stream.send(frame)
        reply = stream.recv(TIMEOUT)
        assert (reply["type"], reply["code"]) == ("error", code)
    stream.send({"type": "ping", "nonce": "still-alive"})
    assert stream.recv(TIMEOUT) == {"type": "pong", "nonce": "still-alive"}
    stream.send({"type": "bye"})
    assert stream.recv(TIMEOUT) is None
    stream.close()
