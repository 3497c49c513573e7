"""Versioned length-prefixed wire protocol for the render gateway (a copy
of the JAX package's ``frontend/protocol.py``: the same bytes on the wire;
``camera_from_wire`` returns the port's ``Camera`` with numpy leaves).

Every message is one frame on the TCP stream:

  +----+---+---+------------+-------------+----------------+---------------+
  | GS | v | 0 | header_len | payload_len | header (JSON)  | payload (raw) |
  +----+---+---+------------+-------------+----------------+---------------+
   2B   1B  1B   uint32 BE     uint32 BE     header_len B     payload_len B

The JSON header carries the message ``type`` plus small structured fields
(stream id, sequence number, camera, encoding metadata); bulk bytes — the
encoded frame — ride in the raw payload, never through JSON. The format is
dependency-free (``struct`` + ``json``), explicit about byte order, and
versioned: a peer speaking a different major version is rejected at the
first frame, not by a mid-stream parse explosion.

Message types (header["type"]):

  hello / hello_ok     handshake; hello_ok lists the registered streams
  render               one camera at (stream, timestep) -> one ``frame``
  scrub                one camera across many timesteps -> many ``frame``s
  frame                response payload = encoded RGB8 (see ``encode.py``)
  stats / stats_ok     gateway + serving-engine metrics snapshot
  metrics / metrics_ok atomic typed-registry snapshot (v2; flat dotted names)
  error                failure for a specific seq (code: shed/bad_request/...)
  bye                  client-initiated clean shutdown of the connection

Requests carry a client-chosen ``seq``; every response names the ``seq`` it
answers, so one connection can hold many requests in flight (the gateway
sheds overload per-session by answering queued seqs with ``error/shed``).

**Versioning.** Two numbers, two jobs. ``VERSION`` (the prefix byte) is the
*framing* version — how bytes become messages — and only changes if the
prefix layout does. ``PROTOCOL`` is the *application* version, negotiated in
``hello``: the client sends ``{"protocol": <its max>, "encodings": [...]}``,
the gateway answers ``hello_ok`` with ``min(client, server)`` and the frame
encodings it will actually use. Protocol v2 adds the ``tiles8``
changed-tile frame encoding (see ``encode.py``); a v1 peer (or a hello with
no ``protocol`` field) falls back to the v1 ``zdelta8``/``rgb8`` wire
format, so old clients keep working against new gateways and vice versa.

``render``/``scrub`` headers may additionally carry two OPTIONAL foveated-
serving hints — ``gaze`` (normalized ``[x, y]`` in [0, 1]) and
``budget_ms`` (positive float render-time budget). Absent fields mean
uniform-LOD serving, and old gateways ignore unknown header fields, so
these ride within PROTOCOL 2 rather than bumping it.
"""
from __future__ import annotations

import json
import struct
from typing import Iterator

import numpy as np

from repro_torch.core.projection import Camera

MAGIC = b"GS"
VERSION = 1    # wire FRAMING version (prefix byte): layout of the prefix
PROTOCOL = 2   # application version, negotiated in hello (v2: tiles8 frames)

# magic(2) version(1) reserved(1) header_len(u32) payload_len(u32), big-endian
_PREFIX = struct.Struct(">2sBBII")
PREFIX_SIZE = _PREFIX.size

MAX_HEADER_BYTES = 1 << 20   # a header is small structured JSON
MAX_PAYLOAD_BYTES = 1 << 28  # one frame; 256 MB is beyond any sane config

# message type constants
HELLO, HELLO_OK = "hello", "hello_ok"
RENDER, FRAME, SCRUB = "render", "frame", "scrub"
STATS, STATS_OK = "stats", "stats_ok"
METRICS, METRICS_OK = "metrics", "metrics_ok"  # v2: typed-registry snapshot
ERROR, BYE = "error", "bye"


class ProtocolError(Exception):
    """The byte stream is not speaking this protocol (or this version)."""


def pack_message(header: dict, payload: bytes = b"") -> bytes:
    """Serialize one message to its on-wire bytes."""
    hdr = json.dumps(header, separators=(",", ":")).encode("utf-8")
    if len(hdr) > MAX_HEADER_BYTES:
        raise ProtocolError(f"header too large: {len(hdr)} bytes")
    if len(payload) > MAX_PAYLOAD_BYTES:
        raise ProtocolError(f"payload too large: {len(payload)} bytes")
    return _PREFIX.pack(MAGIC, VERSION, 0, len(hdr), len(payload)) + hdr + payload


def unpack_prefix(buf: bytes) -> tuple[int, int]:
    """Validate a 12-byte frame prefix; returns (header_len, payload_len)."""
    if len(buf) < PREFIX_SIZE:
        raise ProtocolError(f"short prefix: {len(buf)} < {PREFIX_SIZE} bytes")
    magic, version, _, hlen, plen = _PREFIX.unpack(buf[:PREFIX_SIZE])
    if magic != MAGIC:
        raise ProtocolError(f"bad magic {magic!r} (not a gateway stream?)")
    if version != VERSION:
        raise ProtocolError(f"peer speaks protocol v{version}, this side v{VERSION}")
    if hlen > MAX_HEADER_BYTES:
        raise ProtocolError(f"declared header length {hlen} exceeds cap")
    if plen > MAX_PAYLOAD_BYTES:
        raise ProtocolError(f"declared payload length {plen} exceeds cap")
    return hlen, plen


def _parse_header(raw: bytes) -> dict:
    try:
        header = json.loads(raw.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ProtocolError(f"undecodable header: {e}") from None
    if not isinstance(header, dict) or "type" not in header:
        raise ProtocolError(f"header is not a typed object: {header!r}")
    return header


def iter_messages(data: bytes) -> Iterator[tuple[dict, bytes]]:
    """Parse a byte buffer holding zero or more complete messages (sync side;
    the async path uses ``read_message``). Raises on trailing partial bytes."""
    off = 0
    while off < len(data):
        hlen, plen = unpack_prefix(data[off : off + PREFIX_SIZE])
        end = off + PREFIX_SIZE + hlen + plen
        if end > len(data):
            raise ProtocolError(f"truncated message: need {end - len(data)} more bytes")
        header = _parse_header(data[off + PREFIX_SIZE : off + PREFIX_SIZE + hlen])
        yield header, data[off + PREFIX_SIZE + hlen : end]
        off = end


async def read_message(reader, *, max_payload: int = MAX_PAYLOAD_BYTES) -> tuple[dict, bytes] | None:
    """Read one message from an asyncio StreamReader; None on clean EOF
    (EOF at a frame boundary). EOF mid-frame raises ProtocolError.

    ``max_payload`` lets a receiver cap inbound payloads below the wire
    format's limit: the gateway reads *requests*, which carry all their
    data in the JSON header — honoring the frame-sized default there would
    let any unauthenticated peer demand 256 MB allocations per message."""
    try:
        prefix = await reader.readexactly(PREFIX_SIZE)
    except EOFError:  # asyncio.IncompleteReadError subclasses EOFError
        return None  # connection closed between frames: a clean goodbye
    except ConnectionError:
        return None
    hlen, plen = unpack_prefix(prefix)
    if plen > max_payload:
        raise ProtocolError(
            f"declared payload length {plen} exceeds this receiver's cap {max_payload}"
        )
    try:
        body = await reader.readexactly(hlen + plen)  # one read, one wakeup
    except EOFError:
        raise ProtocolError("connection closed mid-message") from None
    return _parse_header(body[:hlen]), body[hlen:]


# Only pay a real drain (a loop round-trip) once this much is buffered;
# below it, write() just appends and the coroutine never yields.
DRAIN_THRESHOLD = 1 << 16


async def write_message(writer, header: dict, payload: bytes = b"") -> int:
    """Write one message; returns bytes written. The full frame is composed
    before the single ``write`` call, so concurrent writers on one
    connection can never interleave partial frames. Draining is deferred
    until the transport buffers ``DRAIN_THRESHOLD`` bytes — per-message
    drains cost an event-loop round-trip each, which at localhost frame
    rates is most of the message's latency."""
    data = pack_message(header, payload)
    writer.write(data)
    transport = writer.transport
    if transport is None or transport.get_write_buffer_size() > DRAIN_THRESHOLD:
        await writer.drain()
    return len(data)


# ------------------------------------------------------------------ cameras
def camera_to_wire(cam: Camera) -> dict:
    """Flatten a pinhole camera for the JSON header (float lists)."""
    return {
        "viewmat": [float(v) for v in np.asarray(cam.viewmat, np.float32).reshape(-1)],
        "fx": float(np.asarray(cam.fx)),
        "fy": float(np.asarray(cam.fy)),
        "cx": float(np.asarray(cam.cx)),
        "cy": float(np.asarray(cam.cy)),
    }


def camera_from_wire(d: dict) -> Camera:
    try:
        vm = np.asarray(d["viewmat"], np.float32).reshape(4, 4)
        return Camera(
            vm,
            np.float32(d["fx"]),
            np.float32(d["fy"]),
            np.float32(d["cx"]),
            np.float32(d["cy"]),
        )
    except (KeyError, TypeError, ValueError) as e:
        raise ProtocolError(f"malformed camera: {e}") from None
