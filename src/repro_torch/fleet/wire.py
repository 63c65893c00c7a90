"""Fleet wire format — versioned, length-prefixed binary event frames.

One GAPP host streams its drained event chunks to an ingest server as a
sequence of *frames* over any reliable byte stream (TCP in
:mod:`repro_torch.fleet.transport`, a file, a pipe).  The format is deliberately
dumb: length-prefixed frames with a fixed header, JSON payloads for the
low-rate control plane (handshake, registry sync) and the profiler's own
redaction-free columnar layout — the exact five columns the fold consumes
(``times/workers/deltas/tags/stacks``, the
:class:`~repro_torch.core.spill.SpillStore` block layout) — for the data plane,
so decode on the server is five ``np.frombuffer`` calls and zero row loops.

Frame header (8 bytes, little-endian)::

    ┌──────┬───────┬────────────────┬─────────────┐
    │ u8   │ u8    │ u16            │ u32         │
    │ kind │ flags │ schema_version │ payload_len │
    └──────┴───────┴────────────────┴─────────────┘

``schema_version`` == :data:`WIRE_VERSION` (bump on layout changes; a
decoder accepts every version back to :data:`MIN_WIRE_VERSION` — v2 is a
pure superset of v1 — and rejects anything newer).  ``flags``:

    ====== ================ ==============================================
    bit    name             meaning
    ====== ================ ==============================================
    0x01   FLAG_COMPRESSED  the payload is ``<u32 raw_len>`` followed by
                            a zlib (RFC 1950) stream that inflates to
                            exactly ``raw_len`` bytes of the frame's
                            normal payload.  ``raw_len`` must not exceed
                            :data:`MAX_PAYLOAD` and the inflate is capped
                            at ``raw_len`` (a corrupt or hostile frame
                            can never balloon past the guard).  Senders
                            only set the bit for a codec the receiver
                            negotiated (HELLO ``codecs`` → WELCOME
                            ``codec``) and fall back to a raw frame
                            whenever compression does not shrink the
                            payload.
    ====== ================ ==============================================

Frame kinds and payloads:

    ====== ========= ==================================================
    kind   name      payload
    ====== ========= ==================================================
    0x01   HELLO     JSON — ``{"magic": "gapp-fleet", "wire_version",
                     "host_id", "num_workers", "worker_names",
                     "t_client_ns", "clock_offset_ns", "codecs"}``; first
                     frame of every connection, never compressed (it
                     precedes negotiation).  ``t_client_ns`` is the
                     host's capture clock sampled immediately before
                     send; ``clock_offset_ns`` is the *declared* offset
                     to the fleet clock (``null`` ⇒ the server measures
                     ``t_server − t_client`` at receipt).  ``codecs``
                     (v2, additive) lists the payload codecs the producer
                     can send, in preference order (subset of
                     ``["zlib", "raw"]``; absent ⇒ raw only).
    0x02   WELCOME   JSON — ``{"host_index", "epoch", "clock_offset_ns",
                     "ack_seq", "codec"}``; the server's reply.  ``epoch``
                     is the clock-sync generation: every CHUNK must echo
                     it, and a reconnect (new HELLO) advances it, so
                     chunks timed under a stale offset are detectable.
                     ``ack_seq`` (v2, additive) is the server's durable
                     receive floor — the first CHUNK ``seq`` it has NOT
                     folded for this host; a journaling producer replays
                     ``[ack_seq, next_seq)`` from its local journal
                     after every (re)connect, so producer restarts and
                     in-flight losses become recovered history.
                     ``codec`` (v2, additive) is the payload codec the
                     server selected from the HELLO offer (absent ⇒
                     raw).  ``tags_seen``/``stacks_seen`` (v2, additive)
                     are the server's per-host registry high-water
                     marks; the producer rewinds its incremental sync
                     counters to them, so registry deltas lost with a
                     dead server are retransmitted.
    0x03   CHUNK     binary — 24-byte chunk header ``<u16 host_index>
                     <u16 shard_id> <u64 epoch> <u64 seq> <u32 nrows>``
                     followed by the five columns, each ``nrows`` long, in
                     order: ``times i64 · workers i32 · deltas i8 ·
                     tags i32 · stacks i32`` (== one SpillStore block).
                     ``shard_id`` 0xFFFF means "merged across shards"
                     (what a drained tracer chunk is).  ``seq`` numbers
                     the host's chunks from 0 across the whole capture
                     (NOT reset on reconnect): the server drops
                     already-seen sequence numbers (retransmits fold
                     exactly once) and counts sequence gaps as
                     ``lost_chunks``.  A journaling producer recovers
                     gaps via the WELCOME ``ack_seq`` replay; without a
                     journal the sink only retains its one in-flight
                     chunk and loss is detected, not recovered.
    0x04   TAGS      JSON — ``{"entries": [[tag_id, name, location],…]}``
                     incremental tag-registry sync; ids are host-local
                     and must be sent before any CHUNK references them.
    0x05   STACKS    JSON — ``{"entries": [[stack_id, [tag_id,…]],…]}``
                     incremental call-path registry sync (host-local tag
                     ids, caller→callee).
    0x06   BYE       JSON — ``{"rows_sent", "chunks_sent"}`` final
                     accounting; lets the server assert losslessness.
    0x07   HEARTBEAT JSON — ``{"t_ns"}`` (v3, additive) producer
                     liveness: sent whenever the producer has been idle
                     for its heartbeat interval, so the server's per-host
                     read deadline distinguishes "alive but quiet" from
                     "silently dead" (a dead producer's stream is retired
                     so it cannot pin the merge watermark).  ``t_ns``
                     (nullable) is the capture-clock time of the last
                     event the producer has *streamed* — a safe low
                     watermark (every future row has time >= it); the
                     server only ever advances its per-host watermark
                     with it.  Producers send heartbeats only to servers
                     that advertised ``server_wire_version >= 3`` in
                     WELCOME (an older server would count the unknown
                     kind as a protocol error).
    ====== ========= ==================================================

Round-trip guarantee: ``decode_chunk(encode_chunk(c)) == c`` bit-exact for
every column (dtype-preserving), with or without compression — tested in
the port's fleet tests.
"""
from __future__ import annotations

import dataclasses
import json
import struct
import zlib

import numpy as np

WIRE_VERSION = 3        # v3 adds HEARTBEAT + WELCOME.server_wire_version
#                         (v2 added FLAG_COMPRESSED + HELLO.codecs +
#                         WELCOME.ack_seq/codec) — all additive
MIN_WIRE_VERSION = 1    # oldest version this decoder still accepts
MAGIC = "gapp-fleet"

# payload codecs (negotiated: HELLO offers, WELCOME selects)
RAW = "raw"
ZLIB = "zlib"
SUPPORTED_CODECS = (ZLIB, RAW)      # what this build can decode/encode

FLAG_COMPRESSED = 0x01
_KNOWN_FLAGS = FLAG_COMPRESSED

_COMPRESS_MIN = 64          # don't bother deflating tiny control frames
_COMPRESS_LEVEL = 6
_RAW_LEN = struct.Struct("<I")

# frame kinds
HELLO = 0x01
WELCOME = 0x02
CHUNK = 0x03
TAGS = 0x04
STACKS = 0x05
BYE = 0x06
HEARTBEAT = 0x07

KIND_NAMES = {HELLO: "HELLO", WELCOME: "WELCOME", CHUNK: "CHUNK",
              TAGS: "TAGS", STACKS: "STACKS", BYE: "BYE",
              HEARTBEAT: "HEARTBEAT"}

# merged-across-shards sentinel for the CHUNK shard_id field
MERGED_SHARD = 0xFFFF

_FRAME_HEADER = struct.Struct("<BBHI")          # kind, flags, schema, len
_CHUNK_HEADER = struct.Struct("<HHQQI")         # host, shard, epoch, seq, n

# Column order and dtypes of one chunk — THE SpillStore block layout (one
# shared definition, so the disk and wire formats cannot drift apart).
from repro_torch.core.spill import _COL_DTYPES as COL_DTYPES          # noqa: E402
from repro_torch.core.spill import _ROW_BYTES as ROW_BYTES            # noqa: E402

# Refuse absurd frames before allocating (a corrupt length prefix must not
# OOM the server): 64 MiB is ~3.2M rows, far above any drain chunk.
MAX_PAYLOAD = 64 << 20


class WireError(ValueError):
    """Malformed or incompatible frame."""


@dataclasses.dataclass
class ChunkFrame:
    """One decoded CHUNK: provenance header + the five event columns."""

    host_index: int
    shard_id: int
    epoch: int
    seq: int
    times: np.ndarray      # int64[n]
    workers: np.ndarray    # int32[n]
    deltas: np.ndarray     # int8[n]
    tags: np.ndarray       # int32[n]
    stacks: np.ndarray     # int32[n]

    def __len__(self) -> int:
        return int(self.times.shape[0])

    @property
    def columns(self):
        return (self.times, self.workers, self.deltas, self.tags,
                self.stacks)


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------

def negotiate_codec(offered, preferred=SUPPORTED_CODECS) -> str:
    """Server-side codec pick: first of ``preferred`` the peer offered.
    An absent/empty offer (a v1 producer) or no overlap falls back to
    raw — negotiation can only ever *add* compression, never break a
    connection."""
    offered = [c for c in (offered or ()) if c in SUPPORTED_CODECS]
    for codec in preferred or ():
        if codec in offered:
            return codec
    return RAW


def pack_frame(kind: int, payload: bytes, codec: str = RAW,
               version: int = WIRE_VERSION) -> bytes:
    """Frame ``payload`` with the 8-byte header.  ``codec=ZLIB`` deflates
    the payload (flag bit set) when that actually shrinks it; small or
    incompressible payloads ship raw — the flag is per-frame, so a zlib
    connection degrades gracefully frame by frame.  ``version`` lets a
    reply to an older peer carry *that* peer's schema version (a v1
    decoder rejects v2-stamped frames); v2 fields are additive JSON keys
    a v1 decoder ignores, so the downgrade is stamp-only."""
    if len(payload) > MAX_PAYLOAD:
        raise WireError(f"payload {len(payload)}B exceeds MAX_PAYLOAD")
    if not MIN_WIRE_VERSION <= version <= WIRE_VERSION:
        raise WireError(f"cannot stamp version {version}")
    flags = 0
    if codec == ZLIB and version >= 2 and len(payload) >= _COMPRESS_MIN:
        comp = zlib.compress(payload, _COMPRESS_LEVEL)
        if _RAW_LEN.size + len(comp) < len(payload):
            payload = _RAW_LEN.pack(len(payload)) + comp
            flags = FLAG_COMPRESSED
    elif codec not in (RAW, ZLIB):
        raise WireError(f"unknown codec {codec!r}")
    return _FRAME_HEADER.pack(kind, flags, version, len(payload)) \
        + payload


def _inflate(payload: bytes) -> bytes:
    """Undo :data:`FLAG_COMPRESSED` with a hard decompressed-length guard:
    the declared ``raw_len`` is validated *before* inflating and the
    inflate is capped at it, so a corrupt length can never OOM the
    receiver."""
    if len(payload) < _RAW_LEN.size:
        raise WireError("compressed payload shorter than its length prefix")
    (raw_len,) = _RAW_LEN.unpack_from(payload)
    if raw_len > MAX_PAYLOAD:
        raise WireError(f"declared raw length {raw_len} exceeds MAX_PAYLOAD")
    if raw_len == 0:
        # our encoder never compresses sub-_COMPRESS_MIN payloads, and to
        # zlib max_length=0 means UNLIMITED — a zero here is a bomb, not
        # an empty frame
        raise WireError("compressed frame declares zero raw length")
    d = zlib.decompressobj()
    try:
        out = d.decompress(payload[_RAW_LEN.size:], raw_len)
    except zlib.error as e:
        raise WireError(f"bad zlib payload: {e}") from None
    if len(out) != raw_len or not d.eof or d.unconsumed_tail or d.unused_data:
        raise WireError(f"zlib payload inflates to {len(out)}B "
                        f"(declared {raw_len}B) or has trailing data")
    return out


def frame_from_buffer(buf) -> tuple[int, bytes, int] | None:
    """Non-blocking twin of :func:`read_frame` for event-loop receivers:
    parse ONE frame from the head of ``buf`` (bytes/bytearray/memoryview).
    Returns ``(kind, payload, consumed_bytes)`` when a complete frame is
    present, ``None`` when more bytes are needed; raises :class:`WireError`
    on a malformed header exactly like :func:`read_frame` (the caller
    drops the connection — there is no resync point in the stream)."""
    if len(buf) < _FRAME_HEADER.size:
        return None
    kind, flags, version, length = _FRAME_HEADER.unpack_from(buf)
    if flags & ~_KNOWN_FLAGS:
        raise WireError(f"unknown flags 0x{flags:02x}")
    if not MIN_WIRE_VERSION <= version <= WIRE_VERSION:
        raise WireError(f"wire version {version} outside "
                        f"[{MIN_WIRE_VERSION}, {WIRE_VERSION}]")
    if length > MAX_PAYLOAD:
        raise WireError(f"frame length {length} exceeds MAX_PAYLOAD")
    total = _FRAME_HEADER.size + length
    if len(buf) < total:
        return None
    payload = bytes(buf[_FRAME_HEADER.size:total])
    if flags & FLAG_COMPRESSED:
        payload = _inflate(payload)
    return kind, payload, total


def _read_exact(stream, n: int) -> bytes:
    """Read exactly ``n`` bytes from a file-like/socket-file stream;
    returns ``b""`` on clean EOF at a frame boundary, raises on a short
    read mid-frame."""
    buf = bytearray()
    while len(buf) < n:
        part = stream.read(n - len(buf))
        if not part:
            if not buf:
                return b""
            raise WireError("stream truncated mid-frame "
                            f"({len(buf)}/{n} bytes)")
        buf += part
    return bytes(buf)


def read_frame(stream) -> tuple[int, bytes] | None:
    """Read one frame; ``None`` on clean EOF.  Validates header fields."""
    hdr = _read_exact(stream, _FRAME_HEADER.size)
    if not hdr:
        return None
    kind, flags, version, length = _FRAME_HEADER.unpack(hdr)
    if flags & ~_KNOWN_FLAGS:
        raise WireError(f"unknown flags 0x{flags:02x}")
    if not MIN_WIRE_VERSION <= version <= WIRE_VERSION:
        raise WireError(f"wire version {version} outside "
                        f"[{MIN_WIRE_VERSION}, {WIRE_VERSION}]")
    if length > MAX_PAYLOAD:
        raise WireError(f"frame length {length} exceeds MAX_PAYLOAD")
    payload = _read_exact(stream, length) if length else b""
    if length and not payload:
        raise WireError("stream truncated before payload")
    if flags & FLAG_COMPRESSED:
        payload = _inflate(payload)
    return kind, payload


# ---------------------------------------------------------------------------
# control plane (JSON payloads)
# ---------------------------------------------------------------------------

def encode_json(kind: int, obj: dict, codec: str = RAW) -> bytes:
    return pack_frame(kind, json.dumps(obj, separators=(",", ":"))
                      .encode("utf-8"), codec)


def decode_json(payload: bytes) -> dict:
    try:
        obj = json.loads(payload.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise WireError(f"bad control payload: {e}") from None
    if not isinstance(obj, dict):
        raise WireError("control payload is not an object")
    return obj


def encode_hello(host_id: str, num_workers: int, worker_names: list[str],
                 t_client_ns: int, clock_offset_ns: int | None,
                 instance: str = "",
                 codecs: tuple[str, ...] = SUPPORTED_CODECS) -> bytes:
    """``instance`` is a per-capture nonce: a *reconnect* of the same
    capture repeats it (the server keeps the seq-dedup floor), while a
    producer *restart* sends a fresh one (the floor resets — otherwise the
    new capture's chunks would all be dropped as retransmits).  A
    journal-resumed restart deliberately repeats the *saved* nonce so the
    floor survives and only the unacked tail replays.  ``codecs`` is the
    compression offer (see the module spec table); HELLO itself is always
    raw."""
    return encode_json(HELLO, {
        "magic": MAGIC, "wire_version": WIRE_VERSION, "host_id": host_id,
        "num_workers": int(num_workers), "worker_names": list(worker_names),
        "t_client_ns": int(t_client_ns),
        "clock_offset_ns": (None if clock_offset_ns is None
                            else int(clock_offset_ns)),
        "instance": str(instance),
        "codecs": [str(c) for c in codecs],
    })


def decode_hello(payload: bytes) -> dict:
    obj = decode_json(payload)
    if obj.get("magic") != MAGIC:
        raise WireError(f"bad magic {obj.get('magic')!r}")
    v = obj.get("wire_version")
    if not isinstance(v, int) or not MIN_WIRE_VERSION <= v <= WIRE_VERSION:
        raise WireError(f"wire version {v} outside "
                        f"[{MIN_WIRE_VERSION}, {WIRE_VERSION}]")
    return obj


def encode_welcome(host_index: int, epoch: int, clock_offset_ns: int,
                   ack_seq: int = 0, codec: str = RAW,
                   tags_seen: int = 0, stacks_seen: int = 0,
                   version: int = WIRE_VERSION) -> bytes:
    """``tags_seen``/``stacks_seen`` (v2, additive) are the server's
    registry high-water marks for this host: how many host-local tag /
    stack entries it currently knows.  A producer rewinds its incremental
    sync counters to them, so registry deltas lost with a dead server (or
    a server restart that restored less than the producer sent) are
    retransmitted — interning is idempotent server-side.  ``version`` is
    stamped into the frame header: replies to a v1 producer must carry
    version 1 or its decoder rejects them (the extra JSON keys are
    harmless — v1 ignores unknown keys)."""
    obj = {"host_index": int(host_index),
           "epoch": int(epoch),
           "clock_offset_ns": int(clock_offset_ns),
           "ack_seq": int(ack_seq),
           "codec": str(codec),
           "tags_seen": int(tags_seen),
           "stacks_seen": int(stacks_seen),
           # v3, additive: OUR version (the frame header is stamped with
           # the peer's) — a producer only sends HEARTBEAT frames to a
           # server that declares it can decode them
           "server_wire_version": WIRE_VERSION}
    return pack_frame(WELCOME, json.dumps(obj, separators=(",", ":"))
                      .encode("utf-8"), version=version)


def encode_heartbeat(t_ns: int | None = None, codec: str = RAW) -> bytes:
    """Producer liveness beacon (v3).  ``t_ns`` is the capture-clock time
    of the last event already streamed (a safe per-host low watermark), or
    ``None`` when the producer has streamed nothing yet."""
    return encode_json(HEARTBEAT,
                       {"t_ns": None if t_ns is None else int(t_ns)}, codec)


def encode_tags(entries: list[tuple[int, str, str]],
                codec: str = RAW) -> bytes:
    return encode_json(TAGS, {"entries": [[int(i), n, loc]
                                          for i, n, loc in entries]}, codec)


def encode_stacks(entries: list[tuple[int, tuple[int, ...]]],
                  codec: str = RAW) -> bytes:
    return encode_json(STACKS, {"entries": [[int(i), [int(t) for t in p]]
                                            for i, p in entries]}, codec)


def encode_bye(rows_sent: int, chunks_sent: int) -> bytes:
    return encode_json(BYE, {"rows_sent": int(rows_sent),
                             "chunks_sent": int(chunks_sent)})


# ---------------------------------------------------------------------------
# data plane (columnar CHUNK payloads)
# ---------------------------------------------------------------------------

def encode_chunk(host_index: int, shard_id: int, epoch: int, seq: int,
                 times, workers, deltas, tags, stacks,
                 codec: str = RAW) -> bytes:
    """Frame one columnar event chunk (the drained-batch layout)."""
    cols = [np.ascontiguousarray(c, dt) for c, dt in
            zip((times, workers, deltas, tags, stacks), COL_DTYPES)]
    n = len(cols[0])
    for c in cols:
        if len(c) != n:
            raise WireError("chunk columns misaligned")
    payload = b"".join(
        [_CHUNK_HEADER.pack(host_index, shard_id, epoch, seq, n)]
        + [c.tobytes() for c in cols])
    return pack_frame(CHUNK, payload, codec)


def frame_raw_bytes(frame: bytes) -> int:
    """What an encoded frame would cost uncompressed (header included):
    compressed frames declare their inflated size in the payload prefix,
    raw frames cost what they are.  Feeds the sender's wire-savings
    counters."""
    _k, flags, _v, _n = _FRAME_HEADER.unpack_from(frame)
    if flags & FLAG_COMPRESSED:
        (raw_len,) = _RAW_LEN.unpack_from(frame, _FRAME_HEADER.size)
        return _FRAME_HEADER.size + raw_len
    return len(frame)


def decode_chunk(payload: bytes) -> ChunkFrame:
    """Inverse of :func:`encode_chunk` — bit-exact columns, no row loops."""
    if len(payload) < _CHUNK_HEADER.size:
        raise WireError("chunk payload shorter than its header")
    host, shard, epoch, seq, n = _CHUNK_HEADER.unpack_from(payload)
    expect = _CHUNK_HEADER.size + n * ROW_BYTES
    if len(payload) != expect:
        raise WireError(f"chunk payload {len(payload)}B != expected "
                        f"{expect}B for {n} rows")
    off = _CHUNK_HEADER.size
    cols = []
    for dt in COL_DTYPES:
        nbytes = n * np.dtype(dt).itemsize
        cols.append(np.frombuffer(payload, dt, count=n, offset=off).copy())
        off += nbytes
    return ChunkFrame(host, shard, epoch, seq, *cols)
