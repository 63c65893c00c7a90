"""Fleet ingest subsystem — multi-host GAPP profiling.

Turns the single-host streaming profiler into a fleet profiler:

* :mod:`repro_torch.fleet.wire` — versioned length-prefixed binary frame format
  for event chunks (see its docstring for the wire spec table);
* :mod:`repro_torch.fleet.transport` — :class:`RemoteSink` (producer: stream a
  session's drained chunks over a socket, with backpressure + reconnect)
  and :class:`IngestServer` (consumer: N producers → one fleet hub);
* :mod:`repro_torch.fleet.aggregate` — :class:`FleetSource`, an
  :class:`~repro_torch.core.session.EventSource` that k-way-merges per-host
  streams (shard tie-break semantics, clock-offset normalization) so one
  :class:`~repro_torch.core.session.ProfileSession` folds the whole fleet and
  reports bottlenecks with host provenance;
* :mod:`repro_torch.fleet.service` — :class:`ProfilerService`, the live HTTP
  query API, ``/metrics`` exposition and no-dependency dashboard over
  that session (``session.serve(addr, server=ingest)``), with
  :class:`RetentionPolicy` age-pruning the durable journals.

Offline, the same merge ingests spill files copied off the hosts::

    from repro_torch.fleet import FleetSource
    rep = ProfileSession(FleetSource.from_files(paths), n_min=2.0).result()

Importing this package also registers the ``"remote"`` exporter
(``session.export("remote", addr=(host, port))``); :mod:`repro_torch.core`
loads it lazily on first use.

Failure modes & guarantees
--------------------------

What happens to in-flight data under each failure, with journaling on
both sides (producer ``journal_path=``, server ``fleet_dir=``).
*Recovered* means the rows reappear (live replay or offline
``FleetSource.from_fleet_dir`` / ``from_producer_journals``);
*counted-lost* means the rows are gone but the loss is counted
(``lost_chunks`` — never silent); *shed* means live-report rows over the
``max_pending_rows`` budget were dropped from the merge but remain
journaled (``shed_chunks``/``shed_rows``; offline replay recovers them).

==========================  =============================================
failure                     guarantee
==========================  =============================================
producer killed (-9)        unsent chunks survive in its journal; a
                            restarted sink on the same ``journal_path``
                            resumes the capture instance and replays from
                            the server's ack floor → **recovered**
server killed               journals + meta sidecars in ``fleet_dir``
                            persist; a restarted server restores dedup
                            floors, backfills history, producers
                            reconnect and replay unacked chunks →
                            **recovered**
network partition           producer backs off (full-jitter) and
                            replays journaled chunks on reconnect →
                            **recovered**; without a producer journal
                            the gap is **counted-lost**
producer disk full          the chunk is dropped whole before consuming
                            a seq (``journal_errors``/``dropped_chunks``)
                            → **counted-lost**, dedup floor intact
server disk full            the chunk is REFUSED (connection closed, no
                            commit); the producer replays it once the
                            disk recovers → **recovered**
slow / stalled producer     ``read_deadline`` reclaims dead connections;
                            ``idle_release`` (or an idle heartbeat)
                            exempts the host from the merge watermark so
                            it cannot stall healthy hosts; late data
                            clamps like any late joiner
merge overload              journaled hosts: oldest buffered chunks are
                            **shed** (recoverable offline); non-journaled
                            hosts: reads pause (lossless backpressure)
corrupted frame             header/schema validation rejects the frame
                            (``proto_errors``) — corruption is detected,
                            never folded
==========================  =============================================

A ``sink.close()`` is a *delivery barrier*: the server closes a
connection only after consuming its BYE, and a dying server RESETS every
connection it abandons — so a clean close proves the whole stream was
folded, and a flush into a dead socket's buffers can never pass as
delivery.

Every one of these is reproducible deterministically with
:class:`repro_torch.fleet.faults.FaultPlan` (see the JAX package's chaos benchmark
for the 64-producer chaos gate).
"""
from repro_torch.fleet.aggregate import FleetSource, HostStream
from repro_torch.fleet.faults import FaultPlan
from repro_torch.fleet.service import ProfilerService, RetentionPolicy
from repro_torch.fleet.transport import IngestServer, RemoteSink, attach_remote
from repro_torch.fleet.wire import (CHUNK, ChunkFrame, HELLO, MERGED_SHARD, RAW,
                              SUPPORTED_CODECS, WIRE_VERSION, ZLIB,
                              WireError, decode_chunk, encode_chunk,
                              negotiate_codec, pack_frame, read_frame)

__all__ = [
    "FaultPlan", "FleetSource", "HostStream", "IngestServer",
    "ProfilerService", "RemoteSink", "RetentionPolicy",
    "attach_remote", "WIRE_VERSION", "WireError", "ChunkFrame",
    "encode_chunk", "decode_chunk", "pack_frame", "read_frame",
    "CHUNK", "HELLO", "MERGED_SHARD", "RAW", "ZLIB", "SUPPORTED_CODECS",
    "negotiate_codec",
]
