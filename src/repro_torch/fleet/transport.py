"""Socket transport: stream drained chunks off-host, ingest N producers.

Producer side — :class:`RemoteSink` attaches to a live
:class:`~repro_torch.core.session.ProfileSession` (``attach_remote(session,
addr)`` or ``session.export("remote", addr=...)``) as a tracer *sink*:
every drained+folded chunk the tracer appends to its store is also handed
to the sink, which frames it (:mod:`repro_torch.fleet.wire`) and ships it from a
background sender thread.  The capture hot path never blocks on the
network: the hand-off is a bounded queue, and only when the queue is full
does the *drain* (not the probes) wait — backpressure — or, with
``drop_when_full=True``, the chunk is dropped and counted like a full BPF
ring.  The sender reconnects with backoff on socket errors; a reconnect
re-handshakes, bumping the clock-sync epoch, and never loses the chunk it
was holding.

**Durable mode** (``journal=path``): every chunk is appended to a local
:class:`~repro_torch.core.spill.SpillStore`-layout journal — block index ==
chunk ``seq`` — *before* it is queued for send, and every (re)connect
replays ``[ack_seq, …)`` from that journal (the WELCOME ``ack_seq`` is
the server's durable receive floor).  In-flight chunks lost to a broken
connection, and even whole producer restarts, become recovered history:
a fresh sink opened on the same journal resumes the capture's instance
nonce, seq numbering and tag/stack id space (registries are re-seeded
from the journal's meta sidecar), so the server folds exactly-once with
zero ``lost_chunks``.

Consumer side — :class:`IngestServer` accepts any number of producer
connections, performs the HELLO/WELCOME handshake (allocating the host
index, the clock offset — declared by the producer, or measured as
``t_server − t_client`` — and the payload compression codec), remaps
host-local tag/stack ids into the fleet-wide registries via the
incremental TAGS/STACKS sync frames, and pushes normalized chunks into
its :class:`~repro_torch.fleet.aggregate.FleetSource` hub — which a
:class:`~repro_torch.core.session.ProfileSession` drains like any other source.
One server + one session = a fleet-wide
:class:`~repro_torch.core.detector.BottleneckReport` with host provenance.

With ``fleet_dir=`` the server is durable too: every accepted chunk is
journaled to a per-host SpillStore under that directory (host-local
columns, pre-normalization) next to a meta sidecar carrying the host's
identity, dedup floor, worker table, clock offset and registry entries.
A *restarted* server re-opens a reconnecting host's journal, restores the
dedup floor (so the WELCOME ``ack_seq`` survives the restart) and
backfills the merge with the journaled history; offline,
:meth:`~repro_torch.fleet.aggregate.FleetSource.from_fleet_dir` replays the
whole directory bit-equal to the live merge.
"""
from __future__ import annotations

import hashlib
import os
import random
import re
import selectors
import socket
import struct
import threading
import time
import uuid
from collections import deque

import numpy as np

from repro_torch.core.exporters import register_exporter
from repro_torch.core.spill import SpillStore
from repro_torch.fleet import wire
from repro_torch.fleet.aggregate import (FleetSource, HostStream, load_json,
                                   restore_host_maps, write_json_atomic)
from repro_torch.fleet.aggregate import _grow_idmap as _grow_map


def _set_entry(lst: list, idx: int, val) -> None:
    """Sparse list assignment (registry entries keyed by host-local id)."""
    while len(lst) <= idx:
        lst.append(None)
    lst[idx] = val


# ---------------------------------------------------------------------------
# producer: RemoteSink
# ---------------------------------------------------------------------------

class RemoteSink:
    """Stream a session's drained chunks to an :class:`IngestServer`.

    Attach via :func:`attach_remote` / ``session.export("remote", ...)``;
    or hand-construct and append to ``tracer.sinks``.  ``clock_offset_ns``
    is the *declared* offset of this host's capture clock to the fleet
    clock; the default ``None`` lets the server measure one from the
    handshake — capture clocks (``perf_counter_ns``) have unrelated bases
    across machines, so declaring 0 is only correct for co-located
    producers sharing a clock (tests/benchmarks pass it explicitly).

    ``journal=path`` turns on durable mode: chunks are journaled (flushed
    to the OS — durable against a process crash; pass
    ``journal_fsync=True`` to fsync every block and extend that to power
    loss, at a per-chunk fsync cost) before they are queued, reconnects
    replay the server-unacked tail (WELCOME ``ack_seq``), and a sink
    re-opened on the same journal resumes the capture — instance nonce,
    seq numbering and the tag/stack id space all persist in
    ``path + ".meta.json"``.
    Note: with ``drop_when_full=True`` an over-budget chunk is shed
    *before* it is journaled — it never consumes a seq, so shedding is
    visible only as ``dropped_chunks``, never as a server-side gap;
    durable captures should keep the default backpressure.  ``codecs`` is the compression offer
    for the HELLO→WELCOME negotiation (the server picks; per frame, raw
    is the automatic fallback when deflate does not shrink the payload).
    """

    _CLOSE = object()

    def __init__(self, addr: tuple[str, int], host_id: str, *,
                 num_workers=0, worker_names=None, tags=None, stacks=None,
                 clock=time.perf_counter_ns,
                 clock_offset_ns: int | None = None,
                 max_buffer_chunks: int = 256, drop_when_full: bool = False,
                 reconnect_delay: float = 0.05, max_reconnects: int = 64,
                 backoff_max: float = 1.0, backoff_seed: int | None = None,
                 heartbeat_interval: float | None = 5.0,
                 connect_timeout: float = 5.0, journal: str | None = None,
                 journal_fsync: bool = False,
                 journal_rotate_bytes: int | None = None,
                 journal_rotate_age_s: float | None = None,
                 journal_retain_blocks: int | None = None,
                 fault_plan=None,
                 codecs: tuple[str, ...] = wire.SUPPORTED_CODECS):
        self.addr = tuple(addr)
        self.host_id = str(host_id)
        self._num_workers = num_workers          # int or () -> int
        self._worker_names = worker_names        # list or () -> list
        self.tags = tags
        self.stacks = stacks
        self.clock = clock
        self.clock_offset_ns = clock_offset_ns
        self.drop_when_full = drop_when_full
        self.reconnect_delay = float(reconnect_delay)
        self.max_reconnects = int(max_reconnects)
        # reconnect backoff: exponential, capped at backoff_max, with FULL
        # jitter — after an aggregator restart a whole fleet redials, and
        # deterministic delays would thunder back in lockstep forever
        self.backoff_max = float(backoff_max)
        self._backoff_rng = random.Random(backoff_seed)
        # liveness beacons while idle (only to servers that advertised
        # wire v3+); None disables
        self.heartbeat_interval = (None if heartbeat_interval is None
                                   else float(heartbeat_interval))
        self.connect_timeout = float(connect_timeout)
        self.fault_plan = fault_plan
        self.codecs = tuple(codecs)
        self.codec = wire.RAW       # negotiated per connection (WELCOME)
        self.ack_seq: int | None = None     # server floor, last WELCOME
        self._q: deque = deque()    # guarded-by: self._lock
        self._q_cap = max(int(max_buffer_chunks), 1)
        self._lock = threading.Lock()
        self._not_full = threading.Condition(self._lock)
        self._not_empty = threading.Condition(self._lock)
        self._drained = threading.Condition(self._lock)
        self._pending = 0           # guarded-by: self._lock
        self._closing = False       # guarded-by: self._lock
        self._thread: threading.Thread | None = None
        self.host_index: int | None = None
        self.epoch: int | None = None
        self.server_wire_version = 1    # learned from WELCOME (v3+ servers)
        self._last_sent_t: int | None = None    # capture time, last row sent
        self._cur_sock: socket.socket | None = None
        self._abort = False
        self._next_seq = 0          # guarded-by: self._lock
        #                             chunk sequence, NOT reset on reconnect:
        #                             the server dedups retransmits by it
        self.instance = uuid.uuid4().hex    # capture nonce (see wire HELLO)
        self._tags_sent = 0
        self._stacks_sent = 0
        self._meta_counts = (-1, -1)
        # counters
        self.rows_sent = 0
        self.chunks_sent = 0
        self.dropped_chunks = 0     # guarded-by: self._lock
        self.reconnects = 0
        self.send_errors = 0
        self.replayed_chunks = 0
        self.replayed_rows = 0
        self.heartbeats_sent = 0
        self.journal_errors = 0     # journal appends that raised (disk full)
        self.wire_bytes = 0         # bytes actually written to the socket
        self.raw_bytes = 0          # what the same frames cost uncompressed
        self.last_error: Exception | None = None
        self.failed = False         # guarded-by: self._lock
        # durable journal: every chunk lands here (flushed) before it is
        # queued; block index == seq, so a reconnect can replay exactly
        # the server's unacked tail
        self.journal_path = str(journal) if journal else None
        self.journal_fsync = bool(journal_fsync)
        self._journal: SpillStore | None = None
        self._meta_path: str | None = None
        self._journal_workers: tuple[int, list[str]] = (0, [])
        self._journal_kw = dict(rotate_bytes=journal_rotate_bytes,
                                rotate_age_s=journal_rotate_age_s,
                                retain_blocks=journal_retain_blocks)
        if self.journal_path is not None:
            self._meta_path = self.journal_path + ".meta.json"
            self._journal = SpillStore.open_append(self.journal_path,
                                                   **self._journal_kw)
            meta = load_json(self._meta_path)
            if meta and meta.get("instance"):
                # RESUME a previous incarnation of this capture: repeat its
                # instance nonce (the server keeps the dedup floor — a
                # fresh nonce would reset it and re-fold the history),
                # continue the seq numbering after the journaled blocks,
                # and re-seed empty registries so the new process's
                # tag/stack ids extend the old id space instead of
                # colliding with it
                self.instance = str(meta["instance"])
                self._seed_registries(meta)
                self._journal_workers = (
                    int(meta.get("num_workers", 0)),
                    [str(n) for n in meta.get("worker_names") or []])
            elif self._journal.blocks:
                # orphaned blocks with no meta are NOT resumable: without
                # the old nonce the server treats us as a fresh capture
                # (ack 0), and replaying the old blocks would fold a dead
                # capture's events into this one.  Rotate the history
                # aside (never destroy a durable capture; the fresh nonce
                # keeps successive orphans from clobbering each other) and
                # start clean
                self._journal.close()
                suffix = f".orphaned-{self.instance[:8]}"
                for _first, seg in self._journal._segment_paths():
                    os.replace(seg, seg + suffix)
                if os.path.exists(self.journal_path):
                    os.replace(self.journal_path,
                               self.journal_path + suffix)
                self._journal = SpillStore(self.journal_path,
                                           **self._journal_kw)
            self._next_seq = self._journal.blocks
            if self.fault_plan is not None:
                self._journal = self.fault_plan.wrap_journal(self.host_id,
                                                             self._journal)
            self._write_meta()

    # -- durable journal helpers ---------------------------------------------
    def _worker_table(self) -> tuple[int, list[str]]:
        """The worker table to declare: the union of the live session's
        workers and the journaled incarnation's (``_journal_workers``) —
        the replayed history's worker ids must all be inside the HELLO
        range or the server filters its rows as ``bad_rows``."""
        nw = int(self._resolve(self._num_workers, 0))
        names = list(self._resolve(self._worker_names,
                                   [f"w{i}" for i in range(nw)]))
        jnw, jnames = self._journal_workers
        for i in range(nw, jnw):
            names.append(jnames[i] if i < len(jnames) else f"w{i}")
        return max(nw, jnw), names

    def _seed_registries(self, meta: dict) -> None:
        if self.tags is not None and len(self.tags.names) == 0:
            for name, loc in meta.get("tags") or []:
                self.tags.intern(str(name), str(loc))
        if self.stacks is not None and len(self.stacks.paths) == 0:
            for path in meta.get("stacks") or []:
                self.stacks.intern(tuple(int(t) for t in path))

    def _registry_counts(self) -> tuple[int, int]:
        # locations/paths are the fully-published high-water marks (see
        # _sync_registries)
        t = (min(len(self.tags.names), len(self.tags.locations))
             if self.tags is not None else 0)
        s = len(self.stacks.paths) if self.stacks is not None else 0
        return t, s

    def _write_meta(self) -> None:
        """Persist the resume state next to the journal: instance nonce,
        the registry entries the journaled chunks reference, and the
        worker table (a resumed session that registers fewer workers must
        still HELLO the union, or the replayed history's rows for the
        missing workers are filtered server-side as bad_rows)."""
        if self._meta_path is None:
            return
        nt, ns = self._registry_counts()
        tags = ([[self.tags.names[i], self.tags.locations[i]]
                 for i in range(nt)] if self.tags is not None else [])
        stacks = ([[int(t) for t in self.stacks.paths[i]]
                   for i in range(ns)] if self.stacks is not None else [])
        nw, names = self._worker_table()
        write_json_atomic(self._meta_path, {
            "host_id": self.host_id, "instance": self.instance,
            "next_seq": self._next_seq, "tags": tags, "stacks": stacks,
            "num_workers": nw, "worker_names": names,
            "clock_offset_ns": self.clock_offset_ns,
        })
        self._meta_counts = (nt, ns)

    # -- store-interface intake (called under the tracer's fold lock) --------
    def append_columns(self, times, workers, deltas, tags, stacks) -> None:
        if len(times) == 0:
            return
        item = tuple(np.asarray(c) for c in
                     (times, workers, deltas, tags, stacks))
        with self._lock:
            if self._closing:
                self.dropped_chunks += 1
                return
            if (self.drop_when_full and not self.failed
                    and len(self._q) >= self._q_cap):
                # shed BEFORE the journal: a dropped chunk must never
                # consume a seq — the contiguous ack-replay window could
                # not recover it, and the resulting permanent gap would
                # read as in-flight loss server-side.  Dropped is dropped,
                # and it is counted here
                self.dropped_chunks += 1
                return
            seq = None
            if self._journal is not None:
                # durable first — and the meta BEFORE the block: the block
                # may reference tags interned since the last meta write,
                # and a crash between the two writes must not leave
                # journaled history whose ids a resume cannot resolve
                if self._registry_counts() != self._meta_counts:
                    self._write_meta()
                try:
                    seq = self._journal.append_block(*item,
                                                     sync=self.journal_fsync)
                except OSError as e:
                    # disk full: the failed append consumed NO block (the
                    # store truncates the partial frame), so dropping the
                    # chunk whole keeps seq == block-index intact — the
                    # chunk exists on NEITHER side, which the accounting
                    # (journal_errors + dropped_chunks) states exactly
                    self.journal_errors += 1
                    self.dropped_chunks += 1
                    self.last_error = e
                    return
                self._next_seq = seq + 1
            while len(self._q) >= self._q_cap and not self.failed:
                self._not_full.wait(0.05)       # backpressure on the drain
            if self.failed:
                self.dropped_chunks += 1
                return
            if seq is None:
                seq = self._next_seq
                self._next_seq = seq + 1
            self._q.append((seq, item))
            self._pending += 1
            self._not_empty.notify()

    def __len__(self) -> int:
        return self.rows_sent

    @property
    def nbytes(self) -> int:
        with self._lock:
            return sum(sum(c.nbytes for c in item[1]) for item in self._q
                       if item is not self._CLOSE)

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "RemoteSink":
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name=f"gapp-sink-{self.host_id}")
            self._thread.start()
        return self

    def spill(self) -> None:
        """Flush barrier (store-interface parity): block until every
        enqueued chunk has been sent (or the sink failed/closed)."""
        self.flush()

    def flush(self, timeout: float | None = 10.0) -> bool:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while self._pending > 0 and not self.failed:
                rem = None if deadline is None else deadline - time.monotonic()
                if rem is not None and rem <= 0:
                    return False
                self._drained.wait(0.05 if rem is None else min(rem, 0.05))
            return not self.failed

    def close(self, timeout: float | None = 10.0) -> None:
        """Flush, send BYE, stop the sender; seal the journal."""
        with self._lock:
            if self._closing:
                pass
            else:
                self._closing = True
                self._q.append(self._CLOSE)
                self._not_empty.notify()
        if self._thread is not None:
            self._thread.join(timeout)
        with self._lock:
            if self._journal is not None:
                self._write_meta()
                self._journal.close()
                self._journal = None

    def abort(self) -> None:
        """Ungraceful kill (chaos/testing): sever the socket mid-stream —
        no flush, no BYE — and stop the sender, like the process died.
        Queued chunks are discarded; a journaled capture loses nothing
        (a new sink opened on the same journal resumes the instance and
        the reconnect replay re-delivers whatever the server missed)."""
        self._abort = True
        with self._lock:
            self._closing = True
            self._q.clear()
            self._pending = 0
            self._not_empty.notify_all()
            self._not_full.notify_all()
            self._drained.notify_all()
        sock = self._cur_sock
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
        if self._thread is not None:
            self._thread.join(2.0)
        with self._lock:
            if self._journal is not None:
                # seal for fd hygiene only — no meta write: the journal is
                # crash-consistent by construction, and resume trusts the
                # block count, not this process's dying breath
                self._journal.close()
                self._journal = None

    def stats(self) -> dict:
        return {"host_id": self.host_id, "rows_sent": self.rows_sent,
                "chunks_sent": self.chunks_sent,
                "dropped_chunks": self.dropped_chunks,
                "pending": self._pending,
                "reconnects": self.reconnects,
                "send_errors": self.send_errors, "failed": self.failed,
                "codec": self.codec,
                "replayed_chunks": self.replayed_chunks,
                "replayed_rows": self.replayed_rows,
                "heartbeats_sent": self.heartbeats_sent,
                "journal_errors": self.journal_errors,
                "server_wire_version": self.server_wire_version,
                "wire_bytes": self.wire_bytes, "raw_bytes": self.raw_bytes,
                "journal": self.journal_path}

    # -- sender thread -------------------------------------------------------
    def _resolve(self, v, default):
        if v is None:
            return default
        return v() if callable(v) else v

    def _connect(self):
        conn_idx = 0
        if self.fault_plan is not None:
            conn_idx = self.fault_plan.connect(self.host_id)
        sock = socket.create_connection(self.addr,
                                        timeout=self.connect_timeout)
        sock.settimeout(self.connect_timeout)
        f = sock.makefile("rwb")
        if self.fault_plan is not None:
            f = self.fault_plan.wrap_producer(self.host_id, f, conn_idx)
        nw, names = self._worker_table()
        self._send(f, wire.encode_hello(
            self.host_id, nw, names, t_client_ns=int(self.clock()),
            clock_offset_ns=self.clock_offset_ns, instance=self.instance,
            codecs=self.codecs))
        f.flush()
        frame = wire.read_frame(f)
        if frame is None or frame[0] != wire.WELCOME:
            raise wire.WireError("no WELCOME after HELLO")
        w = wire.decode_json(frame[1])
        self.host_index = int(w["host_index"])
        self.epoch = int(w["epoch"])
        self.server_wire_version = int(w.get("server_wire_version", 1))
        ack = w.get("ack_seq")              # absent on a v1 server
        self.ack_seq = None if ack is None else int(ack)
        if self._journal is not None and self.ack_seq is not None:
            # acked blocks are durable server-side: release them to the
            # journal's retention policy (no-op without retain_blocks=)
            self._journal.set_ack_floor(self.ack_seq)
        codec = w.get("codec", wire.RAW)    # server's pick from our offer
        self.codec = codec if codec in self.codecs else wire.RAW
        # rewind the registry sync counters to the server's high-water
        # marks: deltas committed against a server that then died (or
        # restored less from its meta) must retransmit
        ts, ss = w.get("tags_seen"), w.get("stacks_seen")
        if ts is not None:
            self._tags_sent = min(self._tags_sent, int(ts))
        if ss is not None:
            self._stacks_sent = min(self._stacks_sent, int(ss))
        return sock, f

    def _send(self, f, frame: bytes) -> None:
        f.write(frame)
        self.wire_bytes += len(frame)
        self.raw_bytes += wire.frame_raw_bytes(frame)

    def _replay(self, f, inflight) -> None:
        """Resend the journal blocks the server has not acked — run right
        after every (re)connect, before any queued chunk, so the stream
        the server folds is gapless.  [ack_seq, floor) covers exactly the
        chunks that are neither server-acked nor still queued locally
        (the queue and the in-flight item re-send themselves)."""
        if self._journal is None or self.ack_seq is None:
            return
        with self._lock:
            if inflight is not None and inflight is not self._CLOSE:
                floor = inflight[0]
            else:
                head = next((it for it in self._q
                             if it is not self._CLOSE), None)
                floor = head[0] if head is not None else self._next_seq
        if self.ack_seq >= floor:
            return
        tags_n, stacks_n = self._sync_registries(f)
        seq = self.ack_seq
        for cols in self._journal.iter_block_columns(skip=self.ack_seq):
            if seq >= floor:
                break
            self._send(f, wire.encode_chunk(
                self.host_index or 0, wire.MERGED_SHARD, self.epoch or 0,
                seq, *cols, codec=self.codec))
            self.replayed_chunks += 1
            self.replayed_rows += len(cols[0])
            if len(cols[0]):
                self._last_sent_t = int(cols[0][-1])
            seq += 1
        f.flush()
        # same commit rule as the live path: a flush that raised re-runs
        # the whole replay (and the registry deltas) after reconnect
        self._tags_sent, self._stacks_sent = tags_n, stacks_n

    def _sync_registries(self, f) -> tuple[int, int]:
        """Write any registry deltas; returns the (tags, stacks) high-water
        marks to COMMIT only after the whole batch flushes — a frame lost
        to a mid-send failure must be retransmitted after reconnect."""
        tags_n, stacks_n = self._tags_sent, self._stacks_sent
        if self.tags is not None:
            # lock-free read of the live registry: locations is appended
            # *second* under the registry lock, so its length is the safe
            # fully-published high-water mark
            n = min(len(self.tags.names), len(self.tags.locations))
            if n > tags_n:
                self._send(f, wire.encode_tags(
                    [(i, self.tags.names[i], self.tags.locations[i])
                     for i in range(tags_n, n)], codec=self.codec))
                tags_n = n
        if self.stacks is not None:
            n = len(self.stacks.paths)
            if n > stacks_n:
                self._send(f, wire.encode_stacks(
                    [(i, self.stacks.paths[i])
                     for i in range(stacks_n, n)], codec=self.codec))
                stacks_n = n
        return tags_n, stacks_n

    def _backoff(self, attempts: int) -> None:
        """Full-jitter exponential backoff: sleep uniform(0, min(cap,
        base * 2^attempts)).  Jitter decorrelates a fleet of producers
        redialing a restarted aggregator — fixed delays would keep the
        whole fleet thundering in lockstep."""
        cap = min(self.backoff_max,
                  self.reconnect_delay * (1 << min(attempts, 16)))
        delay = self._backoff_rng.uniform(0.0, cap)
        if delay > 0:
            time.sleep(delay)

    def _run(self) -> None:
        sock = f = None
        item = None
        attempts = 0
        last_io = time.monotonic()
        while not self._abort:
            try:
                if f is None:       # connect eagerly: handshake ASAP so the
                    #                 server learns this host before data
                    if attempts > 0:
                        self._backoff(attempts)
                    sock, f = self._connect()
                    self._cur_sock = sock
                    last_io = time.monotonic()
                    # journaled sinks replay the server's unacked tail
                    # before anything queued — seq gaps (lost in-flight
                    # chunks, producer restarts) become recovered history.
                    # Registry maps survive either way: a live server keeps
                    # them in memory, a restarted fleet_dir server restores
                    # them from the host's meta sidecar.
                    self._replay(f, item)
                    if (item is not None and item is not self._CLOSE
                            and self.ack_seq is not None
                            and item[0] < self.ack_seq):
                        # the server read the in-flight chunk before the
                        # connection died (our flush just never returned):
                        # resending it would only count a duplicate
                        self.rows_sent += len(item[1][0])
                        self.chunks_sent += 1
                        with self._lock:
                            self._pending -= 1
                            self._drained.notify_all()
                        item = None
                    if attempts > 0:
                        self.reconnects += 1
                    attempts = 0
                if item is None:
                    with self._lock:
                        if not self._q:
                            self._not_empty.wait(0.25)
                        if self._q:
                            item = self._q.popleft()
                            self._not_full.notify_all()
                    if item is None:
                        # idle: beacon liveness (and the safe watermark of
                        # the last streamed row) to v3+ servers so a quiet
                        # host neither trips the server's read deadline
                        # nor pins the fleet merge
                        if (self.heartbeat_interval is not None
                                and self.server_wire_version >= 3
                                and time.monotonic() - last_io
                                >= self.heartbeat_interval):
                            self._send(f, wire.encode_heartbeat(
                                self._last_sent_t, codec=self.codec))
                            f.flush()
                            self.heartbeats_sent += 1
                            last_io = time.monotonic()
                        continue
                if item is self._CLOSE:
                    self._send(f, wire.encode_bye(self.rows_sent,
                                                  self.chunks_sent))
                    f.flush()
                    # Delivery barrier.  flush() only proves the kernel
                    # buffered the bytes — a server that died mid-close can
                    # eat the whole tail of the stream (chunks AND the BYE)
                    # without the writer ever seeing an error.  The server
                    # closes the connection after it has *read* the BYE, so
                    # a clean EOF here proves every prior byte was consumed
                    # (the FIN is ordered after them); an RST (close with
                    # our unread data pending) or a timeout means delivery
                    # is uncertain — go around: reconnect, replay the
                    # unacked journal tail, and BYE again.
                    if f.read(1) != b"":
                        raise wire.WireError("unexpected data after BYE")
                    break
                seq, cols = item
                tags_n, stacks_n = self._sync_registries(f)
                self._send(f, wire.encode_chunk(
                    self.host_index or 0, wire.MERGED_SHARD, self.epoch or 0,
                    seq, *cols, codec=self.codec))
                f.flush()
                # commit only after the flush: a flush() that raised is
                # retransmitted whole after reconnect — the CHUNK with the
                # SAME seq (server dedups), the registry deltas again
                # (interning is idempotent server-side)
                self._tags_sent, self._stacks_sent = tags_n, stacks_n
                self.rows_sent += len(cols[0])
                self.chunks_sent += 1
                if len(cols[0]):
                    self._last_sent_t = int(cols[0][-1])
                last_io = time.monotonic()
                with self._lock:
                    self._pending -= 1
                    self._drained.notify_all()
                item = None
            except (OSError, wire.WireError) as e:   # reconnect w/ backoff
                if self._abort:
                    return
                self.send_errors += 1
                self.last_error = e
                if f is not None:
                    try:
                        f.close()
                        sock.close()
                    except OSError:
                        pass
                    f = sock = None
                    self._cur_sock = None
                attempts += 1
                if attempts > self.max_reconnects:
                    self._fail()
                    return
            except Exception as e:      # noqa: BLE001 — a sender-thread bug
                # must not leave the sink half-alive: a dead thread with
                # failed=False would let backpressured append_columns spin
                # forever under the tracer's fold lock
                self.send_errors += 1
                self.last_error = e
                self._fail()
                return
        self._cur_sock = None
        if f is not None:
            try:
                f.close()
                sock.close()
            except OSError:
                pass
        with self._lock:
            self._drained.notify_all()

    def _fail(self) -> None:
        with self._lock:
            self.failed = True
            self._pending = 0
            self._q.clear()
            self._not_full.notify_all()
            self._drained.notify_all()


def attach_remote(session, addr: tuple[str, int], *, host_id: str | None = None,
                  **kw) -> RemoteSink:
    """Wire a live session's drain output to an :class:`IngestServer`.

    The sink is appended to the tracer's ``sinks`` (every drained chunk is
    forwarded after it lands in the local store) and started.  Register all
    workers *before* attaching, so the HELLO worker table is complete.
    Returns the sink; call ``sink.close()`` after ``session.close()`` to
    flush and say BYE.

    ``host_id`` must be unique per logical producer (the server treats a
    repeated id as the same host reconnecting and retires its previous
    stream); the default is collision-proof.

    ``journal=path`` makes the sink durable (see :class:`RemoteSink`):
    attach it BEFORE the workload interns tags, so a resumed journal can
    seed the session's still-empty registries, and pass a stable
    ``host_id`` so the server folds both incarnations as one host.
    """
    tracer = session._live()
    sink = RemoteSink(
        addr,
        host_id or f"{socket.gethostname()}:{uuid.uuid4().hex[:10]}",
        num_workers=lambda: tracer.total_count,
        worker_names=lambda: tracer.worker_names(),
        tags=tracer.tags, stacks=tracer.stacks, clock=tracer.clock,
        **kw)
    sink.start()
    tracer.sinks.append(sink)
    return sink


@register_exporter("remote", capabilities={"subscription", "push", "live",
                                           "fleet"})
def _export_remote(rep, *, session=None, addr=None, **kw):
    """``session.export("remote", addr=(host, port))`` — subscription
    exporter: attaches a :class:`RemoteSink` and returns it (no report is
    consumed)."""
    if session is None or addr is None:
        raise ValueError("remote exporter needs session= and addr=")
    return attach_remote(session, addr, **kw)


# ---------------------------------------------------------------------------
# consumer: IngestServer
# ---------------------------------------------------------------------------

class _RefuseChunk(Exception):
    """Internal: a chunk could not be journaled (disk full) — the server
    refuses it WITHOUT advancing the dedup floor and drops the
    connection, so the producer's reconnect replay re-delivers it once
    the disk recovers.  Not a protocol error."""


class _HostState:
    """Server-side per-host bookkeeping (maps live on the HostStream)."""

    def __init__(self, stream: HostStream, instance: str):
        self.stream = stream
        self.instance = instance        # guarded-by: self.host_lock
        self.epoch = 0                  # guarded-by: self.host_lock
        self.next_seq = 0               # guarded-by: self.host_lock
        # BYE bookkeeping lives under the SERVER lock (wait_idle reads it
        # through the _idle condition, which wraps IngestServer._lock)
        self.rows_declared: int | None = None   # guarded-by: IngestServer._lock
        self.got_bye = False                    # guarded-by: IngestServer._lock
        self.open_conns = 0             # loop-thread-owned
        self.last_activity = time.monotonic()   # any frame from this host
        self.codec = wire.RAW           # guarded-by: self.host_lock
        # fleet_dir durability: per-host journal + resume meta
        self.journal: SpillStore | None = None  # guarded-by: self.host_lock
        self.meta_path: str | None = None       # guarded-by: self.host_lock
        self.tag_entries: list = []     # guarded-by: self.host_lock
        self.stack_entries: list = []   # guarded-by: self.host_lock
        self.meta_sizes = (-1, -1)      # guarded-by: self.host_lock
        self.pending_backfill = False   # guarded-by: self.host_lock
        # serializes frame handling across overlapping connections of the
        # same host (an old handler may still drain its socket while the
        # reconnect's handler is live): epoch/seq check-and-commit and the
        # stream push must be one atomic step or a retransmit can fold
        # twice / out of order
        self.host_lock = threading.Lock()


class _Conn:
    """One producer connection's event-loop state (owned by the loop
    thread; no lock)."""

    __slots__ = ("sock", "rbuf", "wbuf", "st", "last_rx", "paused",
                 "closed", "mask")

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.rbuf = bytearray()
        self.wbuf = bytearray()
        self.st: _HostState | None = None   # set by HELLO
        self.last_rx = time.monotonic()
        self.paused = False     # read interest shed (flow control)
        self.closed = False
        self.mask = selectors.EVENT_READ

    def fileno(self) -> int:
        return self.sock.fileno()


class IngestServer:
    """Event-loop ingest endpoint: N producer connections → one
    FleetSource, served by ONE selector thread (the thread-per-connection
    model stopped scaling past a few dozen producers, and its fixed 30s
    blocking reads let a silently-dead producer pin the merge watermark
    for that long).

    ::

        server = IngestServer()            # binds 127.0.0.1:<ephemeral>
        server.start()
        sess = ProfileSession(server.source, n_min=2.0)
        sess.start()
        ...                                 # RemoteSinks connect & stream
        server.wait_idle()                  # every producer said BYE
        rep = sess.result()                 # fleet-wide report
        server.close()

    Liveness & degradation knobs:

    * ``read_deadline`` — a connection that delivers NO bytes for this
      long is closed (``deadline_closed``).  v3 producers heartbeat while
      idle, so only dead peers trip it.
    * ``idle_release`` — a host with no frame activity for this long is
      exempted from the merge watermark (``idle_released``;
      ``source.stats()["idle_hosts"]``) so it cannot stall every healthy
      host's emission; data arriving later re-arms gating (and clamps,
      like any late joiner).
    * ``max_pending_rows`` — per-host merge-buffer budget.  Journaled
      hosts (``fleet_dir=``) shed their OLDEST buffered chunks over
      budget (``shed_chunks``/``shed_rows`` — recoverable offline via
      ``from_fleet_dir``, so overload degrades the live report, never
      history); non-journaled hosts are read-paused instead (lossless
      TCP backpressure back to the producer).

    ``device`` goes to the :class:`FleetSource` the server builds (when no
    ``source=`` is given): a session over ``server.source`` folds there
    (default CUDA; CUDA without a card raises).
    """

    def __init__(self, addr: tuple[str, int] = ("127.0.0.1", 0), *,
                 source: FleetSource | None = None, tags=None, stacks=None,
                 chunk_events: int = 1 << 16, backlog: int = 16,
                 clock=time.time_ns, fleet_dir: str | None = None,
                 fleet_fsync: bool = False,
                 fleet_rotate_bytes: int | None = None,
                 read_deadline: float | None = 30.0,
                 idle_release: float | None = 30.0,
                 max_pending_rows: int | None = None,
                 fault_plan=None,
                 compression: str | None = wire.ZLIB, device=None):
        self.source = source if source is not None else FleetSource(
            tags=tags, stacks=stacks, chunk_events=chunk_events,
            device=device)
        self.clock = clock
        self.read_deadline = (None if read_deadline is None
                              else float(read_deadline))
        self.idle_release = (None if idle_release is None
                             else float(idle_release))
        self.max_pending_rows = (None if max_pending_rows is None
                                 else max(int(max_pending_rows), 1))
        self.fleet_rotate_bytes = fleet_rotate_bytes
        self.fault_plan = fault_plan
        # durable per-host stores: journal + meta sidecar per host under
        # this directory; a restarted server restores dedup floors and
        # backfills reconnecting hosts' history from them
        self.fleet_dir = str(fleet_dir) if fleet_dir else None
        self.fleet_fsync = bool(fleet_fsync)    # fsync per journaled chunk
        if self.fleet_dir:
            os.makedirs(self.fleet_dir, exist_ok=True)
        self._journal_names: dict[str, str] = {}
        # preferred payload codec (None => raw); the handshake can only
        # ever select a codec the producer offered
        self.compression = compression
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(tuple(addr))
        self._sock.listen(backlog)
        self._sock.setblocking(False)
        self.address: tuple[str, int] = self._sock.getsockname()[:2]
        self._loop_thread: threading.Thread | None = None
        self._sel: selectors.BaseSelector | None = None
        self._wake_r: socket.socket | None = None
        self._wake_w: socket.socket | None = None
        self._conns: set[_Conn] = set()     # loop-thread-owned
        self._conn_socks: set[socket.socket] = set()    # guarded-by: self._lock
        self._hosts: dict[str, _HostState] = {}         # guarded-by: self._lock
        self._lock = threading.Lock()
        # leaf lock for bare counters: safe to take under st.host_lock (taking
        # self._lock there would ABBA-deadlock with _register_host, which
        # holds self._lock and then takes st.host_lock)
        self._stats_lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self._open_conns = 0                # guarded-by: self._lock
        self._stopped = threading.Event()   # stop accepting
        self._shutdown = threading.Event()  # stop the loop entirely
        # counters
        self.connections = 0                # guarded-by: self._lock
        self.stale_chunks = 0               # guarded-by: self._stats_lock
        self.duplicate_chunks = 0           # guarded-by: self._stats_lock
        self.lost_chunks = 0                # guarded-by: self._stats_lock
        self.bad_rows = 0                   # guarded-by: self._stats_lock
        self.proto_errors = 0               # guarded-by: self._stats_lock
        self.worker_growth_rejected = 0     # guarded-by: self._lock
        self.backfilled_chunks = 0          # guarded-by: self._stats_lock
        self.backfilled_rows = 0            # guarded-by: self._stats_lock
        self.deadline_closed = 0            # guarded-by: self._stats_lock
        self.idle_released = 0              # guarded-by: self._stats_lock
        self.shed_chunks = 0                # guarded-by: self._stats_lock
        self.shed_rows = 0                  # guarded-by: self._stats_lock
        self.journal_errors = 0             # guarded-by: self._stats_lock
        self.heartbeats = 0                 # guarded-by: self._stats_lock

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "IngestServer":
        if self._loop_thread is None:
            self.source.accepting = True
            self._sel = selectors.DefaultSelector()
            self._wake_r, self._wake_w = socket.socketpair()
            self._wake_r.setblocking(False)
            self._wake_w.setblocking(False)
            self._sel.register(self._sock, selectors.EVENT_READ, "accept")
            self._sel.register(self._wake_r, selectors.EVENT_READ, "wake")
            self._loop_thread = threading.Thread(
                target=self._loop, daemon=True, name="gapp-ingest")
            self._loop_thread.start()
        return self

    def _wake(self) -> None:
        w = self._wake_w
        if w is not None:
            try:
                w.send(b"x")
            except OSError:
                pass

    def __enter__(self) -> "IngestServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def stop(self) -> None:
        """Stop accepting; existing connections keep draining.  The fleet
        chunk stream can then end once every host finished."""
        self._stopped.set()
        self._wake()
        self.source.accepting = False
        self.source.notify()

    def close(self) -> None:
        self.stop()
        self._shutdown.set()
        self._wake()
        t = self._loop_thread
        if t is not None:
            t.join(timeout=5.0)
            self._loop_thread = None
        try:
            self._sock.close()
        except OSError:
            pass
        # sever any socket the loop left open — ABORTIVELY (SO_LINGER 0
        # makes close send RST, never FIN).  A graceful shutdown here
        # would be a lie: the loop is gone and anything still buffered in
        # these sockets (or parked unparsed in a conn's rbuf) was
        # discarded unread, but a FIN reads as "everything before it was
        # consumed" — it would pass the sinks' BYE delivery barrier and
        # turn a recoverable server death into silent loss.  The RST
        # tells producers delivery is uncertain; they reconnect and
        # replay their unacked journal tail.
        with self._lock:
            socks = list(self._conn_socks)
        for c in socks:
            try:
                c.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                             struct.pack("ii", 1, 0))
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        if self._sel is not None:
            try:
                self._sel.close()
            except OSError:
                pass
            self._sel = None
        for w in (self._wake_r, self._wake_w):
            if w is not None:
                try:
                    w.close()
                except OSError:
                    pass
        self._wake_r = self._wake_w = None
        with self._lock:
            hosts = list(self._hosts.values())
        for st in hosts:        # seal the durable per-host stores
            with st.host_lock:
                if st.journal is not None:
                    st.journal.close()
                    if st.journal.blocks == 0 and st.stream.rows_in == 0:
                        # a host that handshook but never delivered a
                        # chunk must not leak an empty journal + meta
                        # (from_fleet_dir would replay a ghost host)
                        for p in (st.journal.path, st.meta_path):
                            if p:
                                try:
                                    os.remove(p)
                                except OSError:
                                    pass
                        st.journal = None
                    else:
                        self._write_host_meta(st)
        self.source.notify()

    def finish_host(self, host_id: str) -> bool:
        """Operator override: retire a host that died without BYE (its
        unfinished stream otherwise pins the merge watermark and healthy
        hosts' chunks buffer until ``request_stop``)."""
        with self._lock:
            st = self._hosts.get(host_id)
        if st is None:
            return False
        # finish() flips merge-gating state the gather loop reads under
        # the fleet condition: an unlocked flip can be missed by a
        # concurrent _gather_locked and stall the watermark a full poll
        with self.source.cond:
            st.stream.finish()
            self.source.cond.notify_all()
        return True

    def wait_idle(self, timeout: float | None = 10.0) -> bool:
        """Block until every host that ever connected said BYE and no
        connection remains open.  True on success."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._idle:
            while True:
                done = (self._open_conns == 0 and self._hosts
                        and all(h.got_bye for h in self._hosts.values()))
                if done:
                    return True
                rem = None if deadline is None else deadline - time.monotonic()
                if rem is not None and rem <= 0:
                    return False
                self._idle.wait(0.05 if rem is None else min(rem, 0.05))

    def stats(self) -> dict:
        with self._lock:
            out = {
                "address": list(self.address),
                "connections": self.connections,
                "open_connections": self._open_conns,
                "hosts": len(self._hosts),
                "stale_chunks": self.stale_chunks,
                "duplicate_chunks": self.duplicate_chunks,
                "lost_chunks": self.lost_chunks,
                "bad_rows": self.bad_rows,
                "proto_errors": self.proto_errors,
                "backfilled_chunks": self.backfilled_chunks,
                "backfilled_rows": self.backfilled_rows,
                "deadline_closed": self.deadline_closed,
                "idle_released": self.idle_released,
                "shed_chunks": self.shed_chunks,
                "shed_rows": self.shed_rows,
                "journal_errors": self.journal_errors,
                "heartbeats": self.heartbeats,
                "fleet_dir": self.fleet_dir,
            }
        out.update(self.source.stats())
        return out

    def host_journals(self) -> dict[str, SpillStore]:
        """Snapshot of the durable per-host journals (``fleet_dir=`` mode;
        empty otherwise) — the hook a retention driver or metrics scrape
        walks.  Locks are taken per entry and released before return, so
        callers may do slow work (pruning) against the returned stores
        without holding any server lock."""
        with self._lock:
            hosts = list(self._hosts.items())
        out: dict[str, SpillStore] = {}
        for host_id, st in hosts:
            with st.host_lock:
                if st.journal is not None:
                    out[host_id] = st.journal
        return out

    # -- event loop ----------------------------------------------------------
    def _loop(self) -> None:  # lint: event-loop
        """The selector loop: accepts, reads, frame dispatch, writes, and
        the deadline/idle/flow-control sweep — one thread for the whole
        fleet."""
        listener_on = True
        while not self._shutdown.is_set():
            if self._stopped.is_set() and listener_on:
                try:
                    self._sel.unregister(self._sock)
                except (KeyError, ValueError):
                    pass
                listener_on = False
            try:
                events = self._sel.select(0.05)
            except OSError:
                return
            for key, mask in events:
                data = key.data
                if data == "accept":
                    self._do_accept()
                elif data == "wake":
                    try:
                        while self._wake_r.recv(4096):
                            pass
                    except (BlockingIOError, OSError):
                        pass
                else:
                    conn = data
                    if mask & selectors.EVENT_WRITE and not conn.closed:
                        self._flush_wbuf(conn)
                    if mask & selectors.EVENT_READ and not conn.closed:
                        self._do_read(conn)
            self._sweep(time.monotonic())

    def _do_accept(self) -> None:
        while True:
            try:
                s, _ = self._sock.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return
            s.setblocking(False)
            conn = _Conn(s)
            self._conns.add(conn)
            self._sel.register(s, selectors.EVENT_READ, conn)
            with self._idle:
                self.connections += 1
                self._open_conns += 1
                self._conn_socks.add(s)

    def _do_read(self, conn: _Conn) -> None:
        try:
            data = conn.sock.recv(1 << 18)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._close_conn(conn)
            return
        if not data:
            self._close_conn(conn)      # EOF (a torn rbuf tail dies with it)
            return
        conn.rbuf += data
        conn.last_rx = time.monotonic()
        if conn.st is not None:
            conn.st.last_activity = conn.last_rx
        self._parse_rbuf(conn)

    def _parse_rbuf(self, conn: _Conn) -> None:
        """Dispatch every complete frame buffered on ``conn`` (until a
        flow-control pause or an error closes it).  Also called when a
        paused connection resumes: frames that arrived before the pause
        must not wait for new bytes."""
        try:
            while not conn.closed and not conn.paused:
                got = wire.frame_from_buffer(conn.rbuf)
                if got is None:
                    break
                kind, payload, consumed = got
                del conn.rbuf[:consumed]
                self._dispatch(conn, kind, payload)
        except (wire.WireError, KeyError, ValueError):
            with self._stats_lock:
                self.proto_errors += 1
            self._close_conn(conn)
        except _RefuseChunk:
            self._close_conn(conn)
        except OSError:
            self._close_conn(conn)

    def _dispatch(self, conn: _Conn, kind: int, payload: bytes) -> None:
        if conn.st is None:
            if kind != wire.HELLO:
                raise wire.WireError("expected HELLO")
            hello = wire.decode_hello(payload)
            st = self._register_host(hello)
            conn.st = st
            st.open_conns += 1
            st.last_activity = time.monotonic()
            with st.host_lock:
                ack, codec = st.next_seq, st.codec
                tags_seen = len(st.tag_entries)
                stacks_seen = len(st.stack_entries)
            # reply stamped with the PEER's schema version: a v1 decoder
            # rejects v2/v3-stamped frames (the extra keys are harmless)
            self._send_conn(conn, wire.encode_welcome(
                st.stream.index, st.epoch, st.stream.clock_offset_ns,
                ack_seq=ack, codec=codec, tags_seen=tags_seen,
                stacks_seen=stacks_seen,
                version=int(hello["wire_version"])))
            return
        st = conn.st
        if kind == wire.CHUNK:
            self._on_chunk(conn, st, wire.decode_chunk(payload))
        elif kind == wire.TAGS:
            self._on_tags(st, wire.decode_json(payload))
        elif kind == wire.STACKS:
            self._on_stacks(st, wire.decode_json(payload))
        elif kind == wire.HEARTBEAT:
            self._on_heartbeat(st, wire.decode_json(payload))
        elif kind == wire.BYE:
            bye = wire.decode_json(payload)
            with self._lock:
                st.rows_declared = int(bye.get("rows_sent", -1))
                st.got_bye = True
            with self.source.cond:
                st.stream.finish()
                self.source.cond.notify_all()
            self._close_conn(conn)
        else:
            raise wire.WireError(
                f"unexpected {wire.KIND_NAMES.get(kind, kind)}")

    def _send_conn(self, conn: _Conn, data: bytes) -> None:
        conn.wbuf += data
        self._flush_wbuf(conn)

    def _flush_wbuf(self, conn: _Conn) -> None:
        if conn.wbuf and not conn.closed:
            try:
                n = conn.sock.send(conn.wbuf)
                del conn.wbuf[:n]
            except (BlockingIOError, InterruptedError):
                pass
            except OSError:
                self._close_conn(conn)
                return
        self._update_interest(conn)

    def _update_interest(self, conn: _Conn) -> None:
        if conn.closed:
            return
        mask = 0
        if not conn.paused:
            mask |= selectors.EVENT_READ
        if conn.wbuf:
            mask |= selectors.EVENT_WRITE
        if mask == conn.mask:
            return
        try:
            if conn.mask == 0 and mask:
                self._sel.register(conn.sock, mask, conn)
            elif mask == 0:
                self._sel.unregister(conn.sock)
            else:
                self._sel.modify(conn.sock, mask, conn)
        except (KeyError, ValueError, OSError):
            self._close_conn(conn)
            return
        conn.mask = mask

    def _close_conn(self, conn: _Conn) -> None:
        if conn.closed:
            return
        conn.closed = True
        if conn.mask:
            try:
                self._sel.unregister(conn.sock)
            except (KeyError, ValueError, OSError):
                pass
            conn.mask = 0
        try:
            conn.sock.close()
        except OSError:
            pass
        if conn.st is not None:
            conn.st.open_conns -= 1
        self._conns.discard(conn)
        with self._idle:
            self._open_conns -= 1
            self._conn_socks.discard(conn.sock)
            self._idle.notify_all()
        self.source.notify()

    def _sweep(self, now: float) -> None:
        """Per-iteration housekeeping: read deadlines, flow-control
        resume, idle-host watermark release."""
        for conn in list(self._conns):
            if conn.closed:
                continue
            if (self.read_deadline is not None
                    and now - conn.last_rx > self.read_deadline):
                # a peer that writes NOTHING for the whole deadline is
                # dead or partitioned (v3 producers heartbeat while
                # idle): reclaim the fd; a live peer reconnects
                with self._stats_lock:
                    self.deadline_closed += 1
                self._close_conn(conn)
                continue
            if conn.paused and conn.st is not None \
                    and self.max_pending_rows is not None \
                    and (conn.st.stream.buffered_rows
                         <= self.max_pending_rows // 2):
                conn.paused = False      # drained below low-water: resume
                self._parse_rbuf(conn)   # frames buffered during the pause
                self._update_interest(conn)
        if self.idle_release is None:
            return
        with self._lock:
            hosts = list(self._hosts.values())
        for st in hosts:
            if st.stream.finished or st.stream.idle_exempt:
                continue
            if now - st.last_activity > self.idle_release:
                with self.source.cond:
                    st.stream.idle_exempt = True
                    self.source.cond.notify_all()
                with self._stats_lock:
                    self.idle_released += 1

    def _register_host(self, hello: dict) -> _HostState:
        host_id = str(hello["host_id"])
        instance = str(hello.get("instance", ""))
        declared = hello.get("clock_offset_ns")
        offset = (int(declared) if declared is not None
                  else int(self.clock()) - int(hello["t_client_ns"]))
        codec = (wire.negotiate_codec(hello.get("codecs"),
                                      (self.compression,))
                 if self.compression else wire.RAW)
        with self._lock:
            st = self._hosts.get(host_id)
            if st is None:
                stream = self.source.add_host(
                    host_id, int(hello["num_workers"]),
                    hello.get("worker_names"), clock_offset_ns=offset)
                st = self._hosts[host_id] = _HostState(stream, instance)
                if self.fleet_dir:
                    self._open_host_journal(st, instance)
            else:                       # reconnect: new clock-sync epoch
                with st.host_lock:
                    st.epoch += 1
                    st.stream.clock_offset_ns = offset
                    st.got_bye = False
                    st.stream.finished = False
                    if instance != st.instance:
                        # producer RESTART, not a reconnect: a fresh
                        # capture numbers its chunks from 0 again — reset
                        # the dedup floor or every new chunk would drop as
                        # a retransmit.  (A journal-resumed restart repeats
                        # the old instance and lands in the branch above.)
                        st.instance = instance
                        st.next_seq = 0
                        if st.journal is not None:
                            # rotate the durable store: the old capture's
                            # journal must not pollute the new capture
                            st.journal.close()
                            st.journal = self._wrap_journal(
                                st.stream.host_id,
                                SpillStore(st.journal.path,
                                           rotate_bytes=self.fleet_rotate_bytes))
                            st.tag_entries = []
                            st.stack_entries = []
                # workers registered since the first HELLO: grow the host's
                # id space when it still owns the tail of the fleet range
                # (growth of an interior host would collide with the next
                # host's offsets — counted, rows filtered as bad_rows)
                nw = int(hello["num_workers"])
                if nw > st.stream.num_workers and not \
                        self.source.try_grow_host(
                            st.stream, nw, hello.get("worker_names")):
                    self.worker_growth_rejected += 1
            with st.host_lock:
                st.codec = codec
                if st.meta_path is not None:
                    self._write_host_meta(st)   # fresh index/offset/workers
        if st.pending_backfill:
            # replay the journaled history OUTSIDE the server lock (it can
            # be a long disk read — other hosts' handshakes, stats() and
            # close() must not stall behind it); st.host_lock keeps the host's
            # own frame handlers out until the history is fully pushed, so
            # within-host stream order is preserved
            with st.host_lock:
                if st.pending_backfill:
                    st.pending_backfill = False
                    self._backfill(st)
        return st

    # -- fleet_dir durability ------------------------------------------------
    def _journal_base(self, host_id: str) -> str:
        safe = re.sub(r"[^A-Za-z0-9._-]+", "_", host_id).strip("._") or "host"
        owner = self._journal_names.get(safe)
        if owner is None:
            # across a server restart the in-memory map is empty: the
            # on-disk meta records which host_id owns this filename
            meta = load_json(os.path.join(self.fleet_dir,
                                           safe + ".meta.json"))
            if meta:
                owner = meta.get("host_id")
        if owner is not None and owner != host_id:
            # two distinct ids sanitize to the same filename: disambiguate
            # (deterministic, so the same host finds its journal again)
            safe += "-" + hashlib.sha1(host_id.encode()).hexdigest()[:8]
        self._journal_names[safe] = host_id
        return safe

    # lint: disable=guarded-by(first-HELLO construction: the caller holds IngestServer._lock for the whole branch, so no frame handler can reach this _HostState through self._hosts yet)
    def _open_host_journal(self, st: _HostState, instance: str) -> None:
        """First HELLO of a host on this server: open its durable store.
        When a meta sidecar from a previous server run matches the
        producer's capture instance, this server RESUMED: restore the
        dedup floor (the WELCOME ack_seq survives the restart), rebuild
        the registry maps from the persisted entries, and backfill the
        merge with the journaled history — the host reconnects *with*
        history instead of starting a hole."""
        base = self._journal_base(st.stream.host_id)
        jpath = os.path.join(self.fleet_dir, base + ".spill")
        st.meta_path = os.path.join(self.fleet_dir, base + ".meta.json")
        meta = load_json(st.meta_path)
        if (meta and instance and meta.get("instance") == instance
                and os.path.exists(jpath)):
            st.journal = SpillStore.open_append(
                jpath, rotate_bytes=self.fleet_rotate_bytes)
            # block index == accepted seq (every accepted chunk journals
            # exactly one block; accepted seq GAPS journal empty fillers),
            # so the complete-block count IS the dedup floor — no reliance
            # on the meta's possibly-stale next_seq
            st.next_seq = st.journal.blocks
            self._restore_maps(st, meta)
            st.pending_backfill = st.journal.blocks > 0
        else:
            # fresh capture: truncate
            st.journal = SpillStore(jpath,
                                    rotate_bytes=self.fleet_rotate_bytes)
        st.journal = self._wrap_journal(st.stream.host_id, st.journal)

    def _wrap_journal(self, host_id: str, store):
        if self.fault_plan is not None:
            return self.fault_plan.wrap_journal(host_id, store)
        return store

    def _restore_maps(self, st: _HostState, meta: dict) -> None:
        for i, ent in enumerate(meta.get("tags") or []):
            if ent is not None:
                _set_entry(st.tag_entries, i, [str(ent[0]), str(ent[1])])
        for i, path in enumerate(meta.get("stacks") or []):
            if path is not None:
                _set_entry(st.stack_entries, i, [int(t) for t in path])
        restore_host_maps(st.stream, self.source.tags, self.source.stacks,
                          st.tag_entries, st.stack_entries)

    def _backfill(self, st: _HostState) -> None:
        """Feed a resumed host's journaled history into the merge (the
        maps are already restored, so push normalizes it exactly like the
        live chunks it preceded)."""
        for cols in st.journal.iter_block_columns():
            if len(cols[0]) == 0:
                continue
            with self.source.cond:
                st.stream.push(*cols)
                self.source.cond.notify_all()
            with self._stats_lock:
                self.backfilled_chunks += 1
                self.backfilled_rows += len(cols[0])

    def _write_host_meta(self, st: _HostState) -> None:  # guarded-by: _HostState.host_lock
        if st.meta_path is None:
            return
        st.meta_sizes = (len(st.tag_entries), len(st.stack_entries))
        s = st.stream
        write_json_atomic(st.meta_path, {
            "host_id": s.host_id, "instance": st.instance,
            "host_index": s.index, "next_seq": st.next_seq,
            "num_workers": s.num_workers, "worker_names": s.worker_names,
            "clock_offset_ns": s.clock_offset_ns,
            "journal": (os.path.basename(st.journal.path)
                        if st.journal is not None else None),
            "tags": st.tag_entries, "stacks": st.stack_entries,
        })

    # -- frame handlers (serialized per host via st.host_lock) --------------------
    def _on_tags(self, st: _HostState, obj: dict) -> None:
        stream = st.stream
        with st.host_lock:
            for tid, name, loc in obj["entries"]:
                stream.tag_map = _grow_map(stream.tag_map, int(tid))
                stream.tag_map[int(tid)] = self.source.tags.intern(
                    str(name), str(loc))
                _set_entry(st.tag_entries, int(tid), [str(name), str(loc)])
            # persist only real growth (registry rewrites are full-file;
            # a delta frame that interned nothing new must not pay one)
            if len(st.tag_entries) != st.meta_sizes[0]:
                self._write_host_meta(st)

    def _on_stacks(self, st: _HostState, obj: dict) -> None:
        stream = st.stream
        with st.host_lock:
            for sid, path in obj["entries"]:
                fleet_path = []
                for t in path:
                    stream.tag_map = _grow_map(stream.tag_map, int(t))
                    fleet_path.append(int(stream.tag_map[int(t)]))
                stream.stack_map = _grow_map(stream.stack_map, int(sid))
                stream.stack_map[int(sid)] = self.source.stacks.intern(
                    tuple(fleet_path))
                _set_entry(st.stack_entries, int(sid),
                           [int(t) for t in path])
            if len(st.stack_entries) != st.meta_sizes[1]:
                self._write_host_meta(st)

    def _on_heartbeat(self, st: _HostState, obj: dict) -> None:
        """HEARTBEAT (wire v3): "I am alive; everything up to t_ns has
        been sent."  Advances the host's merge watermark so an idle-but-
        healthy producer never pins the fleet fold, and marks a host that
        has NO data yet (``t_ns`` null) watermark-exempt — alive-but-
        dataless must not stall the merge either (its first real chunk
        re-arms gating)."""
        with self._stats_lock:
            self.heartbeats += 1
        t_ns = obj.get("t_ns")
        with self.source.cond:
            if t_ns is not None:
                st.stream.advance_watermark(int(t_ns))
            elif st.stream.last_seen_ns is None:
                st.stream.idle_exempt = True
            self.source.cond.notify_all()

    def _on_chunk(self, conn: _Conn, st: _HostState,
                  chunk: wire.ChunkFrame) -> None:
        with st.host_lock:
            # epoch/seq check + commit + push are one atomic step: an old
            # connection's handler racing a reconnect's handler must not
            # fold a retransmit twice or interleave pushes out of order
            if chunk.epoch != st.epoch:
                with self._stats_lock:
                    self.stale_chunks += 1
                return
            if chunk.seq < st.next_seq:  # retransmit of a delivered chunk
                with self._stats_lock:
                    self.duplicate_chunks += 1
                return
            gap = int(chunk.seq - st.next_seq)
            w = chunk.workers
            bad = (w < 0) | (w >= st.stream.num_workers)
            nbad = int(bad.sum())
            if nbad:                   # worker registered after HELLO
                keep = ~bad
                cols = tuple(c[keep] for c in chunk.columns)
            else:
                cols = chunk.columns
            if st.journal is not None:
                # durable BEFORE commit/push: block index == seq is the
                # resume-floor invariant, so every accepted seq must
                # journal exactly one block (even an all-filtered one),
                # and an accepted GAP journals empty filler blocks — a
                # restarted server's floor (journal.blocks) then never
                # re-accepts a seq it already folded.  Raw host-local
                # columns — normalization replays at read time (backfill
                # push / from_fleet_dir), like the live path.  The filler
                # loop keys on the journal's ACTUAL block count, so a
                # disk-full retry never double-appends fillers.
                empty = [np.zeros(0, dt) for dt in wire.COL_DTYPES]
                try:
                    while st.journal.blocks < chunk.seq:
                        st.journal.append_block(*empty)
                    st.journal.append_block(*cols, sync=self.fleet_fsync)
                except OSError as e:
                    # journal full: REFUSE the chunk (close the conn
                    # without committing) — the floor is unchanged, so
                    # the producer's reconnect replay re-delivers it once
                    # the disk recovers.  Accepting it un-journaled would
                    # silently break the blocks == seq invariant.
                    with self._stats_lock:
                        self.journal_errors += 1
                    raise _RefuseChunk() from e
            if gap:
                # a gap means chunks committed producer-side (flush reached
                # the kernel) never arrived — e.g. lost in a reset before
                # the server read them.  A journaling producer recovers
                # them on its next reconnect (ack replay); otherwise count
                # them loudly: delivery is at-most-once with loss
                # DETECTION, not recovery (the sink only retains the one
                # in-flight chunk)
                with self._stats_lock:
                    self.lost_chunks += gap
            if nbad:
                with self._stats_lock:
                    self.bad_rows += nbad
            st.next_seq = chunk.seq + 1
            if len(cols[0]) == 0:
                return
            with self.source.cond:
                st.stream.push(*cols)
                if (self.max_pending_rows is not None
                        and st.stream.buffered_rows > self.max_pending_rows):
                    if st.journal is not None:
                        # overload, durable host: shed the OLDEST buffered
                        # parts — they are journaled, so from_fleet_dir
                        # recovers them offline; the live report counts
                        # them as shed, never silently drops them
                        chunks, rows = st.stream.shed_oldest(
                            self.max_pending_rows)
                        if chunks:
                            self.source.shed_chunks += chunks
                            self.source.shed_rows += rows
                            with self._stats_lock:
                                self.shed_chunks += chunks
                                self.shed_rows += rows
                    else:
                        # no journal → shedding would LOSE data: apply
                        # backpressure instead (stop reading this conn
                        # until the merge drains below the low-water mark)
                        conn.paused = True
                self.source.cond.notify_all()
        if conn.paused:
            self._update_interest(conn)
