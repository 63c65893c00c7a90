"""Disk-spill event store — bounded resident memory for unbounded captures.

The live tracer accumulates every drained+folded chunk into its store so
``freeze()`` can hand the whole run to the offline pipeline.  For long
captures that store is the one unbounded allocation left in the profiler
(ROADMAP: "spill the accumulated EventStore to disk so freeze() is also
bounded").  :class:`SpillStore` is a drop-in replacement for
:class:`~repro_torch.core.events.EventStore` that pages full blocks of
``chunk_events`` rows to an append-only file: the resident buffer never
holds more than one block, so profiler-side event memory is O(chunk_events)
no matter how many events stream through.

File format (append-only, block-framed)::

    [u64 nrows][times i64*n][workers i32*n][deltas i8*n][tags i32*n]
    [stacks i32*n]  ...repeated per block...

Blocks are written in drain order, which is time order (the tracer's flush
clamps cross-chunk monotonicity), so reading the blocks back in sequence
yields a time-sorted stream with no re-sort:

* :meth:`iter_chunks` streams the file back one :class:`EventLog` block at
  a time — what :class:`~repro_torch.core.session.SpillSource` replays through a
  new session in bounded memory;
* :meth:`freeze` materialises the whole stream as one log (the legacy
  whole-log path; unbounded by definition — prefer the streaming reader).

Single-consumer like the stores it replaces: appends come from the
tracer's flush (under its fold lock) or the offline session's fold loop.
Readers never observe a torn block: blocks are append-only and flushed
whole, and every read bounds itself to the flushed-byte watermark taken
under the store lock.  A writer store *owns* its file for one capture
(an existing file at the path is truncated at construction); use
:meth:`SpillStore.open_readonly` to replay a finished capture.

The same block framing doubles as the fleet **journal** format
(:mod:`repro_torch.fleet.transport`): :meth:`SpillStore.open_append` re-opens
an existing file *without* truncating history (a torn tail block — a
crash mid-append — is cut back to the last complete block, so the resume
floor is exact), and :meth:`append_block` writes one caller-framed block
per call with no re-blocking, which pins the invariant journals rely on:
**block index == append order == chunk seq**.

**Rotation + retention** (week-long captures must not grow one unbounded
file): with ``rotate_bytes=``/``rotate_age_s=`` the active file rolls
over once it exceeds the size/age threshold — it is sealed (fsync) and
renamed to ``<path>.g<first_block>.seg``, and appends continue in a fresh
``<path>``.  Block indices are GLOBAL across segments (the filename
records each segment's first block), so *seq == block index* survives any
number of rollovers, and every reader (:meth:`iter_block_columns`,
:meth:`iter_chunks`, :meth:`freeze`) spans the whole segment chain
transparently — including :meth:`open_readonly`/:meth:`open_append` on a
rotated journal.  ``retain_blocks=`` enables pruning: whole segments are
deleted once they fall entirely below BOTH the retention horizon
(``blocks - retain_blocks``) and the **ack floor**
(:meth:`set_ack_floor` — the consumer's durable receive watermark), so
retention can never drop a block a replay might still need.  The default
(``retain_blocks=None``) keeps everything.

**Capture-time block index** (time-windowed queries must not re-read a
week of history): every complete block's first/last event timestamp is
indexed in memory — recovered on open by reading exactly two i64s per
block (the payload's first and last ``times`` entry; payload bodies are
still seeked over, not decoded) and maintained on every append.  Blocks
are written in time order, so a window ``[t_lo, t_hi]`` maps to one
contiguous global block range: :meth:`iter_block_columns_window` seeks
straight to it and decodes only intersecting blocks, and
:meth:`prune_before_time` turns a wall-clock age budget into the same
whole-segment pruning as ``retain_blocks`` (still honouring the ack
floor unless explicitly told the journal has no acking consumer).
"""
from __future__ import annotations

import os
import re
import struct
import threading
import time
from typing import Iterator

import numpy as np

from repro_torch.core.events import EventLog

# Column order and dtypes of one spilled block (matches EventStore/EventLog).
_COL_DTYPES = (np.int64, np.int32, np.int8, np.int32, np.int32)
_HEADER = struct.Struct("<Q")
_ROW_BYTES = sum(np.dtype(dt).itemsize for dt in _COL_DTYPES)

# Sealed rotation segments live next to the active file as
# ``<path>.g<first_block>.seg`` — the name IS the index metadata.
_SEG_RE = re.compile(r"\.g(\d+)\.seg$")


class SpillStore:
    """Append-only on-disk event store with an O(chunk_events) resident buffer.

    Duck-compatible with :class:`~repro_torch.core.events.EventStore`
    (``append_columns`` / ``__len__`` / ``freeze`` / ``nbytes``), so it plugs
    straight into ``Tracer(store=...)`` / ``ProfileSession(spill_path=...)``.
    """

    def __init__(self, path: str, chunk_events: int = 1 << 16, *,
                 rotate_bytes: int | None = None,
                 rotate_age_s: float | None = None,
                 retain_blocks: int | None = None,
                 _readonly: bool = False, _append: bool = False):
        self.path = str(path)
        self.chunk_events = max(int(chunk_events), 1)
        self.rotate_bytes = rotate_bytes
        self.rotate_age_s = rotate_age_s
        self.retain_blocks = retain_blocks
        self._buf = [np.zeros(self.chunk_events, dt) for dt in _COL_DTYPES]
        self._buf_len = 0           # guarded-by: self._lock
        self._rows_on_disk = 0      # guarded-by: self._lock
        # sealed segments, oldest first: [path, first_block, nblocks, nrows]
        self._segments: list[list] = []     # guarded-by: self._lock
        self._active_first = 0      # guarded-by: self._lock -- global index of the active file's block 0
        self._active_rows = 0       # guarded-by: self._lock
        self._active_opened = time.monotonic()  # guarded-by: self._lock
        self._ack_floor = 0         # guarded-by: self._lock
        # capture-time bounds per complete on-disk block, oldest first:
        # (t_first, t_last) or None for an empty (gap-filler) block.  Entry
        # i covers global block ``_index_first + i``.
        self._time_index: list[tuple[int, int] | None] = []  # guarded-by: self._lock
        self._index_first = 0       # guarded-by: self._lock -- global index of _time_index[0]
        self.pruned_blocks = 0      # guarded-by: self._lock -- blocks dropped by retention (exact)
        self._blocks = 0            # guarded-by: self._lock -- complete blocks in the ACTIVE file
        self._bytes_written = 0     # guarded-by: self._lock -- complete bytes in the ACTIVE file
        self._file = None           # guarded-by: self._lock -- lazily opened write handle
        self._closed = _readonly    # guarded-by: self._lock
        self.max_resident_rows = 0  # guarded-by: self._lock -- high-water mark of the RAM buffer
        self._lock = threading.Lock()
        if _readonly:
            self._scan_existing()
        elif _append:
            # journal mode: keep existing complete blocks, cut a torn tail
            # back to the last block boundary so the next append starts at
            # a clean frame (and the block count is an exact resume floor)
            self._scan_existing()
            if os.path.exists(self.path) \
                    and os.path.getsize(self.path) > self._bytes_written:
                with open(self.path, "r+b") as f:
                    f.truncate(self._bytes_written)
        else:
            # a writer store owns its file for exactly one capture: a stale
            # file (or rotated segments) from a previous run at the same
            # path must not leak into this run's freeze()/iter_chunks()
            if os.path.exists(self.path):
                # lint: disable=loop-blocking(SpillStore() truncation unlinks stale segment files only on the producer-RESTART path of _register_host (a new capture instance rotating its journal) -- a rare, bounded handshake cost, not per-frame work)
                os.remove(self.path)
            for _first, seg_path in self._segment_paths():
                try:
                    # lint: disable=loop-blocking(SpillStore() truncation unlinks stale segment files only on the producer-RESTART path of _register_host (a new capture instance rotating its journal) -- a rare, bounded handshake cost, not per-frame work)
                    os.remove(seg_path)
                except OSError:
                    pass

    @classmethod
    def open_readonly(cls, path: str,
                      chunk_events: int = 1 << 16) -> "SpillStore":
        """Open an existing spill file for replay (appends disabled; the
        file is NOT truncated — the writer-mode constructor is)."""
        return cls(path, chunk_events, _readonly=True)

    @classmethod
    def open_append(cls, path: str, chunk_events: int = 1 << 16, *,
                    rotate_bytes: int | None = None,
                    rotate_age_s: float | None = None,
                    retain_blocks: int | None = None) -> "SpillStore":
        """Open a journal: existing complete blocks are kept (a torn tail
        from a crash mid-append is truncated away), and new
        :meth:`append_block` calls extend the file — resuming the
        block-index sequence exactly where the complete history ends,
        across any sealed rotation segments."""
        return cls(path, chunk_events, _append=True,
                   rotate_bytes=rotate_bytes, rotate_age_s=rotate_age_s,
                   retain_blocks=retain_blocks)

    def _segment_paths(self) -> list[tuple[int, str]]:
        """Sealed segments on disk next to ``self.path``, oldest first, as
        ``(first_block, path)``.  listdir + exact-name match (not glob):
        capture paths may contain glob metacharacters."""
        d = os.path.dirname(self.path) or "."
        base = os.path.basename(self.path)
        out: list[tuple[int, str]] = []
        if not os.path.isdir(d):
            return out
        for name in os.listdir(d):
            m = _SEG_RE.search(name)
            if m and name == f"{base}.g{m.group(1)}.seg":
                out.append((int(m.group(1)), os.path.join(d, name)))
        out.sort()
        return out

    @staticmethod
    def _scan_file(path: str) -> tuple[int, int, int, list]:
        """Walk one file's block headers (payload bodies are seeked over,
        not read) -> ``(complete_blocks, rows, complete_bytes, bounds)``.
        ``bounds`` holds one ``(t_first, t_last)`` per complete block
        (``None`` for empty blocks), recovered by reading exactly two i64s
        from each ``times`` column — the capture-time index costs O(blocks)
        seeks, never a payload decode.  A truncated tail — a capture cut
        mid-write (partial header or a header whose payload runs past EOF)
        — is excluded, so readers never decode a torn payload."""
        if not os.path.exists(path):
            return 0, 0, 0, []
        size = os.path.getsize(path)
        blocks = rows = nbytes = 0
        bounds: list[tuple[int, int] | None] = []
        t_size = np.dtype(np.int64).itemsize
        with open(path, "rb") as f:
            while True:
                hdr = f.read(_HEADER.size)
                if len(hdr) < _HEADER.size:
                    break
                (n,) = _HEADER.unpack(hdr)
                start = f.tell()
                end = start + n * _ROW_BYTES
                if end > size:
                    break           # torn tail block: exclude from watermark
                if n:
                    t0 = int(np.frombuffer(f.read(t_size), np.int64)[0])
                    f.seek(start + (n - 1) * t_size)
                    t1 = int(np.frombuffer(f.read(t_size), np.int64)[0])
                    bounds.append((t0, t1))
                else:
                    bounds.append(None)
                f.seek(end)
                rows += n
                blocks += 1
                nbytes += _HEADER.size + n * _ROW_BYTES
        return blocks, rows, nbytes, bounds

    # lint: disable=guarded-by(construction-time: called from __init__ only, before the store is shared with any other thread)
    def _scan_existing(self) -> None:
        """Index an existing capture: sealed rotation segments first (their
        filenames carry the global first-block index), then the active
        file.  Block indices resume exactly where the history ends."""
        for first, seg_path in self._segment_paths():
            nblocks, nrows, _, bounds = self._scan_file(seg_path)
            if nblocks == 0:
                continue
            self._segments.append([seg_path, first, nblocks, nrows])
            self._time_index.extend(bounds)
            self._rows_on_disk += nrows
            self._active_first = first + nblocks
        nblocks, nrows, nbytes, bounds = self._scan_file(self.path)
        self._blocks = nblocks
        self._time_index.extend(bounds)
        self._rows_on_disk += nrows
        self._bytes_written = nbytes
        self._index_first = (self._segments[0][1] if self._segments
                             else self._active_first)

    # -- write side ----------------------------------------------------------
    def _write_cols(self, cols, n: int) -> None:  # guarded-by: self._lock
        """Frame ``n`` rows of ``cols`` as one block (caller holds the
        lock).  Failure-atomic: if the write raises mid-frame (disk full),
        the partial frame is truncated away so the file still ends on a
        block boundary — a failed append consumes no block index, which
        the fleet journals' seq == block-index invariant depends on."""
        if self._file is None:
            self._file = open(self.path, "ab")
            self._active_opened = time.monotonic()
        start = self._bytes_written
        try:
            self._file.write(_HEADER.pack(n))
            for col in cols:
                self._file.write(col[:n].tobytes())
            self._file.flush()      # readers bound themselves to flushed bytes
        except OSError:
            try:
                self._file.close()
            except OSError:
                pass
            self._file = None
            try:
                with open(self.path, "r+b") as f:
                    f.truncate(start)
            except OSError:         # pragma: no cover - fs fully wedged
                pass
            raise
        self._rows_on_disk += n
        self._active_rows += n
        self._blocks += 1
        self._bytes_written += _HEADER.size + n * _ROW_BYTES
        self._time_index.append((int(cols[0][0]), int(cols[0][n - 1]))
                                if n else None)

    def _write_block(self, n: int) -> None:  # guarded-by: self._lock
        """Flush the first ``n`` buffered rows as one framed block."""
        if n == 0:
            return
        self._write_cols(self._buf, n)
        self._buf_len = 0

    def append_block(self, times, workers, deltas, tags, stacks,
                     sync: bool = False) -> int:
        """Journal append: write the given rows as exactly ONE block (no
        re-blocking through the resident buffer), flushed before return so
        the block survives a PROCESS crash when the caller hands the chunk
        onward.  ``sync=True`` additionally fsyncs, extending the guarantee
        to power loss — at a per-block fsync cost the hot ingest path
        usually cannot afford (the fleet transports expose this as an
        opt-in).  Returns the block index — with every append routed
        through here, block index == append order, which the fleet
        journals equate with the chunk ``seq``.  Indices are global across
        rotated segments, and the rotation check runs after each append
        (the journal path is the only rotating writer)."""
        if self._closed:
            raise ValueError(f"SpillStore({self.path}) is closed")
        cols = tuple(np.ascontiguousarray(c, dt) for c, dt in
                     zip((times, workers, deltas, tags, stacks),
                         _COL_DTYPES))
        n = len(cols[0])
        with self._lock:
            # keep disk order == append order if buffered rows exist (a
            # pure journal never mixes the two paths)
            self._write_block(self._buf_len)
            self._write_cols(cols, n)
            if sync:
                os.fsync(self._file.fileno())
            idx = self._active_first + self._blocks - 1
            self._maybe_roll_locked()
            return idx

    def _maybe_roll_locked(self) -> None:  # guarded-by: self._lock
        """Seal the active file into a ``.g<first_block>.seg`` segment when
        it exceeds the size/age threshold (caller holds the lock).  The
        seal fsyncs before the rename, so a sealed segment is always a
        complete, power-loss-durable unit."""
        if self._blocks == 0:
            return
        due = (self.rotate_bytes is not None
               and self._bytes_written >= self.rotate_bytes) \
            or (self.rotate_age_s is not None
                and time.monotonic() - self._active_opened
                >= self.rotate_age_s)
        if not due:
            return
        if self._file is None:      # pragma: no cover - blocks>0 implies open
            self._file = open(self.path, "ab")
        self._file.flush()
        os.fsync(self._file.fileno())
        self._file.close()
        self._file = None
        seg = f"{self.path}.g{self._active_first:010d}.seg"
        os.replace(self.path, seg)
        self._segments.append([seg, self._active_first, self._blocks,
                               self._active_rows])
        self._active_first += self._blocks
        self._blocks = 0
        self._bytes_written = 0
        self._active_rows = 0
        self._active_opened = time.monotonic()
        self._prune_locked()

    def set_ack_floor(self, seq: int) -> None:
        """Raise the consumer-durability watermark: every block below
        ``seq`` is known journaled on the receiving side, so retention may
        prune it.  Monotonic; triggers a prune sweep."""
        with self._lock:
            if int(seq) > self._ack_floor:
                self._ack_floor = int(seq)
            self._prune_locked()

    def _prune_locked(self) -> None:  # guarded-by: self._lock
        """Apply the ``retain_blocks`` count policy: prune below BOTH the
        ack floor and the retention horizon (``blocks - retain_blocks``).
        With ``retain_blocks=None`` (the default) never deletes anything."""
        if self.retain_blocks is None:
            return
        total = self._active_first + self._blocks
        keep_from = min(self._ack_floor, total - int(self.retain_blocks))
        self._drop_segments_below(keep_from)

    def _drop_segments_below(self, keep_from: int) -> int:  # guarded-by: self._lock
        """Delete whole sealed segments whose every block index is below
        ``keep_from``; returns the number of blocks dropped.  Never touches
        the active file and never splits a segment — the shared pruning
        primitive beneath both the block-count policy (:meth:`set_ack_floor`
        / rotation) and the wall-clock age policy
        (:meth:`prune_before_time`)."""
        dropped = 0
        while self._segments:
            seg_path, first, nblocks, nrows = self._segments[0]
            if first + nblocks > keep_from:
                break
            self._segments.pop(0)
            self._rows_on_disk -= nrows
            self.pruned_blocks += nblocks
            dropped += nblocks
            cut = (first + nblocks) - self._index_first
            if cut > 0:
                del self._time_index[:cut]
                self._index_first = first + nblocks
            try:
                os.remove(seg_path)
            except OSError:         # pragma: no cover - best-effort unlink
                pass
        return dropped

    def prune_before_time(self, t_ns: int, *,
                          respect_ack: bool = True) -> int:
        """Age-based retention: drop whole sealed segments in which every
        block's events end before ``t_ns`` (capture-time ns).  Returns the
        number of blocks pruned.

        ``respect_ack=True`` (default) additionally holds the ack floor:
        a block the consumer has not durably acknowledged survives any age
        budget — the producer-journal contract.  Server-side ``fleet_dir``
        journals have no acking consumer (the server IS the consumer), so
        their retention driver passes ``respect_ack=False``.  Works with or
        without ``retain_blocks``; the active file is never touched, so
        pair an age budget with ``rotate_bytes``/``rotate_age_s`` to bound
        disk."""
        with self._lock:
            horizon = self._index_first
            for b in self._time_index:
                if b is not None and b[1] >= int(t_ns):
                    break
                horizon += 1
            keep_from = min(horizon, self._ack_floor) if respect_ack \
                else horizon
            return self._drop_segments_below(keep_from)

    def append_columns(self, times, workers, deltas, tags, stacks) -> None:
        e = len(times)
        if e == 0:
            return
        if self._closed:
            raise ValueError(f"SpillStore({self.path}) is closed")
        cols = (times, workers, deltas, tags, stacks)
        with self._lock:
            lo = 0
            while lo < e:
                take = min(self.chunk_events - self._buf_len, e - lo)
                for buf, arr in zip(self._buf, cols):
                    buf[self._buf_len:self._buf_len + take] = arr[lo:lo + take]
                self._buf_len += take
                lo += take
                self.max_resident_rows = max(self.max_resident_rows,
                                             self._buf_len)
                if self._buf_len == self.chunk_events:
                    self._write_block(self._buf_len)

    def spill(self) -> None:
        """Force the resident buffer to disk (a partial block is fine)."""
        with self._lock:
            self._write_block(self._buf_len)
            if self._file is not None:
                self._file.flush()

    def close(self) -> None:
        """Flush and close the write handle; reads remain available.  A
        closed file is fsynced once, so a cleanly sealed capture/journal
        survives power loss even without per-block ``sync``."""
        self.spill()
        with self._lock:
            if self._file is not None:
                os.fsync(self._file.fileno())
                self._file.close()
                self._file = None
            self._closed = True

    # -- stats ---------------------------------------------------------------
    def __len__(self) -> int:
        return self._rows_on_disk + self._buf_len

    @property
    def rows_on_disk(self) -> int:
        return self._rows_on_disk

    @property
    def blocks(self) -> int:
        """Complete blocks ever written (== the next append_block index).
        Global across rotated segments; pruning does NOT lower it — block
        indices are stable forever."""
        return self._active_first + self._blocks

    @property
    def first_block(self) -> int:
        """Global index of the oldest block still on disk (0 until
        retention pruning removes a segment)."""
        return self._segments[0][1] if self._segments else self._active_first

    @property
    def segments(self) -> int:
        """Sealed rotation segments currently on disk (excludes the active
        file)."""
        return len(self._segments)

    @property
    def resident_rows(self) -> int:
        return self._buf_len

    @property
    def resident_nbytes(self) -> int:
        """RAM held by the store — the fixed one-block buffer."""
        return sum(c.nbytes for c in self._buf)

    # EventStore compat: ``nbytes`` feeds Tracer.memory_bytes, which reports
    # *profiler-side* memory — for a spill store that is the resident buffer,
    # not the file.
    @property
    def nbytes(self) -> int:
        return self.resident_nbytes

    @property
    def spilled_nbytes(self) -> int:
        on_disk_blocks = (self._active_first + self._blocks
                          - self.first_block)
        return self._rows_on_disk * _ROW_BYTES + on_disk_blocks * _HEADER.size

    # -- read side -----------------------------------------------------------
    def _read_limit(self) -> int:
        """Flush the buffer and snapshot the complete-byte boundary: blocks
        are append-only, so reading ``[0, limit)`` is safe against a
        concurrent writer without holding the lock through the read."""
        self.spill()
        with self._lock:
            return self._bytes_written

    def _read_blocks(self, limit: int,
                     skip: int = 0) -> Iterator[tuple[np.ndarray, ...]]:
        """Stream complete blocks across the whole segment chain, then the
        active file (bounded to ``limit`` active-file bytes).  ``skip`` is
        a GLOBAL block index: blocks below it — and any prefix already
        removed by retention pruning — are seeked over, not decoded."""
        segments = list(self._segments)     # snapshot vs concurrent prune
        first_kept = segments[0][1] if segments else self._active_first
        skip = max(0, skip - first_kept)    # pruned prefix needs no seeking
        for seg_path, _first, nblocks, _nrows in segments:
            if skip >= nblocks:
                skip -= nblocks
                continue
            try:
                seg_limit = os.path.getsize(seg_path)
            except OSError:
                continue                    # pruned between snapshot and read
            yield from self._read_file(seg_path, seg_limit, skip)
            skip = 0
        yield from self._read_file(self.path, limit, skip)

    def _read_file(self, path: str, limit: int,
                   skip: int = 0) -> Iterator[tuple[np.ndarray, ...]]:
        if limit <= 0 or not os.path.exists(path):
            return
        with open(path, "rb") as f:
            while skip > 0 and f.tell() < limit:
                # skipped blocks are seeked over, not decoded: a journal
                # replay of a long capture's tail must not re-read (and
                # re-allocate) gigabytes of acked prefix on every reconnect
                hdr = f.read(_HEADER.size)
                if len(hdr) < _HEADER.size:
                    return
                (n,) = _HEADER.unpack(hdr)
                f.seek(n * _ROW_BYTES, os.SEEK_CUR)
                skip -= 1
            while f.tell() < limit:
                hdr = f.read(_HEADER.size)
                if len(hdr) < _HEADER.size:
                    return
                (n,) = _HEADER.unpack(hdr)
                cols = []
                for dt in _COL_DTYPES:
                    raw = f.read(n * np.dtype(dt).itemsize)
                    if len(raw) < n * np.dtype(dt).itemsize:
                        return      # torn tail beyond the watermark: stop
                    cols.append(np.frombuffer(raw, dt).copy())
                yield tuple(cols)

    def iter_block_columns(self, skip: int = 0) \
            -> Iterator[tuple[np.ndarray, ...]]:
        """Raw column tuples, one per complete block, skipping the first
        ``skip`` blocks — the journal replay reader (block index == chunk
        seq, so ``skip=ack_seq`` yields exactly the unacked tail; the
        acked prefix is seeked over, not decoded).  Safe against a
        concurrent :meth:`append_block` writer: bounded to the
        flushed-byte watermark at call time."""
        yield from self._read_blocks(self._read_limit(), skip)

    def time_bounds(self) -> tuple[int, int] | None:
        """Capture-time span ``(t_first, t_last)`` over all complete
        on-disk blocks (the resident buffer is flushed first), or ``None``
        if nothing non-empty is on disk.  O(1) off the in-memory index —
        no file I/O."""
        self.spill()
        with self._lock:
            lo = hi = None
            for b in self._time_index:
                if b is not None:
                    lo = b[0]
                    break
            for b in reversed(self._time_index):
                if b is not None:
                    hi = b[1]
                    break
            return None if lo is None else (lo, hi)

    def iter_block_columns_window(self, t_lo: int, t_hi: int) \
            -> Iterator[tuple[np.ndarray, ...]]:
        """Stream only the complete blocks whose capture-time bounds
        intersect ``[t_lo, t_hi]`` (inclusive, ns).  Blocks are written in
        time order, so the intersecting set is one contiguous global range:
        the in-memory index locates it and everything outside is seeked
        over, never decoded — a windowed query over a week-long journal
        reads only the window's blocks.  Boundary blocks may carry rows
        outside the window; callers trim rows (the fleet feed does)."""
        limit = self._read_limit()  # flushes the buffer -> index complete
        with self._lock:
            first = last = None
            idx = self._index_first
            for b in self._time_index:
                if b is not None and b[1] >= t_lo and b[0] <= t_hi:
                    if first is None:
                        first = idx
                    last = idx
                idx += 1
        if first is None:
            return
        remaining = last - first + 1
        for cols in self._read_blocks(limit, skip=first):
            if remaining <= 0:
                return
            remaining -= 1
            yield cols

    def iter_chunks(self, num_workers: int) -> Iterator[EventLog]:
        """Stream the store back as :class:`EventLog` blocks, oldest first.

        Flushes the resident buffer first so the on-disk stream is complete;
        memory per step is one block.  Safe against a concurrent writer:
        only blocks fully written at call time are yielded.
        """
        for cols in self._read_blocks(self._read_limit()):
            yield EventLog(*cols, num_workers=num_workers)

    def freeze(self, num_workers: int) -> EventLog:
        """Materialise the whole spilled stream as one log (legacy path;
        resident memory is O(total events) here by definition)."""
        parts = list(self._read_blocks(self._read_limit()))
        if not parts:
            return EventLog(*[np.zeros(0, dt) for dt in _COL_DTYPES],
                            num_workers=num_workers)
        return EventLog(*[np.concatenate(c) for c in zip(*parts)],
                        num_workers=num_workers)

    def __del__(self):  # pragma: no cover - interpreter-shutdown best effort
        try:
            if self._file is not None:
                self._file.close()
        except Exception:
            pass
