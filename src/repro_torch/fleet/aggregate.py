"""Multi-host aggregation — merge per-host event streams into one session.

:class:`FleetSource` implements the session's
:class:`~repro_torch.core.session.EventSource` protocol over N per-host streams
(:class:`HostStream`), so one :class:`~repro_torch.core.session.ProfileSession`
background worker drains and folds a whole fleet: ``snapshot()`` /
``result()`` produce a single :class:`~repro_torch.core.detector.BottleneckReport`
whose workers — and therefore critical slices — carry host provenance
(``report.worker_hosts``).

Normalization happens at the stream edge, once per pushed chunk:

* **worker ids** become fleet-global (``host_offset + local_id``), so the
  fold's per-worker maps, the detector and the exporters see one dense id
  space;
* **timestamps** get the host's clock offset added (declared in the
  handshake or measured by the server — see
  :class:`~repro_torch.fleet.transport.IngestServer`);
* **tag / stack ids** are remapped through the host's registry maps into
  the fleet-wide :class:`~repro_torch.core.tracer.TagRegistry` /
  :class:`~repro_torch.core.tracer.StackRegistry` (identity for raw spill files,
  which carry no registries).

The merge reuses the sharded tracer's tie-break semantics: one stable
``np.lexsort((workers, deltas, times))`` per emitted batch — equal
timestamps order DEACTIVATE first, then by (global) worker id.  Emission is
watermark-gated for boundedness *and* losslessness: a row is emitted only
when its timestamp is strictly below every unfinished host's low watermark
(the last timestamp that host has streamed; per-host streams are
time-ordered), so no later arrival can ever sort before an emitted row.
Consequence (tested): ``FleetSource.from_files([...])`` replayed through a
session is **bit-equal on the numpy backend** to ``detect_offline`` over
the concatenated-and-sorted remapped logs — the wire path is provably
lossless.
"""
from __future__ import annotations

import glob
import json
import os
import threading
from collections import deque
from typing import Iterator

import numpy as np

from repro_torch import device as device_lib
from repro_torch.core.events import EventLog
from repro_torch.core.session import EventSource
from repro_torch.core.spill import SpillStore
from repro_torch.core.tracer import StackRegistry, TagRegistry

_COLS = 5   # times, workers, deltas, tags, stacks


def write_json_atomic(path: str, obj: dict) -> None:
    """Meta sidecars are rewritten in place; neither a crash mid-write
    nor a power loss right after the rename may leave a torn or empty
    JSON (the resume paths trust it), hence the fsync before the replace.
    The tmp name carries the thread id so racing writers (overlapping
    connections of one host) cannot interleave into one tmp file."""
    tmp = f"{path}.{threading.get_ident()}.tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
        f.flush()
        # lint: disable=loop-blocking(the meta sidecar MUST be durable before the journal block that references its registry ids (resume invariant); writes are deduped to real registry growth, so the fsync is amortized over many chunks)
        os.fsync(f.fileno())
    # lint: disable=loop-blocking(atomic-rename publish of the meta sidecar -- same durability invariant as the paired fsync; rare (registry growth only), and partial-write safety requires the rename)
    os.replace(tmp, path)


def load_json(path: str) -> dict | None:
    """Tolerant meta read: a missing, torn or non-object file is simply
    'no meta' — both the server resume and from_fleet_dir must classify
    such files identically or live and offline replay diverge.
    ValueError covers both JSONDecodeError and the UnicodeDecodeError
    a binary-corrupted file raises."""
    try:
        with open(path) as f:
            obj = json.load(f)
        return obj if isinstance(obj, dict) else None
    except (OSError, ValueError):
        return None


def _grow_idmap(arr: np.ndarray | None, idx: int) -> np.ndarray:
    """Ensure ``arr[idx]`` exists (new cells are identity-mapped)."""
    if arr is None:
        arr = np.arange(0, dtype=np.int32)
    if idx >= arr.shape[0]:
        new = np.arange(max(idx + 1, 2 * arr.shape[0] + 1), dtype=np.int32)
        new[:arr.shape[0]] = arr
        arr = new
    return arr


def restore_host_maps(host: "HostStream", tags: TagRegistry,
                      stacks: StackRegistry, tag_entries,
                      stack_entries) -> None:
    """Rebuild a host's registry maps from persisted meta entries (lists
    indexed by host-local id; ``None`` holes are skipped) by interning
    into the fleet registries — the one algorithm behind both the
    server's restart resume and :meth:`FleetSource.from_fleet_dir`."""
    for i, ent in enumerate(tag_entries or []):
        if ent is None:
            continue
        host.tag_map = _grow_idmap(host.tag_map, i)
        host.tag_map[i] = tags.intern(str(ent[0]), str(ent[1]))
    for i, path in enumerate(stack_entries or []):
        if path is None:
            continue
        fleet_path = []
        for t in path:
            host.tag_map = _grow_idmap(host.tag_map, int(t))
            fleet_path.append(int(host.tag_map[int(t)]))
        host.stack_map = _grow_idmap(host.stack_map, i)
        host.stack_map[i] = stacks.intern(tuple(fleet_path))


def _remap_ids(col: np.ndarray, idmap: np.ndarray | None) -> np.ndarray:
    """Map non-negative ids through ``idmap`` (sentinel ids < 0 pass
    through; ids beyond the map keep their value — the caller grows maps
    before referencing new ids)."""
    if idmap is None or idmap.size == 0:
        return col
    out = col.copy()
    valid = (col >= 0) & (col < idmap.shape[0])
    out[valid] = idmap[col[valid]]
    return out


class HostStream:
    """One host's normalized, time-ordered column stream.

    ``push`` applies the worker offset, clock offset and registry remaps,
    then buffers the chunk; the owning :class:`FleetSource` pops merged
    prefixes.  ``feed`` (optional) is a pull-iterator of raw column tuples
    used by the offline file path; live transports push instead.
    """

    def __init__(self, index: int, host_id: str, num_workers: int,
                 worker_offset: int, worker_names: list[str] | None = None,
                 clock_offset_ns: int = 0,
                 feed: Iterator[tuple] | None = None):
        self.index = index
        self.host_id = host_id
        self.num_workers = int(num_workers)
        self.worker_offset = int(worker_offset)
        self.worker_names = list(worker_names) if worker_names else [
            f"w{i}" for i in range(num_workers)]
        self.clock_offset_ns = int(clock_offset_ns)
        self.feed = feed
        # host-local id -> fleet id; None == identity (raw spill files)
        self.tag_map: np.ndarray | None = None
        self.stack_map: np.ndarray | None = None
        self.finished = False
        self.rows_in = 0
        self.chunks_in = 0
        self._parts: deque[tuple] = deque()     # guarded-by: FleetSource.cond
        self._buffered = 0                      # guarded-by: FleetSource.cond
        # low watermark: every future row of this host has time >= this
        # (per-host streams are time-ordered — the tracer store order)
        self.last_seen_ns: int | None = None
        # a host that went silent (no CHUNK before the server's
        # idle_release deadline) is exempted from the merge watermark so
        # it cannot pin every other host's emission; data arriving later
        # re-arms it (and may be clamped+counted, like a late HELLO)
        self.idle_exempt = False

    # -- intake --------------------------------------------------------------
    def push(self, times, workers, deltas, tags, stacks) -> int:  # guarded-by: FleetSource.cond
        """Normalize one raw chunk into the fleet domain and buffer it.
        Returns the number of rows buffered."""
        n = len(times)
        if n == 0:
            return 0
        t = np.asarray(times, np.int64)
        if self.clock_offset_ns:
            t = t + self.clock_offset_ns
        w = np.asarray(workers, np.int32) + self.worker_offset
        g = _remap_ids(np.asarray(tags, np.int32), self.tag_map)
        s = _remap_ids(np.asarray(stacks, np.int32), self.stack_map)
        self._parts.append((t, w, np.asarray(deltas, np.int8), g, s))
        self._buffered += n
        self.rows_in += n
        self.chunks_in += 1
        self.last_seen_ns = int(t[-1])
        self.idle_exempt = False        # data re-arms the watermark
        return n

    def advance_watermark(self, t_ns: int) -> None:  # guarded-by: FleetSource.cond
        """Raise the low watermark WITHOUT data (HEARTBEAT): the producer
        asserts every row it will ever stream after this has capture time
        >= ``t_ns`` (its store order guarantees it — t_ns is the last
        already-streamed row's time).  Normalized like :meth:`push`;
        never moves backwards."""
        t = int(t_ns) + self.clock_offset_ns
        if self.last_seen_ns is None or t > self.last_seen_ns:
            self.last_seen_ns = t

    def shed_oldest(self, max_rows: int) -> tuple[int, int]:  # guarded-by: FleetSource.cond
        """Load shedding: front-evict whole buffered chunks, oldest
        first, until at most ``max_rows`` rows remain buffered.  Returns
        ``(chunks, rows)`` evicted.  The stream stays time-ordered and
        the watermark is untouched, so the merge keeps advancing; only
        callers whose chunks are journaled should shed — the evicted
        prefix then degrades to "replay offline later", never loss."""
        chunks = rows = 0
        while self._parts and self._buffered > max_rows:
            part = self._parts.popleft()
            n = len(part[0])
            self._buffered -= n
            chunks += 1
            rows += n
        return chunks, rows

    def finish(self) -> None:  # guarded-by: FleetSource.cond
        self.finished = True

    def pull(self) -> bool:  # guarded-by: FleetSource.cond
        """File path: pull one raw chunk from ``feed`` into the buffer.
        Returns False (and marks the stream finished) at EOF."""
        if self.feed is None:
            return False
        try:
            cols = next(self.feed)
        except StopIteration:
            self.finished = True
            self.feed = None
            return False
        self.push(*cols)
        return True

    # -- merge side ----------------------------------------------------------
    @property
    def buffered_rows(self) -> int:
        return self._buffered

    def take_below(self, t_ns: int | None) -> list[tuple]:  # guarded-by: FleetSource.cond
        """Pop buffered rows with time strictly below ``t_ns`` (all rows
        when ``t_ns`` is None), preserving stream order."""
        out = []
        while self._parts:
            part = self._parts[0]
            if t_ns is None or part[0][-1] < t_ns:
                out.append(self._parts.popleft())
                self._buffered -= len(part[0])
                continue
            k = int(np.searchsorted(part[0], t_ns, side="left"))
            if k > 0:
                out.append(tuple(c[:k] for c in part))
                self._parts[0] = tuple(c[k:] for c in part)
                self._buffered -= k
            break
        return out


class FleetSource(EventSource):
    """K-way merge of per-host streams, as a pluggable session source.

    Offline — replay spill files copied from the hosts::

        src = FleetSource.from_files(["a.spill", "b.spill", "c.spill"])
        rep = ProfileSession(src, n_min=2.0).result()

    Live — wrap an :class:`~repro_torch.fleet.transport.IngestServer`'s hub (the
    server constructs and feeds one)::

        server = IngestServer()
        server.start()
        with ProfileSession(server.source, n_min=2.0) as sess:
            ...                      # producers stream in
            server.wait_idle()       # all producers said BYE
        rep = sess.result()

    ``chunks()`` yields fleet-domain :class:`EventLog` batches of at most
    ``chunk_events`` rows; the merge is watermark-gated (see module
    docstring) so it is lossless and memory stays bounded by the buffered
    tail of each host.  ``times`` are clamped monotonic across emissions
    (``clock_clamped`` counts repairs).  The watermark only covers hosts
    the merge *knows about*: a host whose HELLO lands after every earlier
    host already finished (all-BYE flush), or after ``request_stop``, can
    deliver events older than the emission frontier — those are clamped
    and counted, not lost.  Register all producers before streaming (the
    acceptance tests do) for a clamp-free, oracle-exact merge.

    ``device`` is the device a session over this source folds on (see
    :class:`~repro_torch.core.session.ProfileSession`): resolved here
    (default: :func:`repro_torch.device.default_device`, CUDA; CUDA
    without a card raises) and carried by every re-opened copy.
    """

    live = False

    def __init__(self, *, tags: TagRegistry | None = None,
                 stacks: StackRegistry | None = None,
                 chunk_events: int = 1 << 16, device=None):
        self.device = device_lib.resolve(device)
        self.tags = tags if tags is not None else TagRegistry()
        self.stacks = stacks if stacks is not None else StackRegistry()
        self.chunk_events = max(int(chunk_events), 1)
        self.hosts: list[HostStream] = []       # guarded-by: self.cond
        self.cond = threading.Condition()
        self.clock_clamped = 0
        # exact load-shedding ledger (incremented by the transport under
        # self.cond): shed chunks were journaled first, so they are
        # recoverable offline — the live report is approximate by exactly
        # this much
        self.shed_chunks = 0                    # guarded-by: self.cond
        self.shed_rows = 0                      # guarded-by: self.cond
        self._t_emitted: int | None = None
        self._stop = False                      # guarded-by: self.cond
        # a live transport (IngestServer) sets this while it can still
        # accept producers: the chunk stream then stays open even when
        # every current host finished (file mode leaves it False, so the
        # stream ends when the last file is drained)
        self.accepting = False
        # from_files/from_fleet_dir/from_producer_journals record their
        # inputs here so full_log() can re-open the files instead of
        # consuming the live feeds
        self._file_recipe: dict | None = None
        self._dir_recipe: dict | None = None
        self._producer_recipe: dict | None = None

    # -- host management -----------------------------------------------------
    def add_host(self, host_id: str, num_workers: int,
                 worker_names: list[str] | None = None,
                 clock_offset_ns: int = 0,
                 feed: Iterator[tuple] | None = None) -> HostStream:
        with self.cond:
            h = HostStream(len(self.hosts), host_id, num_workers,
                           self.num_workers, worker_names, clock_offset_ns,
                           feed)
            self.hosts.append(h)
            self.cond.notify_all()
        return h

    def try_grow_host(self, stream: HostStream, num_workers: int,
                      worker_names: list[str] | None = None) -> bool:
        """Grow a host's worker-id space (workers registered after its
        first handshake).  Only legal while the host owns the *tail* of
        the fleet id range — growing an interior host would collide with
        the next host's offsets.  Returns False when rejected."""
        with self.cond:
            if num_workers <= stream.num_workers:
                return True
            if (stream.worker_offset + stream.num_workers
                    != self.num_workers):
                return False
            old = stream.num_workers
            stream.num_workers = int(num_workers)
            if worker_names and len(worker_names) >= num_workers:
                stream.worker_names = list(worker_names[:num_workers])
            else:
                stream.worker_names += [
                    f"w{i}" for i in range(old, num_workers)]
            self.cond.notify_all()
        return True

    @property
    def num_workers(self) -> int:
        return sum(h.num_workers for h in self.hosts)

    @property
    def num_hosts(self) -> int:
        return len(self.hosts)

    def worker_names(self) -> list[str]:
        return [f"{h.host_id}/{n}" for h in self.hosts
                for n in h.worker_names]

    def worker_hosts(self) -> list[str]:
        return [h.host_id for h in self.hosts for _ in range(h.num_workers)]

    def stats(self) -> dict:
        return {
            "hosts": len(self.hosts),
            "rows_in": sum(h.rows_in for h in self.hosts),
            "chunks_in": sum(h.chunks_in for h in self.hosts),
            "buffered_rows": sum(h.buffered_rows for h in self.hosts),
            "clock_clamped": self.clock_clamped,
            "shed_chunks": self.shed_chunks,
            "shed_rows": self.shed_rows,
            "idle_hosts": sum(1 for h in self.hosts if h.idle_exempt),
            "accepting": self.accepting,
        }

    # -- lifecycle hooks the session drives ----------------------------------
    def request_stop(self) -> None:
        """Finalize: flush everything buffered and end the chunk stream
        (the session calls this from ``stop()``/``close()``)."""
        with self.cond:
            self._stop = True
            self.cond.notify_all()

    def notify(self) -> None:
        with self.cond:
            self.cond.notify_all()

    # -- construction helpers ------------------------------------------------
    @classmethod
    def from_files(cls, paths: list[str], *,
                   host_names: list[str] | None = None,
                   num_workers: list[int] | None = None,
                   tags: TagRegistry | None = None,
                   stacks: StackRegistry | None = None,
                   clock_offsets_ns: list[int] | None = None,
                   chunk_events: int = 1 << 16,
                   device=None) -> "FleetSource":
        """Offline ingest: one spill file per host (copied off the hosts),
        k-way merged exactly like the live path.  ``num_workers`` per host
        is pre-scanned from the file when not given (one extra pass)."""
        src = cls(tags=tags, stacks=stacks, chunk_events=chunk_events,
                  device=device)
        resolved_nw = []
        for i, path in enumerate(paths):
            store = SpillStore.open_readonly(path, chunk_events)
            nw = (num_workers[i] if num_workers is not None
                  else _scan_num_workers(store))
            resolved_nw.append(nw)
            name = (host_names[i] if host_names is not None
                    else _default_host_name(path, i))
            off = (clock_offsets_ns[i] if clock_offsets_ns is not None
                   else 0)
            src.add_host(name, nw, clock_offset_ns=off,
                         feed=_file_feed(store, nw))
        src._file_recipe = {
            "paths": list(paths),
            "host_names": [h.host_id for h in src.hosts],
            "num_workers": resolved_nw,
            "clock_offsets_ns": [h.clock_offset_ns for h in src.hosts],
            "chunk_events": chunk_events,
        }
        return src

    @classmethod
    def from_fleet_dir(cls, fleet_dir: str, *,
                       tags: TagRegistry | None = None,
                       stacks: StackRegistry | None = None,
                       chunk_events: int = 1 << 16,
                       window_ns: tuple[int, int] | None = None,
                       device=None) -> "FleetSource":
        """Re-open an :class:`~repro_torch.fleet.transport.IngestServer`'s
        durable per-host stores (``IngestServer(fleet_dir=...)``): one
        journal + meta sidecar per host.  The meta carries everything the
        raw spill blocks don't — host identity and order, worker table,
        clock offset, and the host-local tag/stack registry entries — so
        the replayed merge resolves names and normalizes exactly like the
        live ingest did: the merged log is the union of everything the
        server accepted.

        ``window_ns=(lo, hi)`` (inclusive, fleet time) restricts the
        replay to that capture-time window: each journal's block index
        seeks directly to the intersecting blocks — a windowed query over
        a long-running fleet_dir never re-reads the full history."""
        metas = []
        for mp in sorted(glob.glob(os.path.join(str(fleet_dir),
                                                "*.meta.json"))):
            m = load_json(mp)
            if m and m.get("journal"):
                m["_journal_path"] = os.path.join(os.path.dirname(mp),
                                                  m["journal"])
                metas.append(m)
        metas.sort(key=lambda m: int(m.get("host_index", 0)))
        src = cls(tags=tags, stacks=stacks, chunk_events=chunk_events,
                  device=device)
        for m in metas:
            if not journal_on_disk(m["_journal_path"]):
                # a silent skip would drop the host's every row and void
                # the merged-journals == live-report equality unnoticed
                raise FileNotFoundError(
                    f"fleet_dir meta for host {m.get('host_id')!r} "
                    f"references missing journal {m['_journal_path']!r}")
            store = SpillStore.open_readonly(m["_journal_path"],
                                             chunk_events)
            nw = int(m.get("num_workers", 0))
            off = int(m.get("clock_offset_ns", 0))
            h = src.add_host(str(m.get("host_id", "host")), nw,
                             m.get("worker_names"),
                             clock_offset_ns=off,
                             feed=_file_feed(store, nw, window_ns, off))
            restore_host_maps(h, src.tags, src.stacks, m.get("tags"),
                              m.get("stacks"))
        src._dir_recipe = {"fleet_dir": str(fleet_dir),
                           "chunk_events": chunk_events,
                           "window_ns": window_ns}
        return src

    @classmethod
    def from_producer_journals(cls, paths: list[str], *,
                               tags: TagRegistry | None = None,
                               stacks: StackRegistry | None = None,
                               clock_offsets_ns: list[int] | None = None,
                               chunk_events: int = 1 << 16,
                               device=None) -> "FleetSource":
        """Offline ingest over PRODUCER-side durable journals
        (``RemoteSink(journal=...)``) — the union of everything each
        producer ever captured, independent of what any server received.
        Each path's ``.meta.json`` sidecar supplies the host identity,
        worker table and registry entries (the same resume state a sink
        restart reads).  Hosts are ordered as given: pass the paths in
        the server's ``host_index`` order to reproduce the live fleet's
        worker-id layout, making this the ground-truth oracle the chaos
        harness compares recovered merges against."""
        src = cls(tags=tags, stacks=stacks, chunk_events=chunk_events,
                  device=device)
        for i, path in enumerate(paths):
            meta = load_json(str(path) + ".meta.json") or {}
            store = SpillStore.open_readonly(path, chunk_events)
            nw = int(meta.get("num_workers") or 0) \
                or _scan_num_workers(store)
            off = (clock_offsets_ns[i] if clock_offsets_ns is not None
                   else int(meta.get("clock_offset_ns") or 0))
            h = src.add_host(
                str(meta.get("host_id") or _default_host_name(path, i)),
                nw, meta.get("worker_names"), clock_offset_ns=off,
                feed=_file_feed(store, nw))
            restore_host_maps(h, src.tags, src.stacks, meta.get("tags"),
                              meta.get("stacks"))
        src._producer_recipe = {
            "paths": [str(p) for p in paths],
            "clock_offsets_ns": (None if clock_offsets_ns is None
                                 else list(clock_offsets_ns)),
            "chunk_events": chunk_events,
        }
        return src

    def full_log(self) -> EventLog:
        """Materialize the merged fleet log.  File-backed sources re-open
        their files (repeatable, like LogSource/SpillSource — the session's
        feeds are untouched); a live ingest stream has no rewind."""
        if self._file_recipe is not None:
            fresh = FleetSource.from_files(**self._file_recipe,
                                           device=self.device)
        elif self._dir_recipe is not None:
            # share the registries: intern is name-keyed, so the re-read
            # produces identical fleet tag/stack ids
            fresh = FleetSource.from_fleet_dir(
                **self._dir_recipe, tags=self.tags, stacks=self.stacks,
                device=self.device)
        elif self._producer_recipe is not None:
            fresh = FleetSource.from_producer_journals(
                **self._producer_recipe, tags=self.tags, stacks=self.stacks,
                device=self.device)
        else:
            raise RuntimeError("full_log(): live ingest streams have no "
                               "rewind (only FleetSource.from_files / "
                               "from_fleet_dir sources can re-materialize)")
        parts = list(fresh.chunks())
        if not parts:
            from repro_torch.fleet.wire import COL_DTYPES
            return EventLog(*[np.zeros(0, dt) for dt in COL_DTYPES],
                            num_workers=self.num_workers)
        cols = zip(*[(p.times, p.workers, p.deltas, p.tags, p.stacks)
                     for p in parts])
        return EventLog(*[np.concatenate(list(c)) for c in cols],
                        num_workers=self.num_workers)

    # -- the merge -----------------------------------------------------------
    def chunks(self) -> Iterator[EventLog]:
        while True:
            with self.cond:
                batch, done = self._gather_locked()
            if batch is not None:
                yield from self._emit(batch)
            if done:
                return
            if batch is None:
                with self.cond:
                    if not self._stop and not self._progress_possible():
                        self.cond.wait(0.05)

    def _progress_possible(self) -> bool:  # guarded-by: self.cond
        """Under the lock: can the next gather round move without waiting
        for a live push?  (Any unfinished file host can always pull.)"""
        return any(h.feed is not None and not h.finished
                   for h in self.hosts)

    def _gather_locked(self) -> tuple[list[tuple] | None, bool]:  # guarded-by: self.cond
        """One merge round under the lock.  Returns ``(parts, done)``:
        ``parts`` is the host-ordered list of safe column tuples (None when
        nothing could be emitted), ``done`` means the stream is over."""
        while True:
            # file-backed hosts refill so every unfinished host constrains
            # the watermark with real data
            for h in self.hosts:
                while (h.feed is not None and not h.finished
                       and h.buffered_rows == 0):
                    if not h.pull():
                        break
            unfinished = [h for h in self.hosts if not h.finished]
            all_done = bool(self.hosts) and not unfinished
            if self._stop or (all_done and not self.accepting):
                # finalize: file feeds are finite — read them to the end
                # (losslessness); live hosts contribute what they buffered
                for h in self.hosts:
                    while h.feed is not None and not h.finished:
                        h.pull()
                parts = [p for h in self.hosts for p in h.take_below(None)]
                return (parts or None), True
            if all_done:
                # every current host said BYE but the transport may still
                # accept more: emit everything, keep the stream open
                parts = [p for h in self.hosts for p in h.take_below(None)]
                return (parts or None), False
            # idle-exempt hosts (silent past the server's idle_release
            # deadline) do not gate the watermark: a producer that
            # handshook and then died must not pin every healthy host's
            # emission.  If they wake up late, their rows clamp like any
            # late-HELLO host's.
            gating = [h for h in unfinished if not h.idle_exempt]
            if not gating:
                # every live host is idle: flush what is buffered (idle
                # hosts buffer nothing new by definition), keep streaming
                parts = [p for h in self.hosts for p in h.take_below(None)]
                return (parts or None), False
            if not self.hosts or any(h.last_seen_ns is None
                                     for h in gating):
                return None, False  # a host has not produced yet: no floor
            watermark = min(h.last_seen_ns for h in gating)
            parts = [p for h in self.hosts for p in h.take_below(watermark)]
            if parts:
                return parts, False
            # all buffered rows sit at/over the watermark: advance the file
            # host(s) pinning it (a live host advances by pushing)
            advanced = False
            for h in unfinished:
                if h.feed is not None and h.last_seen_ns <= watermark:
                    advanced |= h.pull()
            if not advanced and not any(h.finished for h in unfinished):
                return None, False

    def _emit(self, parts: list[tuple]) -> Iterator[EventLog]:
        """Merge-sort gathered parts and yield chunk_events-bounded logs."""
        cols = [np.concatenate([p[i] for p in parts]) for i in range(_COLS)]
        times, workers, deltas = cols[0], cols[1], cols[2]
        if len(parts) > 1 or np.any(np.diff(times) < 0):
            # shard-merge tie-break semantics: DEACTIVATE first, then
            # worker id; stable, so within-host stream order is preserved
            order = np.lexsort((workers, deltas, times))
            cols = [c[order] for c in cols]
            times = cols[0]
        if self._t_emitted is not None and times[0] < self._t_emitted:
            clamped = times < self._t_emitted
            self.clock_clamped += int(clamped.sum())
            cols[0] = times = np.maximum(times, self._t_emitted)
        self._t_emitted = int(times[-1])
        nw = self.num_workers
        ce = self.chunk_events
        for lo in range(0, len(times), ce):
            yield EventLog(*[c[lo:lo + ce] for c in cols], num_workers=nw)


# ---------------------------------------------------------------------------
# file-feed helpers
# ---------------------------------------------------------------------------

def _file_feed(store: SpillStore, num_workers: int,
               window_ns: tuple[int, int] | None = None,
               clock_offset_ns: int = 0) -> Iterator[tuple]:
    """Replay a spill file as host-local column tuples.  ``window_ns``
    (inclusive, FLEET time — i.e. post clock-offset) restricts the replay
    to events in ``[lo, hi]``: the store's capture-time block index seeks
    straight to the intersecting blocks (nothing outside the window is
    decoded) and boundary blocks are row-trimmed here, in host-local time
    (``HostStream.push`` re-applies the offset on the way in)."""
    if window_ns is None:
        for log in store.iter_chunks(num_workers):
            yield (log.times, log.workers, log.deltas, log.tags, log.stacks)
        return
    lo = int(window_ns[0]) - int(clock_offset_ns)
    hi = int(window_ns[1]) - int(clock_offset_ns)
    for cols in store.iter_block_columns_window(lo, hi):
        t = cols[0]
        a = int(np.searchsorted(t, lo, "left"))
        b = int(np.searchsorted(t, hi, "right"))
        if a < b:
            yield tuple(c[a:b] for c in cols)


def journal_on_disk(path: str) -> bool:
    """True when a journal left anything on disk: its base (active) file
    or any sealed rotation segment — full rotation can retire the base
    file entirely, leaving only ``<path>.g*.seg`` history."""
    return bool(os.path.exists(str(path))
                or glob.glob(glob.escape(str(path)) + ".g*.seg"))


def fleet_dir_time_span(fleet_dir: str) -> tuple[int, int] | None:
    """Capture-time span ``(t_min, t_max)`` of a fleet_dir in FLEET time
    (each host's journal bounds shifted by its recorded clock offset), or
    ``None`` when no journal holds events.  O(blocks) header seeks per
    journal — the anchor a serving layer needs to resolve "last N seconds"
    into an absolute window without reading any payload."""
    lo = hi = None
    for mp in sorted(glob.glob(os.path.join(str(fleet_dir),
                                            "*.meta.json"))):
        m = load_json(mp)
        if not m or not m.get("journal"):
            continue
        jp = os.path.join(os.path.dirname(mp), m["journal"])
        if not journal_on_disk(jp):
            continue
        b = SpillStore.open_readonly(jp).time_bounds()
        if b is None:
            continue
        off = int(m.get("clock_offset_ns", 0))
        lo = b[0] + off if lo is None else min(lo, b[0] + off)
        hi = b[1] + off if hi is None else max(hi, b[1] + off)
    return None if lo is None else (lo, hi)


def _scan_num_workers(store: SpillStore) -> int:
    """Worker count of a raw spill file (no header carries it): one pass
    over the blocks' worker column."""
    top = -1
    for cols in store._read_blocks(store._read_limit()):
        if cols[1].size:
            top = max(top, int(cols[1].max()))
    return top + 1


def _default_host_name(path: str, index: int) -> str:
    base = os.path.basename(str(path))
    stem = base.rsplit(".", 1)[0] if "." in base else base
    return stem or f"host{index}"
