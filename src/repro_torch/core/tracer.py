"""Runtime tracer — the software analogue of GAPP's kernel probes.

The probe path is **sharded and lock-free**: every worker owns a private
capture shard (:class:`~repro_torch.core.events.EventShard`) and ``begin``/``end``
append ``(timestamp, meta)`` to it with no cross-worker lock, no numpy row
stores, no dict updates and no stack interning — the per-event cost is a
clock read plus two deque appends.  This mirrors the paper's design rule
that the in-kernel probe body must be O(1) and tiny (§3, Table 2): the seed
implementation serialized every event of every worker through one global
``threading.Lock`` plus Python-dict eBPF-map updates, which made the
profiler itself the serialization bottleneck it is meant to detect (that
probe body is retained below as :class:`LockedTracer`, the measured
baseline and semantic oracle).

The expensive part — maintaining the paper's Table-1 eBPF-map state — is
deferred and batched: a flush drains all shards
(:meth:`~repro_torch.core.events.ShardedEventRing.drain` k-way-merges them by
timestamp), applies the §3.2 tolerance rules vectorised
(:func:`~repro_torch.core.events.tolerance_keep`), and replays the batch through
the carry-resumable vectorised fold
(:func:`~repro_torch.core.cmetric.fold_chunk`), whose
:class:`~repro_torch.core.cmetric.FoldCarry` is exactly the Table-1 state:

    global_cm     running Σ T_i / n_i                      (global scalar)
    local_cm[w]   global_cm snapshot at switch-in          (per-worker)
    thread_count  number of active workers                 (global scalar)
    total_count   number of registered workers             (global scalar)
    cm_hash[w]    cumulative CMetric per worker            (global hash)
    t_switch      timestamp of the previous event          (local scalar)

Flushes run at sync points (``freeze``/``per_worker_cm``/``report``/…)
and opportunistically when a shard fills (``autoflush``); with the
``numpy`` fold backend the online state is *bit-identical* to
``compute_numpy`` over the frozen log.

Call paths are captured as immutable cons chains (``(tag_id, parent)``)
so ``end`` records the whole stack by reference in O(1); they are
unwound and interned **only** when the finished timeslice is critical
(``threads_av < n_min``) — the paper's §4.2 "stacks only for critical
slices" rule, now enforced end-to-end (non-critical ends allocate no
stack ids at all).

Workers are *logical*: host threads, DP hosts, pipeline stages, MoE
experts.  ``register_worker`` mirrors the paper's ``task_newtask`` probe.
Each worker's handle must be driven by one thread at a time (the shard is
single-writer); distinct workers never contend.
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys
import threading
import time
from typing import Iterator

import numpy as np

from repro_torch import device as device_lib
from repro_torch.core import backends as backends_lib
from repro_torch.core.events import (ACTIVATE, DEACTIVATE, NO_STACK, NO_TAG,
                               EventLog, EventRing, EventStore,
                               ShardedEventRing, tolerance_keep)
from repro_torch.core.slices import CriticalBuffer, CriticalSlice  # noqa: F401 (re-export)


@dataclasses.dataclass
class WorkerInfo:
    wid: int
    name: str
    kind: str            # "host" | "thread" | "stage" | "expert" | "device"


class TagRegistry:
    """tag string -> dense id, with code location (the addr2line analogue)."""

    def __init__(self):
        self._ids: dict[str, int] = {}      # guarded-by: self._lock
        self.names: list[str] = []          # guarded-by: self._lock
        self.locations: list[str] = []      # guarded-by: self._lock
        self._lock = threading.Lock()

    def intern(self, tag: str, location: str | None = None) -> int:
        tid = self._ids.get(tag)
        if tid is not None:
            return tid
        with self._lock:
            tid = self._ids.get(tag)
            if tid is None:
                tid = len(self.names)
                self.names.append(tag)
                self.locations.append(location or "<unknown>")
                self._ids[tag] = tid   # publish last: readers skip the lock
        return tid

    def __len__(self) -> int:
        return len(self.names)


class StackRegistry:
    """Interned call paths (tuples of tag ids), truncated to top-M frames."""

    def __init__(self, top_m: int = 8):
        self.top_m = top_m
        self._ids: dict[tuple, int] = {}    # guarded-by: self._lock
        self.paths: list[tuple] = []        # guarded-by: self._lock
        self._lock = threading.Lock()

    def intern(self, stack: tuple) -> int:
        stack = stack[-self.top_m:]
        sid = self._ids.get(stack)
        if sid is not None:
            return sid
        with self._lock:
            sid = self._ids.get(stack)
            if sid is None:
                sid = len(self.paths)
                self.paths.append(stack)
                self._ids[stack] = sid
        return sid

    def intern_cons(self, cons) -> int:
        """Intern a captured cons-chain stack (head = top of stack)."""
        items = []
        while cons is not None:
            items.append(cons[0])
            cons = cons[1]
        items.reverse()                    # caller -> callee, like the seed
        return self.intern(tuple(items))

    def __len__(self) -> int:
        return len(self.paths)


class WorkerHandle:
    """One worker's lock-free probe endpoint.

    ``begin``/``end`` are closures bound to the worker's shard (built in
    :meth:`Tracer.register_worker`); calling them through the handle is the
    hot path — :meth:`Tracer.begin`/:meth:`Tracer.end` are thin compat
    wrappers.  ``stack`` is the live tag stack as an immutable cons chain
    ``(tag_id, parent)`` (``None`` when empty), so the sampler can read the
    top frame and ``end`` can capture the whole path by reference without
    copying.  Single-writer: one thread drives a handle at a time.
    """

    __slots__ = ("wid", "name", "kind", "shard", "stack", "begin", "end")

    def __init__(self, wid: int, name: str, kind: str, shard):
        self.wid = wid
        self.name = name
        self.kind = kind
        self.shard = shard
        self.stack = None

    @contextlib.contextmanager
    def span(self, tag: str) -> Iterator[None]:
        self.begin(tag)
        try:
            yield
        finally:
            self.end()


class Tracer:
    """Sharded low-overhead span tracer with batched online CMetric.

    ``capacity`` is per worker shard.  ``fold_backend`` selects the
    registered chunk fold that maintains the online state (``"numpy"`` is
    the bit-exact float64 default).  ``device`` is where a device fold
    backend runs: resolved once here (default:
    :func:`repro_torch.device.default_device`; CUDA without a card raises)
    and held for every drain, whichever thread runs it — a producer's
    autoflush or a session's worker.  A host fold backend (``numpy``)
    resolves no device unless given one.  ``autoflush=False`` disables the
    opportunistic flush when a shard fills, so a full shard drops new
    events (counted) like a BPF ring buffer.

    ``store`` is where drained+folded chunks accumulate — anything with the
    :class:`~repro_torch.core.events.EventStore` interface; pass a
    :class:`~repro_torch.core.spill.SpillStore` to page the stream to disk and
    bound resident memory.  ``on_drain`` hooks (``fn(folded_events)``,
    called under the fold lock after each non-empty flush) let a
    :class:`~repro_torch.core.session.ProfileSession`'s background worker track
    drain progress without polling the store.
    """

    def __init__(self, n_min: float | None = None, top_m: int = 8,
                 capacity: int = 1 << 16, clock=time.perf_counter_ns,
                 fold_backend: str = "numpy", autoflush: bool = True,
                 store=None, max_rows_per_sync: int | None = None,
                 device=None):
        self.n_min = n_min              # None => total_count/2, resolved lazily
        self.clock = clock
        self.fold_backend = fold_backend
        from repro_torch.core.cmetric import FoldCarry  # deferred: import cycle
        on_device = "device" in backends_lib.get_backend(
            fold_backend).capabilities
        self.device = (device_lib.resolve(device)
                       if on_device or device is not None else None)
        self.autoflush = autoflush
        # per-shard decode budget of one flush: caps the Python decode loop
        # a single sync (and therefore a mid-capture snapshot) can run, so a
        # multi-MHz producer can't starve readers.  None == drain fully.
        self.max_rows_per_sync = max_rows_per_sync
        self.tags = TagRegistry()
        self.stacks = StackRegistry(top_m)
        self.ring = ShardedEventRing(capacity)
        self.workers: list[WorkerInfo] = []       # guarded-by: self._reg_lock
        self._handles: list[WorkerHandle] = []    # guarded-by: self._reg_lock
        # Table-1 eBPF-map state lives in the fold carry; it advances only
        # at flush time, by replaying drained batches through fold_chunk.
        self._carry = FoldCarry.init(0)           # guarded-by: self._fold_lock
        self._store = store if store is not None else EventStore()
        # extra chunk consumers (e.g. a fleet RemoteSink): every
        # drained+folded chunk is forwarded right after it lands in the
        # store, same columns, same order
        self.sinks: list = []
        self._critical = CriticalBuffer()
        self._total_slices = 0                    # guarded-by: self._fold_lock
        self.on_drain: list = []    # fn(folded_events), under the fold lock
        # events removed by the §3.2 tolerance filter at flush time (e.g.
        # the orphaned end of a span whose begin was ring-dropped): the full
        # accounting is appended == len(freeze()) + ring.dropped + this
        self.tolerance_dropped = 0                # guarded-by: self._fold_lock
        self._fold_lock = threading.Lock()     # flush/drain consumer lock
        # reader-priority hint: while a snapshot() waits on the fold lock,
        # the drain loop and the producers' opportunistic autoflushes back
        # off so the reader is next in line (a plain bool — races only
        # delay the hint by one flush)
        self._reader_waiting = False
        self._reg_lock = threading.Lock()
        self.enabled = True

    # -- task_newtask analogue ----------------------------------------------
    def register_worker(self, name: str, kind: str = "thread") -> int:
        with self._reg_lock:
            wid = len(self.workers)
            shard = self.ring.add_shard()
            h = WorkerHandle(wid, name, kind, shard)
            h.begin, h.end = self._make_hot_path(h, shard)
            self.workers.append(WorkerInfo(wid, name, kind))
            self._handles.append(h)
        return wid

    def handle(self, wid: int) -> WorkerHandle:
        """The worker's lock-free probe endpoint (the actual hot path)."""
        return self._handles[wid]

    def _make_hot_path(self, h: WorkerHandle, shard):
        """Build the two per-event closures.  Everything they touch is a
        local cell: the tag dict, the clock, the shard deques.  No locks,
        no numpy, no interning — decode happens at drain time."""
        ids = self.tags._ids
        clock = self.clock
        ta = shard.times.append
        ma = shard.metas.append
        md = shard.metas
        cap = shard.capacity
        dlen = len
        slow = self._append_slow
        intern_cold = self._intern_at_callsite

        def begin(tag, location=None):
            try:
                tid = ids[tag]
            except KeyError:
                tid = intern_cold(tag, location)
            h.stack = (tid, h.stack)
            if dlen(md) >= cap and not slow(shard):
                return tid
            ta(clock())
            ma(tid)  # publishes: ta -- int meta == ACTIVATE
            return tid

        def end():
            s = h.stack                   # captured path, by reference
            if s is not None:
                h.stack = s[1]
            if dlen(md) >= cap and not slow(shard):
                return
            ta(clock())
            ma(s)  # publishes: ta -- cons/None meta == DEACTIVATE

        return begin, end

    def _intern_at_callsite(self, tag: str, location: str | None) -> int:
        """Cold path of tag interning: runs once per distinct tag, so it can
        afford the frame walk the seed paid on every single begin()."""
        if location is None:
            f = sys._getframe(2)
            # walk out of profiler-internal frames (tracer, session/Gapp
            # facades, contextlib's @contextmanager machinery) to the user
            # call site
            while f is not None and (
                    (f.f_globals.get("__name__") or "").startswith("repro_torch.core")
                    or f.f_globals.get("__name__") == "contextlib"):
                f = f.f_back
            if f is not None:
                location = f"{f.f_globals.get('__name__', '?')}:{f.f_lineno}"
        return self.tags.intern(tag, location)

    def _append_slow(self, shard) -> bool:
        """A shard hit capacity: try a non-blocking flush, then either admit
        the event or drop it (counted, BPF ringbuf semantics)."""
        if (self.autoflush and not self._reader_waiting
                and self._fold_lock.acquire(False)):
            try:
                # respect the decode budget: freeing one budget's worth of
                # rows is enough to admit the event without a long stall
                # lint: disable=guarded-by(fold lock IS held here — taken via the non-blocking acquire(False) two lines up, which the lexical pass cannot see)
                self._flush_locked(self.max_rows_per_sync)
            finally:
                self._fold_lock.release()
        if len(shard.metas) >= shard.capacity:
            shard.dropped += 1
            return False
        return True

    @property
    def total_count(self) -> int:
        return len(self.workers)

    def _resolved_n_min(self) -> float:
        return self.n_min if self.n_min is not None else self.total_count / 2

    # -- batched probe analysis (the deferred Table-1 state machine) ---------
    def sync(self) -> None:
        """Drain all shards and replay the batch through the vectorised
        chunk fold, advancing the online CMetric/critical-slice state.

        Always complete: with a ``max_rows_per_sync`` budget the backlog
        present at entry is consumed in budget-sized flushes (bounded even
        under a live producer — rows appended *during* the sync stay
        pending, exactly like the unbudgeted single-pass drain)."""
        with self._fold_lock:
            if self.max_rows_per_sync is None:
                self._flush_locked()
                return
            remaining = self.ring.pending()
            while remaining > 0:
                done = self._flush_locked(self.max_rows_per_sync)
                if done == 0:
                    break
                remaining -= done

    def sync_budgeted(self) -> int:
        """One budget-capped flush (the session drain loop's step): decodes
        at most ``max_rows_per_sync`` rows per shard, so a mid-capture
        ``snapshot()`` waiting on the fold lock is never stuck behind an
        unbounded decode.  Returns the rows still pending after it."""
        with self._fold_lock:
            self._flush_locked(self.max_rows_per_sync)
        return self.ring.pending()

    def _flush_locked(self, limit: int | None = None) -> int:  # guarded-by: self._fold_lock
        chunk = self.ring.drain(limit)
        # total_count *after* the drain: a worker that registered while we
        # drained may already have events in the chunk, and every map below
        # must cover its id
        w_count = self.total_count
        carry = self._carry
        carry.ensure_workers(w_count)
        if chunk is None:
            return 0
        drained = len(chunk)
        times = chunk.times
        workers = chunk.workers
        deltas = chunk.deltas
        tags = chunk.tags
        aux = chunk.aux
        # Cross-flush monotonic repair: a producer preempted between its
        # clock read and its publish can surface an event older than the
        # already-folded watermark; clamping keeps the accumulated log
        # time-sorted (the error is bounded by the preemption window).
        if carry.t_last_ns is not None and times[0] < carry.t_last_ns:
            times = np.maximum(times, carry.t_last_ns)
        # §3.2 tolerance, applied vectorised against the carry's open mask —
        # the fold updates it identically after consuming the clean chunk,
        # so the Table-1 carry is the single source of the per-worker state
        keep, _ = tolerance_keep(workers, deltas, carry.open)
        if not keep.all():
            self.tolerance_dropped += int(keep.size - keep.sum())
            times, workers, deltas, tags, aux = (
                times[keep], workers[keep], deltas[keep], tags[keep],
                aux[keep])
        if times.shape[0] == 0:
            return drained
        stacks_col = np.full(times.shape[0], NO_STACK, np.int32)
        clog = EventLog(times, workers, deltas, tags, stacks_col, w_count)
        with device_lib.use_device(self.device):
            self._carry, table = backends_lib.fold_chunk(
                carry, clog, backend=self.fold_backend)
        # §4.2: intern call paths for critical timeslices only
        crit_mask = table.threads_av < self._resolved_n_min()
        if crit_mask.any():
            deact_pos = np.flatnonzero(deltas == DEACTIVATE)
            aux_out = aux[deact_pos]
            intern_cons = self.stacks.intern_cons
            for r in np.flatnonzero(crit_mask):
                sid = intern_cons(aux_out[r])
                table.stack_id[r] = sid
                stacks_col[deact_pos[r]] = sid
            self._critical.extend_table(table, crit_mask)
        self._store.append_columns(times, workers, deltas, tags, stacks_col)
        for sink in self.sinks:
            sink.append_columns(times, workers, deltas, tags, stacks_col)
        self._total_slices += len(table)
        for hook in self.on_drain:
            hook(times.shape[0])
        return drained

    # -- public span API (compat wrappers over the handle hot path) ----------
    def begin(self, wid: int, tag: str, location: str | None = None) -> int:
        if not self.enabled:
            return NO_TAG
        return self._handles[wid].begin(tag, location)

    def end(self, wid: int) -> None:
        if not self.enabled:
            return
        self._handles[wid].end()

    @contextlib.contextmanager
    def span(self, wid: int, tag: str) -> Iterator[None]:
        h = self._handles[wid]
        h.begin(tag)
        try:
            yield
        finally:
            h.end()

    # Tag refinement inside an active span: adds call-path context without a
    # scheduling event (the worker stays active).
    def push(self, wid: int, tag: str) -> None:
        h = self._handles[wid]
        h.stack = (self.tags.intern(tag), h.stack)

    def pop(self, wid: int) -> None:
        h = self._handles[wid]
        s = h.stack
        if s is not None:
            h.stack = s[1]

    @contextlib.contextmanager
    def frame(self, wid: int, tag: str) -> Iterator[None]:
        self.push(wid, tag)
        try:
            yield
        finally:
            self.pop(wid)

    # -- sampling-probe reads (lock-free; see sampler.py) --------------------
    @property
    def thread_count(self) -> int:
        """Instantaneous active-worker count, read off the shards."""
        return sum(h.shard.is_open for h in self._handles)

    def active_tags(self) -> list[tuple[int, int]]:
        """(wid, top-of-stack tag) of each active worker — the 'instruction
        pointer' read.  Lock-free: cons stacks are immutable snapshots."""
        out = []
        for h in self._handles:
            s = h.stack
            if s is not None and h.shard.is_open:
                out.append((h.wid, s[0]))
        return out

    # -- ingestion of external (synthetic / device-side) event streams -------
    def ingest(self, t: int, wid: int, delta: int, tag: str = "",
               stack: tuple[str, ...] = ()) -> None:
        """Feed a pre-timestamped event (simulated fleet trace, device timing
        stream) into the worker's shard; it flows through the same drain +
        sanitize + fold pipeline as live spans.  Not a hot path."""
        h = self._handles[wid]
        sh = h.shard
        # the tag stack must mirror the caller's span structure even when
        # the ring is full — like the hot-path closures, apply the push/pop
        # unconditionally and drop only the event
        has_room = (len(sh.metas) < sh.capacity or self._append_slow(sh))
        if delta == ACTIVATE:
            tid = self.tags.intern(tag) if tag else NO_TAG
            h.stack = (tid, h.stack)
            if has_room:
                sh.times.append(int(t))
                sh.metas.append(tid)   # publishes: sh.times
        else:
            if stack:
                cons = None
                for s_ in stack:          # caller->callee in, head=callee out
                    cons = (self.tags.intern(s_), cons)
            else:
                cons = h.stack
            if has_room:
                sh.times.append(int(t))
                sh.metas.append(cons)  # publishes: sh.times
            s = h.stack
            if s is not None:
                h.stack = s[1]

    # -- results --------------------------------------------------------------
    def snapshot(self, budgeted: bool = False) -> dict:
        """One consistent view of the online state under a single sync —
        what the detector consumes (per-property access would re-sync and
        could interleave fresh mini-batches between reads).

        ``budgeted=True`` caps the flush at ``max_rows_per_sync`` rows per
        shard: the snapshot may then lag the capture by the undecoded
        backlog (incremental semantics), but its latency is bounded no
        matter how fast producers append."""
        self._reader_waiting = True
        try:
            with self._fold_lock:
                self._reader_waiting = False
                return self._snapshot_locked(budgeted)
        finally:
            self._reader_waiting = False

    def _snapshot_locked(self, budgeted: bool) -> dict:  # guarded-by: self._fold_lock
        self._flush_locked(self.max_rows_per_sync if budgeted else None)
        carry = self._carry
        return {
            "critical": self._critical.table(),
            "per_worker": carry.per_worker_padded(self.total_count),
            "total_slices": self._total_slices,
            "idle_time": carry.idle,
            "total_time": carry.total_time,
        }

    @property
    def critical(self) -> CriticalBuffer:
        """Online critical slices, columnar (synced on access)."""
        self.sync()
        return self._critical

    @property
    def idle_time(self) -> float:
        self.sync()
        return self._carry.idle

    @property
    def global_cm(self) -> float:
        self.sync()
        return self._carry.global_cm

    @property
    def t_first(self) -> int | None:
        self.sync()
        return self._carry.t0_ns

    @property
    def t_switch(self) -> int | None:
        self.sync()
        return self._carry.t_last_ns

    @property
    def total_slices(self) -> int:
        self.sync()
        return self._total_slices

    def freeze(self) -> EventLog:
        self.sync()
        return self._store.freeze(self.total_count)

    @property
    def store(self):
        """The accumulating event store (EventStore or SpillStore)."""
        return self._store

    def per_worker_cm(self) -> np.ndarray:
        self.sync()
        return self._carry.per_worker_padded(self.total_count)

    def worker_names(self) -> list[str]:
        return [w.name for w in self.workers]

    def memory_bytes(self) -> int:
        """Profiler-side *resident* memory: accumulated log (its RAM share
        only, for a spill store) + pending shards + critical buffer (the
        paper's Table-2 'M' column analogue)."""
        store_b = getattr(self._store, "resident_nbytes", None)
        if store_b is None:
            store_b = self._store.nbytes
        return store_b + self.ring.approx_nbytes() + self._critical.nbytes


class LockedTracer:
    """The seed probe body: one global lock + per-event Python map updates.

    Retained verbatim as (a) the measured baseline of the probe
    microbenchmark (``bench_cmetric`` / ``--smoke probe``) and (b) a
    semantic oracle for the sharded tracer — both maintain the paper's
    Table-1 state, one per event under a lock, one batched through the
    vectorised fold.  Do not use for live profiling: every ``begin``/``end``
    of every worker serializes on ``_lock``.
    """

    def __init__(self, n_min: float | None = None, top_m: int = 8,
                 capacity: int = 1 << 20, clock=time.perf_counter_ns):
        self.n_min = n_min
        self.clock = clock
        self.tags = TagRegistry()
        self.stacks = StackRegistry(top_m)
        self.ring = EventRing(capacity)
        self.workers: list[WorkerInfo] = []       # guarded-by: self._lock
        self._tag_stacks: dict[int, list[int]] = {}   # guarded-by: self._lock
        self._open: set[int] = set()              # guarded-by: self._lock
        self.global_cm = 0.0                      # guarded-by: self._lock
        self.local_cm: dict[int, float] = {}      # guarded-by: self._lock
        self.slice_start: dict[int, int] = {}     # guarded-by: self._lock
        self.thread_count = 0                     # guarded-by: self._lock
        self.cm_hash: dict[int, float] = {}       # guarded-by: self._lock
        self.idle_time = 0.0                      # guarded-by: self._lock
        self.t_switch: int | None = None          # guarded-by: self._lock
        self.t_first: int | None = None           # guarded-by: self._lock
        self.critical = CriticalBuffer()          # guarded-by: self._lock
        self._lock = threading.Lock()
        self.enabled = True

    def register_worker(self, name: str, kind: str = "thread") -> int:
        with self._lock:
            wid = len(self.workers)
            self.workers.append(WorkerInfo(wid, name, kind))
            self._tag_stacks[wid] = []
            self.cm_hash[wid] = 0.0
            self.local_cm[wid] = 0.0
        return wid

    @property
    def total_count(self) -> int:
        return len(self.workers)

    def _resolved_n_min(self) -> float:
        return self.n_min if self.n_min is not None else self.total_count / 2

    # the seed sched_switch probe body (call with self._lock held)
    def _event(self, t: int, wid: int, delta: int,  # guarded-by: self._lock
               tag: int, stack: int) -> None:
        if self.t_first is None:
            self.t_first = t
        dt = (t - self.t_switch) * 1e-9 if self.t_switch is not None else 0.0
        if self.thread_count > 0:
            self.global_cm += dt / self.thread_count
        else:
            self.idle_time += dt
        self.t_switch = t
        if delta == ACTIVATE:
            if wid in self._open:      # paper §3.2: already-running threads
                return                 # do not alter thread_count
            self.local_cm[wid] = self.global_cm
            self.slice_start[wid] = t
            self.thread_count += 1
            self._open.add(wid)
        else:
            if wid not in self._open:  # spurious switch-out: ignore
                return
            slice_cm = self.global_cm - self.local_cm[wid]
            self.cm_hash[wid] = self.cm_hash.get(wid, 0.0) + slice_cm
            self.thread_count -= 1
            self._open.discard(wid)
            dur = (t - self.slice_start.get(wid, t)) * 1e-9
            threads_av = dur / slice_cm if slice_cm > 0 else float(
                max(self.thread_count + 1, 1))
            if threads_av < self._resolved_n_min():
                self.critical.append(
                    wid, self.slice_start.get(wid, t), t, slice_cm,
                    threads_av, stack, self.thread_count + 1)
        self.ring.append(t, wid, delta, tag, stack)

    def begin(self, wid: int, tag: str, location: str | None = None) -> int:
        if not self.enabled:
            return NO_TAG
        if location is None:
            f = sys._getframe(1)
            location = f"{f.f_globals.get('__name__', '?')}:{f.f_lineno}"
        tid = self.tags.intern(tag, location)
        with self._lock:
            self._tag_stacks[wid].append(tid)
            self._event(self.clock(), wid, ACTIVATE, tid, NO_STACK)
        return tid

    def end(self, wid: int) -> None:
        if not self.enabled:
            return
        with self._lock:
            st = self._tag_stacks[wid]
            sid = self.stacks.intern(tuple(st))
            tid = st.pop() if st else NO_TAG
            self._event(self.clock(), wid, DEACTIVATE, tid, sid)

    @contextlib.contextmanager
    def span(self, wid: int, tag: str) -> Iterator[None]:
        self.begin(wid, tag)
        try:
            yield
        finally:
            self.end(wid)

    def sync(self) -> None:
        """No-op: the locked body maintains its state per event."""

    @property
    def total_slices(self) -> int:
        with self._lock:
            n = min(self.ring.head, self.ring.capacity)
        return int(np.sum(self.ring.deltas[:n] == DEACTIVATE)) if n else 0

    def snapshot(self) -> dict:
        """One consistent view of the online state (single lock hold)."""
        with self._lock:
            n = min(self.ring.head, self.ring.capacity)
            return {
                "critical": self.critical.table(),
                "per_worker": self.per_worker_cm(),
                "total_slices": int(np.sum(
                    self.ring.deltas[:n] == DEACTIVATE)) if n else 0,
                "idle_time": self.idle_time,
                "total_time": ((self.t_switch - self.t_first) * 1e-9
                               if self.t_first is not None else 0.0),
            }

    def freeze(self) -> EventLog:
        return self.ring.freeze(self.total_count)

    def per_worker_cm(self) -> np.ndarray:
        out = np.zeros(self.total_count)
        for w, v in self.cm_hash.items():
            out[w] = v
        return out

    def worker_names(self) -> list[str]:
        return [w.name for w in self.workers]
