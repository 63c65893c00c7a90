"""Event model for the GAPP profiler — capture is sharded, analysis is batched.

The unit of observation is a *state-change event* of a logical worker:

    ACTIVATE   (+1)  — the worker becomes busy (paper: switched in / woken up)
    DEACTIVATE (-1)  — the worker becomes idle (paper: switched out, blocked)

Two capture paths:

* :class:`ShardedEventRing` — the live hot path.  Every worker owns one
  shard and appends ``(t, meta)`` to it with **no cross-worker lock**; the
  software analogue of the paper's per-CPU eBPF buffers.  ``meta`` is the
  tag id for ACTIVATE and the captured call-stack (a cons chain, or
  ``None``) for DEACTIVATE, so the probe body never builds numpy rows or
  interns stacks — all decoding is deferred to :meth:`ShardedEventRing.drain`,
  which pops published events from every shard, decodes them columnar and
  k-way-merges them by timestamp in one vectorised argsort.  Publication
  order (timestamp first, meta last; readers snapshot ``len(metas)``) means
  a concurrent drain can only observe fully-published events — no torn rows.
* :class:`EventRing` — the legacy single-array ring, kept for external
  writers that want a locked multi-producer buffer.  Its append now stores
  the whole row *inside* the critical section (the seed reserved the slot
  under the lock but wrote the row after release, so a concurrent
  ``freeze()`` could sort half-written events).

Both overflow by dropping *new* events and counting them, mirroring BPF
ring-buffer drop semantics.

Finished streams are :class:`EventLog` struct-of-arrays (monotonic ns
int64 times) so the CMetric fold can run vectorised in numpy / PyTorch /
CUDA; :class:`EventStore` is the growable columnar accumulator the
tracer folds drained batches into.  :func:`sanitize_chunk` applies the
live tracer's §3.2 tolerance rules to a chunk given the carried per-worker
active state, so arbitrarily long dirty logs can be cleaned chunk by chunk
with results identical to whole-log :meth:`EventLog.sanitize`.
"""
from __future__ import annotations

import bisect
import dataclasses
import threading
from collections import deque

import numpy as np

ACTIVATE = 1
DEACTIVATE = -1

# Sentinel ids
NO_TAG = -1
NO_STACK = -1


@dataclasses.dataclass
class EventLog:
    """A finished, time-sorted event log.

    Attributes:
      times:   int64[E] monotonic timestamps (ns)
      workers: int32[E] logical worker ids (dense, 0..num_workers-1)
      deltas:  int8[E]  +1 activate / -1 deactivate
      tags:    int32[E] current top-of-stack tag id at the event (NO_TAG if none)
      stacks:  int32[E] interned call-path id recorded at DEACTIVATE (NO_STACK
               otherwise).  The call path is the worker's tag stack, truncated
               to the top ``M`` frames (paper §4.2); it is interned only when
               the finished timeslice was critical, so most entries are
               NO_STACK by design.
      num_workers: total number of registered workers (paper: total_count)
    """

    times: np.ndarray
    workers: np.ndarray
    deltas: np.ndarray
    tags: np.ndarray
    stacks: np.ndarray
    num_workers: int

    def __len__(self) -> int:
        return int(self.times.shape[0])

    def validate(self) -> None:
        if len(self) == 0:
            return
        if np.any(np.diff(self.times) < 0):
            raise ValueError("event log is not time sorted")
        if not np.all(np.abs(self.deltas) == 1):
            raise ValueError("deltas must be +1/-1")
        # A worker must alternate ACTIVATE/DEACTIVATE.
        for w in range(self.num_workers):
            d = self.deltas[self.workers == w]
            if d.size and (d[0] != ACTIVATE or np.any(d[1:] == d[:-1])):
                raise ValueError(f"worker {w} events do not alternate")

    def slice_seconds(self) -> np.ndarray:
        """Times rebased to t0 in float64 seconds (device-friendly)."""
        if len(self) == 0:
            return np.zeros((0,), np.float64)
        return (self.times - self.times[0]).astype(np.float64) * 1e-9

    def chunk(self, lo: int, hi: int) -> "EventLog":
        """Zero-copy view of rows ``[lo, hi)`` (for the chunked fold; the
        carry keeps the stream epoch, so chunks are never rebased to their
        own first event)."""
        return EventLog(self.times[lo:hi], self.workers[lo:hi],
                        self.deltas[lo:hi], self.tags[lo:hi],
                        self.stacks[lo:hi], self.num_workers)

    def is_well_formed(self, active: np.ndarray | None = None) -> bool:
        """True iff every worker's events alternate correctly given the
        per-worker ``active`` entry state (all-idle by default), checked
        vectorised — what :meth:`validate` enforces for fresh logs."""
        if len(self) == 0:
            return True
        order = np.argsort(self.workers, kind="stable")
        w = self.workers[order]
        d = self.deltas[order]
        first = np.concatenate([[True], w[1:] != w[:-1]])
        if active is None:
            first_ok = d[first] == ACTIVATE
        else:
            first_ok = (d[first] == ACTIVATE) != active[w[first]]
        return bool(np.all(first_ok)
                    and not np.any((d[1:] == d[:-1]) & (w[1:] == w[:-1])))

    def sanitize(self) -> "EventLog":
        """Apply the live tracer's tolerance rules (paper §3.2) offline:
        drop an ACTIVATE of an already-active worker and a DEACTIVATE of an
        inactive worker.  External/raw streams can carry both (spurious
        wake-ups, truncated captures); the offline pairing stage assumes
        alternation, so dirty logs must pass through here (``detect_offline``
        does it automatically).  Returns ``self`` when already well-formed.
        """
        if self.is_well_formed():
            return self
        clean, _, _ = sanitize_chunk(self,
                                     np.zeros(self.num_workers, bool))
        return clean


def tolerance_keep(workers: np.ndarray, deltas: np.ndarray,
                   active: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Vectorised §3.2 greedy filter with carried state.

    Per worker, the tracer keeps the subsequence that alternates correctly
    starting from its current ``active`` flag, chosen greedily — which for a
    ±1 stream equals collapsing runs of equal deltas to their first event
    and then dropping a leading survivor that does not toggle the carried
    state (an ACTIVATE while active / a DEACTIVATE while idle): runs
    alternate in value by construction, so the collapsed sequence already
    alternates, and skipping a mismatched initial run is exactly dropping
    its first survivor.

    Returns ``(keep_mask, active_out)``; ``active`` is not modified.
    """
    e = len(workers)
    if e == 0:
        return np.zeros(0, bool), active.copy()
    order = np.argsort(workers, kind="stable")
    w = workers[order]
    d = deltas[order]
    first = np.concatenate([[True], w[1:] != w[:-1]])
    run_start = np.concatenate([[True], d[1:] != d[:-1]]) | first
    mismatch = (d == ACTIVATE) == active[w]
    keep_sorted = run_start & ~(first & mismatch)
    keep = np.zeros(e, bool)
    keep[order] = keep_sorted
    # state after the chunk: the last *kept* delta per worker decides
    active_out = active.copy()
    kept_idx = np.flatnonzero(keep_sorted)
    if kept_idx.size:
        wk = w[kept_idx]
        dk = d[kept_idx]
        last = np.concatenate([wk[1:] != wk[:-1], [True]])
        active_out[wk[last]] = dk[last] == ACTIVATE
    return keep, active_out


def sanitize_chunk(
    log: EventLog, active: np.ndarray,
) -> tuple[EventLog, np.ndarray, np.ndarray]:
    """Chunk-resumable :meth:`EventLog.sanitize`.

    ``active`` is the per-worker open state carried from previous chunks
    (all-False for a fresh stream).  Returns ``(clean_chunk, active_out,
    keep_mask)``; folding a stream chunk by chunk through here keeps exactly
    the same events as whole-log ``sanitize`` — the greedy filter is
    sequential per worker, so its decisions cannot depend on where the
    stream is cut.
    """
    keep, active_out = tolerance_keep(log.workers, log.deltas, active)
    if keep.all():
        return log, active_out, keep
    clean = EventLog(log.times[keep], log.workers[keep], log.deltas[keep],
                     log.tags[keep], log.stacks[keep], log.num_workers)
    return clean, active_out, keep


class EventRing:
    """Pre-allocated locked ring buffer for events (multi-producer path).

    Append is a short critical section that both reserves the slot *and*
    stores the row — the seed released the lock between the two, so a
    concurrent ``freeze()`` could sort/copy partially-written rows.
    Overflow drops the new event and counts it (BPF ringbuf drop
    semantics).  The live tracer no longer uses this class (it captures
    into a :class:`ShardedEventRing`); it remains for external locked
    multi-producer use and as the torn-row regression target.
    """

    def __init__(self, capacity: int = 1 << 20):
        self.capacity = int(capacity)
        self.times = np.zeros(self.capacity, np.int64)      # guarded-by: self._lock
        self.workers = np.zeros(self.capacity, np.int32)    # guarded-by: self._lock
        self.deltas = np.zeros(self.capacity, np.int8)      # guarded-by: self._lock
        self.tags = np.full(self.capacity, NO_TAG, np.int32)      # guarded-by: self._lock
        self.stacks = np.full(self.capacity, NO_STACK, np.int32)  # guarded-by: self._lock
        self.head = 0                                       # guarded-by: self._lock
        self.dropped = 0                                    # guarded-by: self._lock
        self._lock = threading.Lock()

    def append(self, t: int, worker: int, delta: int, tag: int = NO_TAG,
               stack: int = NO_STACK) -> None:
        with self._lock:
            i = self.head
            if i >= self.capacity:
                self.dropped += 1
                return
            # the row must be fully published before the slot becomes
            # visible to freeze(): store under the same lock, bump head last
            self.times[i] = t
            self.workers[i] = worker
            self.deltas[i] = delta
            self.tags[i] = tag
            self.stacks[i] = stack
            self.head = i + 1  # publishes: self.times, self.workers, self.deltas, self.tags, self.stacks

    def freeze(self, num_workers: int) -> EventLog:
        with self._lock:
            n = min(self.head, self.capacity)
        order = np.argsort(self.times[:n], kind="stable")
        return EventLog(
            times=self.times[:n][order].copy(),
            workers=self.workers[:n][order].copy(),
            deltas=self.deltas[:n][order].copy(),
            tags=self.tags[:n][order].copy(),
            stacks=self.stacks[:n][order].copy(),
            num_workers=num_workers,
        )


class EventShard:
    """One worker's private capture buffer (single writer, lock-free).

    The hot path appends the timestamp to ``times`` and then the meta to
    ``metas``; a drain snapshots ``len(metas)`` and pops that many rows
    from both ends — because the meta is published last, every snapshotted
    row is complete.  ``meta`` encoding:

      int                       ACTIVATE, value = tag id
      tuple ``(tid, parent)``   DEACTIVATE, value = captured tag stack as a
                                cons chain (head = top of stack / callee)
      None                      DEACTIVATE with an empty tag stack
    """

    __slots__ = ("wid", "times", "metas", "capacity", "dropped",
                 "open_after_drain", "drained")

    def __init__(self, wid: int, capacity: int):
        self.wid = wid
        self.capacity = int(capacity)
        self.times: deque = deque()
        self.metas: deque = deque()
        self.dropped = 0
        self.open_after_drain = False
        self.drained = 0

    def __len__(self) -> int:
        return len(self.metas)

    @property
    def is_open(self) -> bool:
        """Best-effort active flag: the type of the most recent published
        meta (int == ACTIVATE).  Lock-free — deque end peeks are atomic."""
        try:
            return type(self.metas[-1]) is int
        except IndexError:
            return self.open_after_drain

    def last_time(self) -> int | None:
        try:
            return self.times[-1]
        except IndexError:
            return None


@dataclasses.dataclass
class DrainedChunk:
    """One merged, time-sorted batch popped from all shards.

    ``aux`` is an object array aligned with the rows: the captured cons
    stack for DEACTIVATE events (or ``None``), ``None`` for ACTIVATE —
    consumed by the tracer to intern call paths for critical slices only.
    """

    times: np.ndarray     # int64[E]
    workers: np.ndarray   # int32[E]
    deltas: np.ndarray    # int8[E]
    tags: np.ndarray      # int32[E]
    aux: np.ndarray       # object[E]

    def __len__(self) -> int:
        return int(self.times.shape[0])


class ShardedEventRing:
    """Per-worker sharded capture buffers + vectorised k-way drain.

    The hot path is shard-local: no cross-worker lock, no numpy row
    construction, no stack interning — just two deque appends (see
    :class:`EventShard`).  ``drain()`` (single consumer; the tracer calls
    it under its fold lock) pops all published rows from every shard,
    decodes metas columnar, and merges the shards by timestamp with one
    stable argsort — ties break by worker id, deterministically.

    Capacity is per shard.  A full shard drops new events and counts them
    per shard (surfaced via :attr:`dropped`); the tracer's append slow path
    gets a chance to trigger a flush first via ``on_highwater``.
    """

    def __init__(self, capacity: int = 1 << 16):
        self.capacity = int(capacity)
        self.shards: list[EventShard] = []
        self.on_highwater = None    # optional () -> None flush hook

    def add_shard(self) -> EventShard:
        sh = EventShard(len(self.shards), self.capacity)
        self.shards.append(sh)
        return sh

    # -- stats ---------------------------------------------------------------
    @property
    def dropped(self) -> int:
        return sum(sh.dropped for sh in self.shards)

    def dropped_per_shard(self) -> list[int]:
        return [sh.dropped for sh in self.shards]

    def pending(self) -> int:
        """Published-but-undrained events across all shards."""
        return sum(len(sh) for sh in self.shards)

    def total_events(self) -> int:
        """Events accepted so far (drained + pending, excluding drops)."""
        return sum(sh.drained + len(sh) for sh in self.shards)

    def approx_nbytes(self) -> int:
        # deque of (int, PyObject*) rows: ~64B per pending event + slack
        return sum(64 * len(sh) + 64 * sh.capacity // 8 for sh in self.shards)

    # -- consumer side -------------------------------------------------------
    def drain(self, limit_per_shard: int | None = None) -> DrainedChunk | None:
        """Pop published events from every shard and merge by time.

        Single-consumer; safe against concurrent appends (producers only
        touch the right end of their own deques, we only pop the left of a
        snapshotted prefix).  Returns ``None`` when nothing is pending.

        ``limit_per_shard`` caps the decode work of one drain (the
        per-shard decode budget): at most that many rows are popped per
        shard, oldest first, leaving the rest pending for the next drain.
        When the cap truncates a shard, every shard's take is additionally
        trimmed to the *time frontier* — the earliest last-popped timestamp
        among truncated shards — and rows beyond it are pushed back, so a
        capped drain never interleaves one shard's future with another's
        past (skewed shard rates would otherwise hit the cross-flush
        monotonic clamp and distort durations).
        """
        popped: list[tuple[EventShard, list, list]] = []
        frontier: int | None = None
        for sh in self.shards:
            m = len(sh.metas)           # publication snapshot
            truncated = limit_per_shard is not None and m > limit_per_shard
            if truncated:
                m = limit_per_shard
            if m == 0:
                continue
            # popleft() is atomic per call and touches the opposite end from
            # the producer; iterating the deque (islice/list) instead would
            # raise "deque mutated during iteration" under concurrent
            # appends.
            tpop = sh.times.popleft
            mpop = sh.metas.popleft
            ts = [tpop() for _ in range(m)]
            ms = [mpop() for _ in range(m)]
            popped.append((sh, ts, ms))
            if truncated and (frontier is None or ts[-1] < frontier):
                frontier = ts[-1]
        parts_t, parts_w, parts_d, parts_g, parts_a = [], [], [], [], []
        for sh, ts, ms in popped:
            if frontier is not None and ts[-1] > frontier:
                # keep the <= frontier prefix, push the tail back unpopped
                # (appendleft touches the consumer's end only — producers
                # append on the right)
                cut = bisect.bisect_right(ts, frontier)
                for t, mv in zip(reversed(ts[cut:]), reversed(ms[cut:])):
                    sh.metas.appendleft(mv)
                    sh.times.appendleft(t)
                ts = ts[:cut]
                ms = ms[:cut]
            m = len(ts)
            if m == 0:
                continue
            sh.drained += m
            deltas = np.empty(m, np.int8)
            tags = np.empty(m, np.int32)
            aux = np.empty(m, object)
            for i, mv in enumerate(ms):
                if type(mv) is int:
                    deltas[i] = ACTIVATE
                    tags[i] = mv
                else:                    # cons chain or None
                    deltas[i] = DEACTIVATE
                    tags[i] = mv[0] if mv is not None else NO_TAG
                    aux[i] = mv
            sh.open_after_drain = type(ms[-1]) is int
            parts_t.append(np.fromiter(ts, np.int64, m))
            parts_w.append(np.full(m, sh.wid, np.int32))
            parts_d.append(deltas)
            parts_g.append(tags)
            parts_a.append(aux)
        if not parts_t:
            return None
        times = np.concatenate(parts_t)
        workers = np.concatenate(parts_w)
        deltas = np.concatenate(parts_d)
        # Merge order: time, then DEACTIVATE before ACTIVATE, then worker.
        # Shards don't record cross-worker arrival order, so timestamp ties
        # need a deterministic rule; switch-out-first matches the scheduler
        # semantics (a slot is freed before another worker takes it at the
        # same instant) and keeps n_at_exit consistent with serial replay.
        order = np.lexsort((workers, deltas, times))
        return DrainedChunk(
            times=times[order],
            workers=workers[order],
            deltas=deltas[order],
            tags=np.concatenate(parts_g)[order],
            aux=np.concatenate(parts_a)[order],
        )


class EventStore:
    """Growable columnar accumulator of folded events (the frozen log).

    The tracer appends each drained+sanitized chunk here after folding it;
    chunks arrive time-sorted and boundary-clamped, so ``freeze()`` is a
    copy of the filled prefix with no re-sort.  Doubling numpy arrays, like
    :class:`~repro_torch.core.slices.CriticalBuffer`.

    This is the all-RAM store; the tracer accepts any object with this
    interface via ``Tracer(store=...)`` — in particular
    :class:`~repro_torch.core.spill.SpillStore`, which pages full blocks to an
    append-only file so ``resident_rows``/``resident_nbytes`` stay bounded
    no matter how long the capture runs (for this in-RAM store they simply
    equal the total).
    """

    _DTYPES = (np.int64, np.int32, np.int8, np.int32, np.int32)

    def __init__(self, capacity: int = 4096):
        self._cap = max(int(capacity), 1)
        self._cols = [np.zeros(self._cap, dt) for dt in self._DTYPES]
        self._len = 0

    def __len__(self) -> int:
        return self._len

    @property
    def nbytes(self) -> int:
        return sum(c.nbytes for c in self._cols)

    @property
    def resident_rows(self) -> int:
        """Rows held in RAM (== all rows: this store never spills)."""
        return self._len

    @property
    def resident_nbytes(self) -> int:
        return self.nbytes

    def spill(self) -> None:
        """No-op for the in-RAM store (interface parity with SpillStore)."""

    def close(self) -> None:
        """No-op for the in-RAM store (interface parity with SpillStore)."""

    def _reserve(self, extra: int) -> None:
        need = self._len + extra
        if need <= self._cap:
            return
        while self._cap < need:
            self._cap *= 2
        self._cols = [np.concatenate([c, np.zeros(self._cap - len(c),
                                                  c.dtype)])
                      for c in self._cols]

    def append_columns(self, times, workers, deltas, tags, stacks) -> None:
        e = len(times)
        if e == 0:
            return
        self._reserve(e)
        lo = self._len
        for col, arr in zip(self._cols, (times, workers, deltas, tags,
                                         stacks)):
            col[lo:lo + e] = arr
        self._len = lo + e

    def freeze(self, num_workers: int) -> EventLog:
        n = self._len
        t, w, d, g, s = (c[:n].copy() for c in self._cols)
        return EventLog(times=t, workers=w, deltas=d, tags=g, stacks=s,
                        num_workers=num_workers)


def synthetic_log(
    rng: np.random.Generator,
    num_workers: int,
    slices_per_worker: int,
    busy_ns=(10_000, 1_000_000),
    idle_ns=(1_000, 500_000),
    skew: np.ndarray | None = None,
) -> EventLog:
    """Generate a well-formed random log (used by tests/benchmarks).

    ``skew`` multiplies per-worker busy durations: a straggler has skew > 1.
    """
    times, workers, deltas = [], [], []
    skew = np.ones(num_workers) if skew is None else np.asarray(skew, np.float64)
    for w in range(num_workers):
        t = int(rng.integers(0, idle_ns[1]))
        for _ in range(slices_per_worker):
            busy = int(rng.integers(*busy_ns) * skew[w])
            times += [t, t + busy]
            workers += [w, w]
            deltas += [ACTIVATE, DEACTIVATE]
            t += busy + int(rng.integers(*idle_ns))
    order = np.argsort(np.asarray(times, np.int64), kind="stable")
    e = len(times)
    return EventLog(
        times=np.asarray(times, np.int64)[order],
        workers=np.asarray(workers, np.int32)[order],
        deltas=np.asarray(deltas, np.int8)[order],
        tags=np.full(e, NO_TAG, np.int32),
        stacks=np.full(e, NO_STACK, np.int32),
        num_workers=num_workers,
    )
