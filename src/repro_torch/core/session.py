"""Streaming ``ProfileSession`` — the profiler's public API.

GAPP is a *live* profiler: the paper streams context-switch events out of
per-CPU kernel ring buffers continuously and reports bottlenecks while the
workload runs.  :class:`ProfileSession` is that shape end-to-end: a session
wires an **event source** into the carry-resumable fold pipeline
(:func:`~repro_torch.core.cmetric.fold_chunk` / ``FoldCarry``), runs a
**background drain+fold worker** so analysis overlaps capture, and exposes

* :meth:`snapshot` — an incremental :class:`BottleneckReport` available at
  any time, without stopping the workload (bit-equal on the ``numpy``
  backend to an offline recompute of the same prefix);
* :meth:`result` — the final report on close (quiesce + last drain);
* :meth:`watch` — live push: the drain worker delivers a fresh top-N
  report to a callback every ``every`` seconds;
* :meth:`export` — any registered exporter (:mod:`repro_torch.core.exporters`:
  ``text`` / ``json`` / ``chrome`` / ``callback`` / ``watch``).

Sources are pluggable (:class:`EventSource`):

* :class:`TracerSource` — the live sharded tracer (default; created
  implicitly, spans via :meth:`ProfileSession.span` etc.);
* :class:`LogSource` — offline replay of an :class:`~repro_torch.core.events.EventLog`
  in ``chunk_events`` batches (what :func:`repro_torch.core.profiler.profile_log`
  wraps);
* :class:`SpillSource` — replay of a :class:`~repro_torch.core.spill.SpillStore`
  file, one block at a time, so a spilled capture re-analyses in bounded
  memory.

Memory is bounded on the capture side too: ``ProfileSession(spill_path=...)``
gives the tracer a :class:`~repro_torch.core.spill.SpillStore`, which pages every
drained chunk to an append-only file — resident event memory stays
O(``chunk_events``) for arbitrarily long runs (the two streaming items on
the ROADMAP: overlap drain/fold with capture, bound ``freeze()`` memory).

Fleet wiring rides the same shapes: ``session.export("remote",
addr=(host, port), journal=path)`` attaches a durable
:class:`~repro_torch.fleet.transport.RemoteSink` (the journal makes producer
restarts resumable — see :mod:`repro_torch.fleet.transport`), a
:class:`~repro_torch.fleet.aggregate.FleetSource` — live from an
``IngestServer``, or replayed via ``FleetSource.from_files`` /
``FleetSource.from_fleet_dir`` — plugs in as this session's source, and
:meth:`stats` surfaces per-sink transport counters for dashboards.

Typical live use::

    with ProfileSession(n_min=None, dt=0.003) as s:
        w = s.register_worker("data_loader")
        s.watch(lambda rep: print(rep.paths[:1]), every=1.0)
        with s.span(w, "load_batch"):
            ...
        mid = s.snapshot()           # incremental, workload keeps running
    final = s.result()
    print(s.export("text", max_paths=3))

Offline replay::

    rep = ProfileSession.offline(log, tags, stacks, n_min=32,
                                 chunk_events=65536).result()

Device: a session folds on ``device`` (default: the source's ``device``
when it has one, else :func:`repro_torch.device.default_device`, CUDA),
resolved once at construction — CUDA without a card raises there.  Every
fold, snapshot, report and replay the session runs is wrapped in
``use_device(session.device)``, so the choice holds on the background
worker's thread and on any other thread that drains or reads the session
(a ``contextvars`` default does not cross threads).  The default fold
backend is ``fused``: the chunked fold's prefix on the ``carry_cumsum``
kernel, and on CUDA the detector's (path, tag) histogram on the
``tag_hist`` kernel.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Callable, Iterator

from repro_torch import device as device_lib
from repro_torch.core import backends as backends_lib
from repro_torch.core import detector as detector_lib
from repro_torch.core import exporters as exporters_lib
from repro_torch.core.cmetric import FoldCarry
from repro_torch.core.events import EventLog, sanitize_chunk
from repro_torch.core.sampler import SampleBuffer, SamplingProbe, simulate_samples
from repro_torch.core.slices import CriticalBuffer
from repro_torch.core.spill import SpillStore
from repro_torch.core.tracer import StackRegistry, TagRegistry, Tracer


# ---------------------------------------------------------------------------
# pluggable event sources
# ---------------------------------------------------------------------------

class EventSource:
    """Where a session's events come from.

    Live sources (``live = True``) expose a :class:`Tracer` whose shards the
    background worker drains; offline sources yield time-sorted
    :class:`EventLog` chunks that the session folds through the same
    carry-resumable pipeline.  Offline sources carry their own tag/stack
    registries (empty ones by default) so reports can resolve names.
    """

    live = False
    num_workers: int = 0
    device = None            # a source may name the device to fold on

    def worker_names(self) -> list[str]:
        return [f"w{i}" for i in range(self.num_workers)]

    def worker_hosts(self) -> list[str] | None:
        """Host provenance per worker (fleet sources); None == single-host."""
        return None

    def chunks(self) -> Iterator[EventLog]:
        raise NotImplementedError

    def request_stop(self) -> None:
        """Ask an open-ended source (e.g. a fleet ingest stream) to flush
        and end its chunk iterator; finite replays ignore it.  Called by
        :meth:`ProfileSession.stop` before joining the worker."""


class TracerSource(EventSource):
    """Live capture: the sharded lock-free tracer (paper's kernel probes)."""

    live = True

    def __init__(self, tracer: Tracer):
        self.tracer = tracer

    @property
    def tags(self) -> TagRegistry:
        return self.tracer.tags

    @property
    def stacks(self) -> StackRegistry:
        return self.tracer.stacks

    @property
    def num_workers(self) -> int:
        return self.tracer.total_count

    def worker_names(self) -> list[str]:
        return self.tracer.worker_names()


class LogSource(EventSource):
    """Offline replay of a finished :class:`EventLog` in bounded chunks."""

    def __init__(self, log: EventLog, tags: TagRegistry | None = None,
                 stacks: StackRegistry | None = None,
                 worker_names: list[str] | None = None,
                 chunk_events: int | None = None):
        self.log = log
        self.tags = tags if tags is not None else TagRegistry()
        self.stacks = stacks if stacks is not None else StackRegistry()
        self.num_workers = log.num_workers
        self.chunk_events = chunk_events
        self._worker_names = worker_names

    def worker_names(self) -> list[str]:
        return self._worker_names or super().worker_names()

    def chunks(self) -> Iterator[EventLog]:
        ce = self.chunk_events or max(len(self.log), 1)
        for lo in range(0, len(self.log), ce):
            yield self.log.chunk(lo, lo + ce)

    def full_log(self) -> EventLog:
        return self.log


class SpillSource(EventSource):
    """Offline replay of a spilled capture, one disk block at a time."""

    def __init__(self, store: SpillStore | str, num_workers: int,
                 tags: TagRegistry | None = None,
                 stacks: StackRegistry | None = None,
                 worker_names: list[str] | None = None,
                 chunk_events: int = 1 << 16):
        # a path means "replay this file": open read-only (the writer-mode
        # SpillStore constructor truncates, which would destroy the capture)
        self.store = store if isinstance(store, SpillStore) \
            else SpillStore.open_readonly(store, chunk_events)
        self.tags = tags if tags is not None else TagRegistry()
        self.stacks = stacks if stacks is not None else StackRegistry()
        self.num_workers = int(num_workers)
        self._worker_names = worker_names

    def worker_names(self) -> list[str]:
        return self._worker_names or super().worker_names()

    def chunks(self) -> Iterator[EventLog]:
        return self.store.iter_chunks(self.num_workers)

    def full_log(self) -> EventLog:
        return self.store.freeze(self.num_workers)


@dataclasses.dataclass
class _Watch:
    callback: Callable
    every: float
    top_n: int | None
    payload: bool = False    # deliver a JSON-ready dict, not the report
    next_due: float = 0.0    # guarded-by: ProfileSession._watch_lock


# ---------------------------------------------------------------------------
# the session
# ---------------------------------------------------------------------------

class ProfileSession:
    """One profiling run: source → background drain+fold → reports/exports.

    With no ``source`` a live session is created: a sharded
    :class:`Tracer` (optionally spilling to ``spill_path``) plus the
    §4.3 sampling probe, both driven by :meth:`start`/:meth:`stop` (or the
    :meth:`running` context manager / ``with`` block).  ``drain_interval``
    is the background worker's cadence: how often pending shard events are
    k-way-merged and folded while the workload runs.

    Offline sources replay their chunks through the identical pipeline —
    in the background after :meth:`start`, or inline at :meth:`result`.

    ``device`` is where the folds and the report's histogram run (see the
    module docstring); it defaults to the source's ``device``, else to the
    port's default device.
    """

    def __init__(self, source: EventSource | None = None, *,
                 n_min: float | None = None, dt: float = 0.003,
                 top_m: int = 8, top_n: int = 10, capacity: int = 1 << 16,
                 clock=None, fold_backend: str = "fused",
                 autoflush: bool = True, drain_interval: float = 0.002,
                 spill_path: str | None = None, chunk_events: int = 1 << 16,
                 sample_dt_ns: int | None = None,
                 samples: SampleBuffer | None = None, store=None,
                 max_rows_per_sync: int | None = None, device=None):
        self.device = device_lib.resolve(
            getattr(source, "device", None) if device is None else device)
        if source is None:
            if store is None and spill_path is not None:
                store = SpillStore(spill_path, chunk_events=chunk_events)
            kwargs = {} if clock is None else {"clock": clock}
            source = TracerSource(Tracer(
                n_min=n_min, top_m=top_m, capacity=capacity,
                fold_backend=fold_backend, autoflush=autoflush, store=store,
                max_rows_per_sync=max_rows_per_sync, device=self.device,
                **kwargs))
        self.source = source
        self.top_n = top_n
        self.fold_backend = fold_backend
        self.chunk_events = chunk_events
        self.drain_interval = drain_interval
        self._n_min = n_min
        self._watchers: list[_Watch] = []    # guarded-by: self._watch_lock
        self._watch_lock = threading.Lock()
        self.watch_errors: list[Exception] = []
        self._worker: threading.Thread | None = None
        self._stop_evt = threading.Event()
        self._closed = False
        self._final: "detector_lib.BottleneckReport | None" = None
        if source.live:
            self.tracer: Tracer | None = source.tracer
            self.probe: SamplingProbe | None = SamplingProbe(
                self.tracer, dt=dt, n_min=n_min)
            self._folded = 0
            self.tracer.on_drain.append(self._note_drain)
        else:
            self.tracer = None
            self.probe = None
            self._folded = 0
            self._sanitize_dropped = 0           # guarded-by: self._fold_lock
            self._sample_dt_ns = sample_dt_ns
            self._samples = samples
            self._carry = FoldCarry.init(source.num_workers)   # guarded-by: self._fold_lock
            self._crit = CriticalBuffer()        # guarded-by: self._fold_lock
            self._fold_lock = threading.Lock()
            self._chunk_iter: Iterator[EventLog] | None = None
            self._done = threading.Event()

    # -- construction helpers ------------------------------------------------
    @classmethod
    def offline(cls, log: EventLog, tags: TagRegistry | None = None,
                stacks: StackRegistry | None = None, *,
                n_min: float | None = None, backend: str = "fused",
                chunk_events: int | None = None,
                sample_dt_ns: int | None = None,
                samples: SampleBuffer | None = None, top_n: int = 10,
                worker_names: list[str] | None = None,
                device=None) -> "ProfileSession":
        """Session over a finished log (the `profile_log` shape)."""
        src = LogSource(log, tags, stacks, worker_names, chunk_events)
        return cls(src, n_min=n_min, fold_backend=backend, top_n=top_n,
                   sample_dt_ns=sample_dt_ns, samples=samples,
                   chunk_events=chunk_events or 1 << 16, device=device)

    # -- live probe API (delegates; raises for offline sources) -------------
    def _live(self) -> Tracer:
        if self.tracer is None:
            raise RuntimeError("offline session has no live span API")
        return self.tracer

    def register_worker(self, name: str, kind: str = "thread") -> int:
        return self._live().register_worker(name, kind)

    def handle(self, wid: int):
        """The worker's lock-free probe endpoint (hot-path begin/end)."""
        return self._live().handle(wid)

    def span(self, wid: int, tag: str):
        return self._live().span(wid, tag)

    def frame(self, wid: int, tag: str):
        return self._live().frame(wid, tag)

    def begin(self, wid: int, tag: str, loc: str | None = None) -> int:
        """Open a span.  Allocation-free on the hot path: the callsite is
        resolved once per distinct tag (or pass ``loc=`` explicitly)."""
        return self._live().begin(wid, tag, loc)

    def end(self, wid: int) -> None:
        return self._live().end(wid)

    def push(self, wid: int, tag: str) -> None:
        return self._live().push(wid, tag)

    def pop(self, wid: int) -> None:
        return self._live().pop(wid)

    def ingest(self, *a, **k):
        return self._live().ingest(*a, **k)

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        """Start the background machinery: the sampling probe and the
        drain+fold worker (live), or the chunk replay worker (offline)."""
        if self._worker is not None or self._closed:
            return
        self._stop_evt.clear()
        if self.source.live:
            self.probe.start()
            target = self._drain_loop
        else:
            target = self._offline_run
        self._worker = threading.Thread(target=target, daemon=True,
                                        name="gapp-session")
        self._worker.start()

    def stop(self) -> None:
        """Quiesce the background machinery (keeps the session open: spans
        can still be recorded and snapshots taken; ``close()`` finalizes).
        Open-ended sources (fleet ingest) are asked to flush and end their
        stream first, so the worker can't be stuck waiting for data."""
        self._stop_evt.set()
        self.source.request_stop()
        if self._worker is not None:
            self._worker.join(timeout=5.0)
            self._worker = None
        if self.probe is not None:
            self.probe.stop()

    @contextlib.contextmanager
    def running(self):
        self.start()
        try:
            yield self
        finally:
            self.stop()

    def __enter__(self) -> "ProfileSession":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        """Quiesce, run the final drain+fold, cache the final report."""
        if self._closed:
            return
        self.stop()
        if not self.source.live:
            self._offline_drain_inline()
        elif self.tracer.max_rows_per_sync is not None:
            self.tracer.sync()      # final reports are complete: consume
            #                         the backlog budget-wise before sealing
        # seal BEFORE the final snapshot so it takes the unbudgeted path —
        # stragglers appended since the sync above must all be folded
        self._closed = True
        self._final = self.snapshot()
        self._fire_watchers(force=True)
        store = getattr(self.tracer, "store", None) if self.tracer else None
        if store is not None:
            store.spill()
        for sink in getattr(self.tracer, "sinks", None) or []:
            sink.spill()            # flush-barrier attached RemoteSinks

    # -- background workers --------------------------------------------------
    def _note_drain(self, n_events: int) -> None:
        # tracer on_drain hook (under the fold lock): counters only
        self._folded += n_events

    def _drain_loop(self) -> None:
        tracer = self.tracer
        budgeted = tracer.max_rows_per_sync is not None
        backlog = 0
        # with a decode budget the loop bites off max_rows_per_sync rows per
        # shard per step and immediately re-runs while a backlog remains —
        # each step releases the fold lock, and a waiting snapshot()
        # (tracer._reader_waiting) makes the loop pause so the reader is
        # next in line: snapshot latency is one budget's decode, not the
        # whole backlog
        while not self._stop_evt.wait(
                0.0 if backlog and not tracer._reader_waiting
                else self.drain_interval):
            if budgeted:
                backlog = tracer.sync_budgeted()
            else:
                tracer.sync()
            self._fire_watchers()

    def _chunks(self) -> Iterator[EventLog]:
        if self._chunk_iter is None:
            self._chunk_iter = iter(self.source.chunks())
        return self._chunk_iter

    def _fold_one(self, part: EventLog) -> None:
        with self._fold_lock, device_lib.use_device(self.device):
            # fleet sources grow their worker space as hosts join the
            # merge; the carry must cover every id before sanitize indexes
            # its open mask
            self._carry.ensure_workers(part.num_workers)
            part, _, keep = sanitize_chunk(part, self._carry.open)
            self._sanitize_dropped += int(keep.size - keep.sum())
            self._carry, tbl = backends_lib.fold_chunk(
                self._carry, part, backend=self.fold_backend)
            self._crit.extend_table(tbl, tbl.threads_av < self._resolved_n_min())
            self._folded += len(part)

    def _offline_run(self) -> None:
        self._ensure_samples()
        try:
            # fold every chunk pulled from the generator BEFORE checking the
            # stop flag: a pulled-but-unfolded chunk would be lost (the
            # iterator is shared with close()'s inline drain)
            for part in self._chunks():
                self._fold_one(part)
                self._fire_watchers()
                if self._stop_evt.is_set():
                    break
        finally:
            self._done.set()

    def _offline_drain_inline(self) -> None:
        """Consume any chunks the background worker did not reach."""
        self._ensure_samples()
        for part in self._chunks():
            self._fold_one(part)
        self._done.set()

    def _ensure_samples(self) -> None:
        if (self._samples is None and self._sample_dt_ns is not None
                and hasattr(self.source, "full_log")):
            self._samples = simulate_samples(
                self.source.full_log().sanitize(), self._sample_dt_ns,
                self._resolved_n_min())

    # -- watchers (live incremental push) ------------------------------------
    def watch(self, callback: Callable, every: float = 0.5,
              top_n: int | None = None,
              payload: bool = False) -> Callable[[], None]:
        """Push an incremental report to ``callback`` every ``every``
        seconds while the session runs (first fire is immediate; a final
        report is always pushed at close).  Returns an unsubscribe handle.
        Callback exceptions are recorded in :attr:`watch_errors`, never
        raised into the drain worker.

        ``payload=True`` delivers the JSON-ready frame built by
        :func:`repro_torch.obs.payload.build_watch_payload` instead of the raw
        report — the same dict (``top`` + ``worker_hosts`` / ``per_host``
        lanes + ``health`` counters) that ``GET /api/stream`` pushes, so
        a watch callback and a stream subscriber can share rendering."""
        w = _Watch(callback, float(every), top_n, payload)
        with self._watch_lock:
            self._watchers.append(w)
        def unsubscribe() -> None:
            with self._watch_lock:
                if w in self._watchers:
                    self._watchers.remove(w)
        return unsubscribe

    def _fire_watchers(self, force: bool = False) -> None:
        now = time.monotonic()
        with self._watch_lock:
            due = [w for w in self._watchers
                   if force or now >= w.next_due]
            for w in due:
                # rescheduling inside the lock is the claim: a concurrent
                # _fire_watchers (drain loop vs. forced close) can no
                # longer select the same watcher and double-fire it
                w.next_due = now + w.every
        for w in due:
            try:
                rep = self.snapshot(w.top_n)
                if w.payload:
                    from repro_torch.obs.payload import build_watch_payload
                    w.callback(build_watch_payload(self, rep, w.top_n))
                else:
                    w.callback(rep)
            except Exception as e:          # noqa: BLE001 — user callback
                self.watch_errors.append(e)

    # -- reports --------------------------------------------------------------
    def _resolved_n_min(self) -> float:
        if self.source.live:
            return self.tracer._resolved_n_min()
        if self._n_min is not None:
            return self._n_min
        return self.source.num_workers / 2

    @property
    def tags(self) -> TagRegistry:
        return self.source.tags

    @property
    def stacks(self) -> StackRegistry:
        return self.source.stacks

    def _hist_device(self):
        """Where the report's (path, tag) histogram runs: the ``tag_hist``
        kernel on the session's device for the fused backend on CUDA (the
        detector's rule), ``bincount`` on the host otherwise (None)."""
        caps = backends_lib.get_backend(self.fold_backend).capabilities
        if "fused" in caps and self.device.type == "cuda":
            return self.device
        return None

    def snapshot(self, top_n: int | None = None):
        """Incremental :class:`BottleneckReport` from the state folded so
        far — callable at any time, concurrently with capture (one sync
        point; the workload's probes never block on it)."""
        if self._closed and self._final is not None and top_n is None:
            return self._final
        with device_lib.use_device(self.device):
            return self._snapshot(top_n or self.top_n)

    def _snapshot(self, top_n: int):
        if self.source.live:
            # under a decode budget a mid-capture snapshot flushes at most
            # one budget (bounded latency); the final close() consumes the
            # whole backlog first, so sealed reports are complete
            budgeted = (not self._closed
                        and self.tracer.max_rows_per_sync is not None)
            rep = detector_lib.detect(self.tracer, self.probe.buffer,
                                      top_n=top_n, budgeted=budgeted,
                                      hist_device=self._hist_device())
            rep.replay.device = self.device
            return rep
        with self._fold_lock:
            crit = self._crit.table()
            st = self._carry.state()
        rep = detector_lib.build_report(
            crit, self._samples, self.stacks, self._resolved_n_min(),
            per_worker=st["per_worker"],
            worker_names=self.source.worker_names(),
            tag_names=list(self.tags.names),
            tag_locations=list(self.tags.locations),
            total_slices=st["slices"],
            idle_time=st["idle_time"],
            total_time=st["total_time"],
            top_n=top_n,
            hist_device=self._hist_device(),
            worker_hosts=self.source.worker_hosts(),
        )
        if hasattr(self.source, "full_log"):
            # counterfactual replay handle (lazy: nothing is read until a
            # what_if/sensitivity query actually runs)
            from repro_torch.core.whatif import ReplaySpec
            rep.replay = ReplaySpec(
                log_provider=self.source.full_log, tags=self.tags,
                stacks=self.stacks, n_min=self._resolved_n_min(),
                backend=self.fold_backend, samples=self._samples,
                sample_dt_ns=self._sample_dt_ns,
                worker_names=self.source.worker_names(),
                worker_hosts=self.source.worker_hosts(),
                chunk_events=self.chunk_events, device=self.device)
        return rep

    def result(self, top_n: int | None = None):
        """The final report: quiesce (stop probe + worker), fold everything
        pending, close the session, return the report."""
        self.close()
        return self._final if top_n is None else self.snapshot(top_n)

    def freeze(self) -> EventLog:
        """The accumulated event log (live: store contents after a final
        drain; offline: the source's full log).  For a spill store this
        reads the whole file back — prefer streaming re-analysis via
        :class:`SpillSource` when memory matters."""
        if self.source.live:
            return self.tracer.freeze()
        if hasattr(self.source, "full_log"):
            return self.source.full_log()
        raise RuntimeError(f"{type(self.source).__name__} has no full log")

    def offline_report(self, backend: str = "vector",
                       sample_dt_ns: int | None = None,
                       top_n: int | None = None,
                       chunk_events: int | None = None):
        """Recompute the profile offline from the accumulated log with any
        registered backend (cross-validates the online numbers; the vector/
        fused paths are the fleet-scale post-processing route), on the
        session's device."""
        tr = self._live()
        return detector_lib.detect_offline(
            self.freeze(), tr.tags, tr.stacks, tr._resolved_n_min(),
            samples=self.probe.buffer if len(self.probe.buffer) else None,
            sample_dt_ns=sample_dt_ns, backend=backend,
            top_n=top_n or self.top_n, worker_names=tr.worker_names(),
            chunk_events=chunk_events, device=self.device)

    # -- output side -----------------------------------------------------------
    def export(self, fmt: str = "text", **kw):
        """Run a registered exporter on the current snapshot (see
        :mod:`repro_torch.core.exporters`); the session is passed along so
        exporters like ``chrome`` can pull the event log.  Subscription
        exporters (``watch``) never consume a report, so no snapshot is
        built for them."""
        exp = exporters_lib.get_exporter(fmt)
        rep = None if "subscription" in exp.capabilities else self.snapshot()
        return exp(rep, session=self, **kw)

    def render(self, **kw) -> str:
        return self.export("text", **kw)

    def serve(self, addr: tuple[str, int] = ("127.0.0.1", 0), **kw):
        """Start a :class:`repro_torch.fleet.service.ProfilerService` over this
        session (on the session's device unless ``device=`` is passed): the live HTTP query API + dashboard (``/``,
        ``/api/report``, ``/api/top``, ``/api/whatif``, ``/api/hosts``,
        ``/api/stream``, ``/metrics``).  Keyword arguments (``server=``, ``fleet_dir=``,
        ``retention=``, ``top_n=``) pass through; returns the started
        service — ``close()`` it when done (the session is untouched)."""
        from repro_torch.fleet.service import ProfilerService
        return ProfilerService(self, addr, **kw).start()

    # -- observability ---------------------------------------------------------
    def stats(self) -> dict:
        """Counters for dashboards/tests: capture, fold and memory state.

        The key sets below are a STABLE schema — ``/metrics`` names
        derive from them mechanically and
        the port's tests pin them to the JAX package's; removing or renaming a
        key is a breaking change, new keys are additive.  ``mode`` is
        ``"live"`` or ``"offline"`` and selects which set applies.

        Live sessions (``mode == "live"``):

        * ``events_folded`` — events merged+folded so far;
        * ``events_pending`` — ring entries not yet drained;
        * ``ring_dropped`` — events lost to ring overflow (capture loss);
        * ``tolerance_dropped`` — events rejected by the nesting checker;
        * ``store_rows`` / ``store_resident_rows`` — total captured rows
          vs rows still resident in memory (the rest spilled);
        * ``resident_bytes`` — tracer memory footprint;
        * ``samples`` — sampling-probe sub-dict (``ticks``, ``hits``,
          ``stored``, ``dropped``);
        * ``watch_errors`` — callback exceptions swallowed;
        * ``sinks`` — per-transport :meth:`RemoteSink.stats` list, only
          when fleet sinks are attached.

        Offline / fleet sessions (``mode == "offline"``):

        * ``events_folded`` — rows folded from the source;
        * ``sanitize_dropped`` — rows rejected during chunk sanitising;
        * ``slices`` — closed spans folded;
        * ``critical_rows`` — rows in the critical table;
        * ``done`` — source fully drained;
        * ``watch_errors`` — as above;
        * ``source`` — the source's own stats when it has any (a
          :class:`FleetSource` surfaces ``hosts``, ``rows_in``,
          ``chunks_in``, ``buffered_rows``, ``clock_clamped``,
          ``shed_chunks``, ``shed_rows``, ``idle_hosts``,
          ``accepting``), so a consumer can tell whether the fold was
          complete or degraded.
        """
        if self.source.live:
            tr = self.tracer
            store = tr.store
            out = {
                "mode": "live",
                "events_folded": self._folded,
                "events_pending": tr.ring.pending(),
                "ring_dropped": tr.ring.dropped,
                "tolerance_dropped": tr.tolerance_dropped,
                "store_rows": len(store),
                "store_resident_rows": getattr(store, "resident_rows",
                                               len(store)),
                "resident_bytes": tr.memory_bytes(),
                "samples": self.probe.stats(),
                "watch_errors": len(self.watch_errors),
            }
            sinks = [s.stats() for s in getattr(tr, "sinks", None) or []
                     if hasattr(s, "stats")]
            if sinks:       # attached transports (e.g. fleet RemoteSinks)
                out["sinks"] = sinks
            return out
        out = {
            "mode": "offline",
            "events_folded": self._folded,
            "sanitize_dropped": self._sanitize_dropped,
            "slices": self._carry.slices,
            "critical_rows": len(self._crit),
            "done": self._done.is_set(),
            "watch_errors": len(self.watch_errors),
        }
        src_stats = getattr(self.source, "stats", None)
        if callable(src_stats):
            # e.g. a FleetSource: surfaces shed/lost/idle degradation so a
            # report consumer can see whether the fold was complete
            out["source"] = src_stats()
        return out
