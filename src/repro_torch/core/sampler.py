"""Periodic sampling probe (paper §4.3).

A daemon thread fires every ``dt`` seconds; **iff** the instantaneous active
worker count is below ``n_min`` it records, for every active worker, the
current top-of-stack tag — the TPU-framework analogue of reading the
instruction pointer.  Samples go to a struct-of-arrays buffer shared with the
detector (the paper's single eBPF circular buffer).  A live
:class:`~repro_torch.core.session.ProfileSession` owns one probe and starts/stops
it with the session; the incremental ``snapshot()`` reads the buffer
concurrently with appends (prefix reads are safe — rows publish before the
head moves).

The conditional is what keeps overhead negligible: during healthy, fully
parallel execution the probe wakes, reads one int, and goes back to sleep.
Both reads are lock-free against the sharded tracer: ``thread_count`` is
derived from each shard's last published event and ``active_tags`` peeks the
workers' immutable cons-chain tag stacks, so a probe firing never blocks —
and never delays — a worker's span hot path (the seed took the tracer's
global lock here, serializing the sampler against every begin/end).
"""
from __future__ import annotations

import threading

import numpy as np

from repro_torch.core.tracer import Tracer


class SampleBuffer:
    def __init__(self, capacity: int = 1 << 18):
        self.capacity = capacity
        self.times = np.zeros(capacity, np.int64)
        self.workers = np.zeros(capacity, np.int32)
        self.tags = np.zeros(capacity, np.int32)
        self.head = 0
        self.dropped = 0
        self._sorted = None
        self._sorted_head = -1

    def append(self, t: int, worker: int, tag: int) -> None:
        i = self.head
        if i >= self.capacity:
            self.dropped += 1
            return
        self.times[i] = t
        self.workers[i] = worker
        self.tags[i] = tag
        self.head = i + 1

    def frozen(self):
        n = self.head
        return self.times[:n], self.workers[:n], self.tags[:n]

    def frozen_sorted(self):
        """(times, workers, tags) lexsorted by (worker, time) — the layout
        the vectorised detector attaches with one searchsorted per worker
        group.  Cached until the next append."""
        n = self.head
        if self._sorted is None or self._sorted_head != n:
            t, w, g = self.frozen()
            order = np.lexsort((t, w))
            self._sorted = (t[order], w[order], g[order])
            self._sorted_head = n
        return self._sorted

    def __len__(self) -> int:
        return self.head


class SamplingProbe:
    """Δt-periodic conditional sampler (runs as a daemon thread)."""

    def __init__(self, tracer: Tracer, dt: float = 0.003,
                 n_min: float | None = None, capacity: int = 1 << 18):
        self.tracer = tracer
        self.dt = dt
        self.n_min = n_min
        self.buffer = SampleBuffer(capacity)
        self.ticks = 0
        self.hits = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _resolved_n_min(self) -> float:
        if self.n_min is not None:
            return self.n_min
        return self.tracer._resolved_n_min()

    def tick(self, t: int | None = None) -> int:
        """One probe firing; separated out so tests/simulations can drive it
        deterministically.  Returns number of samples taken."""
        self.ticks += 1
        if self.tracer.thread_count >= self._resolved_n_min():
            return 0
        t = self.tracer.clock() if t is None else t
        taken = 0
        for wid, tag in self.tracer.active_tags():
            self.buffer.append(t, wid, tag)
            taken += 1
        self.hits += taken
        return taken

    def _run(self) -> None:
        while not self._stop.wait(self.dt):
            self.tick()

    def start(self) -> None:
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="gapp-sampler")
            self._thread.start()

    def stop(self) -> None:
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=2.0)
            self._thread = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    @property
    def running(self) -> bool:
        return self._thread is not None

    def stats(self) -> dict:
        """Probe counters for :meth:`ProfileSession.stats` / dashboards."""
        return {"ticks": self.ticks, "hits": self.hits,
                "stored": len(self.buffer), "dropped": self.buffer.dropped}


def simulate_samples(log, dt_ns: int, n_min: float,
                     buffer: SampleBuffer | None = None) -> SampleBuffer:
    """Offline replay of the sampling probe over a pre-timestamped
    :class:`~repro_torch.core.events.EventLog` (simulated fleet traces, device-side
    timing streams) — produces exactly the samples the live probe would have
    taken had it run at ``dt_ns`` period against those events.

    Vectorised: for each tick we binary-search the event index, recover the
    active count from the running cumsum of deltas, and each worker's current
    tag from its most recent ACTIVATE.
    """
    buffer = buffer or SampleBuffer(max(1 << 12, 2 * len(log)))
    if len(log) == 0:
        return buffer
    t0, t1 = int(log.times[0]), int(log.times[-1])
    ticks = np.arange(t0 + dt_ns, t1, dt_ns, dtype=np.int64)
    if ticks.size == 0:
        return buffer
    counts = np.cumsum(log.deltas.astype(np.int64))
    # event index whose effect is live at tick time (rightmost event <= tick)
    ei = np.searchsorted(log.times, ticks, side="right") - 1
    low = counts[ei] < n_min
    if not np.any(low):
        return buffer
    # per-worker open-span tag via per-worker replay (W small, E moderate)
    for w in range(log.num_workers):
        sel = log.workers == w
        wt = log.times[sel]
        wd = log.deltas[sel]
        wtag = log.tags[sel]
        if wt.size == 0:
            continue
        j = np.searchsorted(wt, ticks[low], side="right") - 1
        openmask = (j >= 0) & (wd[np.maximum(j, 0)] == 1)
        tick_sel = ticks[low][openmask]
        tag_sel = wtag[np.maximum(j, 0)][openmask]
        for t, tag in zip(tick_sel, tag_sel):
            buffer.append(int(t), w, int(tag))
    return buffer
