"""The program's spans in the traced window: device and host time by span,
and the card's idle time while a GAPP drain is open.

The program names its layers with spans (``repro_torch.spans``), which
``torch.profiler`` records as host ops.  Each device event (kernel, copy,
set) is credited to the innermost of :data:`SPANS` that encloses the host
op that launched it: the device event's linked correlation id names that
op, and the ops of one thread nest.  A backward op is credited as the
forward op it differentiates (the autograd sequence number and forward
thread it carries), so a backward kernel goes to its forward op's span;
remat's recompute re-enters the spans itself.  Device time is credited
exclusively: where device events overlap, the earlier one holds the time,
so the seconds over all spans and :data:`NONE` (launched outside every
span, or by a thread the profiler does not see) add up to the device's busy
time in the window.

GAPP's drain thread is invisible to the profiler; the program keeps its
own record of each drain (``Tracer.drain_record``) on GAPP's clock, which
:class:`Tracing` maps onto the trace's clock through two anchors taken at
the profiler's start and stop (``repro_torch.spans.ClockMap``).

:class:`Tracing` is ``devtrace.Tracing`` with this reduction added to its
summary, under ``spans``; ``spanrun.py`` runs a cell with it.
"""
from __future__ import annotations

import collections
import dataclasses

import torch

from gappbench import devtrace

SPANS = ("serve/submit", "serve/step.issue", "train/loader_wait",
         "train/step.issue", "model/attention", "optim/adamw")
#: The name prefix of CUDA's API calls in a trace (``cudaLaunchKernel``,
#: ``cuLaunchKernel``).
RUNTIME = "cu"
#: Where device time launched outside every span is credited.
NONE = "(no span)"


@dataclasses.dataclass
class Op:
    """A host op of the trace: ``corr`` its correlation id, ``seq`` its
    autograd sequence number (-1: none), ``fwd`` the forward thread of a
    backward op (0: a forward op)."""

    name: str
    tid: int
    start: int
    end: int
    corr: int = 0
    seq: int = -1
    fwd: int = 0


@dataclasses.dataclass
class Dev:
    """A device event: ``link`` is the correlation id of the host op that
    launched it (0: none)."""

    start: int
    end: int
    link: int = 0


def events(prof) -> tuple[list[Op], list[Dev]]:
    """The host ops and device events of a ``torch.profiler`` run (device
    mirrors of annotations left out, as ``devtrace`` leaves them)."""
    ops, dev = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CPU:
            ops.append(Op(e.name(), e.start_thread_id(), e.start_ns(),
                          e.end_ns(), e.correlation_id(), e.sequence_nr(),
                          e.fwd_thread_id()))
        elif not devtrace._annotation(e):
            dev.append(Dev(e.start_ns(), e.end_ns(),
                           e.linked_correlation_id()))
    return ops, dev


def _parents(ops: list[Op]) -> list[int]:
    """Each op's enclosing op on its thread (-1: none): ops of one thread
    nest, so a stack sweep in start order finds it."""
    parent = [-1] * len(ops)
    by_tid: dict = collections.defaultdict(list)
    for i, o in enumerate(ops):
        by_tid[o.tid].append(i)
    for idx in by_tid.values():
        idx.sort(key=lambda i: (ops[i].start, -ops[i].end))
        stack: list = []
        for i in idx:
            while stack and ops[stack[-1]].end <= ops[i].start:
                stack.pop()
            if stack:
                parent[i] = stack[-1]
            stack.append(i)
    return parent


def owner_of(ops: list[Op]):
    """A function giving the span of op ``i``: the innermost of
    :data:`SPANS` enclosing it, where a backward op met on the way out stands for the
    forward op it differentiates.  Forward ops run inside a backward op
    (remat's recompute: they carry sequence numbers of their own) are not
    the backward op's work, so the way out from them passes it by."""
    parent = _parents(ops)
    forward: dict = {}
    for i in sorted(range(len(ops)), key=lambda i: ops[i].start):
        o = ops[i]
        if o.seq >= 0 and o.fwd == 0:
            forward.setdefault((o.tid, o.seq), i)
    wanted = set(SPANS)
    memo: dict = {}

    def owner(i: int):
        if i in memo:
            return memo[i]
        j, in_forward, hops = i, False, 0
        found = None
        while j >= 0 and hops <= len(ops):
            hops += 1
            o = ops[j]
            if o.name in wanted:
                found = o.name
                break
            if o.seq >= 0 and o.fwd != 0 and not in_forward:
                f = forward.get((o.fwd, o.seq), -1)
                if f >= 0:
                    j, in_forward = f, True
                    continue
            in_forward = in_forward or (o.seq >= 0 and o.fwd == 0)
            j = parent[j]
        memo[i] = found
        return found
    return owner


def _union(intervals) -> list:
    return devtrace._union([(a, b) for a, b in intervals if b > a])


def _overlap(a: list, b: list) -> int:
    """Nanoseconds covered by both unions ``a`` and ``b`` (sorted,
    disjoint)."""
    i = j = 0
    total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def reduce(ops: list[Op], dev: list[Dev], window: tuple[int, int],
           drains=()) -> dict:
    """The window's seconds by span: ``device_s`` (:data:`NONE` holds what
    no span launched), ``host_s`` and ``count`` of each of :data:`SPANS`; the
    device's busy seconds; and, for ``drains`` (``(begin, device_begin,
    device_end, end, events)`` on the trace's clock), those that overlap
    the window, as seconds from its start, and ``drain_idle_s``: the
    window's seconds with the device idle and a drain open."""
    w0, w1 = window
    owner = owner_of(ops)
    # the launching ops: torch ops, not the runtime calls (whose ids come
    # from another counter)
    by_corr = {o.corr: i for i, o in enumerate(ops)
               if o.corr and not o.name.startswith(RUNTIME)}
    device_s: dict = collections.defaultdict(float)
    clipped = sorted((max(d.start, w0), min(d.end, w1), d.link) for d in dev
                     if d.end > w0 and d.start < w1)
    edge = w0
    for a, b, link in clipped:
        a = max(a, edge)
        if b > a:
            i = by_corr.get(link, -1) if link else -1
            device_s[owner(i) if i >= 0 else None] += (b - a) * 1e-9
            edge = b
    host_s: dict = {n: 0.0 for n in SPANS}
    count: dict = {n: 0 for n in SPANS}
    for o in ops:
        if o.name in host_s and o.end > w0 and o.start < w1:
            host_s[o.name] += (min(o.end, w1) - max(o.start, w0)) * 1e-9
            count[o.name] += 1
    busy = _union((a, b) for a, b, _ in clipped)
    idle = []
    edge = w0
    for a, b in busy:
        if a > edge:
            idle.append([edge, a])
        edge = max(edge, b)
    if edge < w1:
        idle.append([edge, w1])
    kept = [d for d in drains if d[3] > w0 and d[0] < w1]
    open_ = _union((max(d[0], w0), min(d[3], w1)) for d in kept)

    def rel(t):
        return None if t is None else (t - w0) * 1e-9
    return {"device_s": {k or NONE: v for k, v in device_s.items()},
            "host_s": host_s, "count": count,
            "busy_s": sum(b - a for a, b in busy) * 1e-9,
            "window_s": (w1 - w0) * 1e-9,
            "drains": [[rel(d[0]), rel(d[1]), rel(d[2]), rel(d[3]), d[4]]
                       for d in kept],
            "drain_idle_s": _overlap(idle, open_) * 1e-9}


def reduce_profile(prof, clock=None, drains=None) -> dict:
    """:func:`reduce` over a profiler run's window (``devtrace.WINDOW``),
    with ``drains`` (a tracer's drain record, on GAPP's clock) mapped
    onto the trace's clock by ``clock`` (left out without one)."""
    ops, dev = events(prof)
    win = next((o for o in ops if o.name == devtrace.WINDOW), None)
    if win is None:
        raise RuntimeError("the trace holds no window span")
    mapped = []
    if clock is not None:
        for b, db, de, e, n in drains or ():
            mapped.append((clock(b), None if db is None else clock(db),
                           None if de is None else clock(de), clock(e), n))
    return reduce(ops, dev, (win.start, win.end), mapped)


class Tracing(devtrace.Tracing):
    """``devtrace.Tracing``, with GAPP's clock anchored at the profiler's
    start and stop, and the summary's ``spans`` from
    :func:`reduce_profile`.  ``drains`` is a dict whose ``record`` the
    caller sets to the session's drain record before the summary is
    taken."""

    def __init__(self, on: bool, device, drains: dict):
        super().__init__(on, device)
        self.drains = drains
        self.anchors: list = []

    @staticmethod
    def _anchor():
        try:
            from repro_torch.spans import anchor
        except ImportError:       # a program without its own spans
            return None
        return anchor()

    def open(self) -> None:
        if self.on:
            self.anchors = [self._anchor()]
        super().open()

    def close(self) -> None:
        super().close()
        if self.on and len(self.anchors) == 1:
            self.anchors.append(self._anchor())

    def clock(self):
        """The anchors' map from GAPP's clock to the trace's, or None."""
        if len(self.anchors) != 2 or None in self.anchors:
            return None
        from repro_torch.spans import ClockMap
        return ClockMap(*self.anchors)

    def summary(self) -> dict | None:
        out = super().summary()
        if out is not None:
            cmap = self.clock()
            out["spans"] = reduce_profile(self.prof, cmap,
                                          self.drains.get("record"))
            if cmap is not None:
                out["spans"]["clock_drift_ns"] = cmap.drift_ns
        return out
