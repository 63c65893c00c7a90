"""The port's own spans, on the clock of ``torch.profiler``'s trace.

:func:`span` names a stretch of host code for ``torch.profiler``.  While a
profiler records on the calling thread it enters a profiler range: a CPU
op in the trace that encloses the ops, and so the kernel launches, made
inside it.  Otherwise it returns one shared no-op context, for the cost
of one flag read.  The range is the fast record-function, which the
profiler does not mirror onto the device's timeline as it mirrors a
``record_function`` (a user annotation), so a span adds no event that
looks like device work.  The spans, each read by a metric of the
benchmark (``gappbench/``):

========================  ==============================================
``serve/submit``          :meth:`repro_torch.serve.engine.Engine.submit`
``serve/step.issue``      the model call in ``Engine.step``
``train/loader_wait``     the loader's ``get`` in ``Trainer.run``
``train/step.issue``      the step function's call in ``Trainer.run``
``model/attention``       each attention call of a block (forward,
                          decode, and remat's recompute, which re-enters
                          it)
``optim/adamw``           :func:`repro_torch.optim.adamw.update`
========================  ==============================================

A profiler records only on the threads that existed or were started
with it, and GAPP's drain thread is not one of them.  So a drain is
recorded by the program itself, on GAPP's clock (``time.perf_counter_ns``
by default): :class:`DeviceSegment` is the stretch of one drain from the
first upload of its fold's prefix to the end of its last read-back, which
:func:`on_device` marks.  The profiler stamps its events on the Unix-epoch
clock (``time.time_ns``); :class:`ClockMap` maps the one onto the other
between two :func:`anchor` reads taken at a profiling session's start
and stop.

Nothing else in the port picks a clock for the trace or asks whether a
profiler records.
"""
from __future__ import annotations

import contextlib
import contextvars
import time
from typing import Callable, Iterator

import numpy as np
import torch

_recording = torch._C._autograd._profiler_enabled
_Range = torch._C._profiler._RecordFunctionFast
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context naming the enclosed host code ``name`` in a
    ``torch.profiler`` trace; a shared no-op while no profiler records on
    this thread."""
    return _Range(name) if _recording() else _OFF


def anchor() -> tuple[int, int]:
    """One ``(perf_counter_ns, time_ns)`` pair: of 16 brackets
    (``perf_counter_ns``, ``time_ns``, ``perf_counter_ns``), the
    narrowest, its ``time_ns`` against its bracket's middle."""
    best = None
    for _ in range(16):
        a = time.perf_counter_ns()
        w = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, (a + b) // 2, w)
    return best[1], best[2]


class ClockMap:
    """``time.perf_counter_ns`` onto the profiler's clock
    (``time.time_ns``), linear between the anchors ``start`` and ``stop``
    (:func:`anchor`)."""

    def __init__(self, start: tuple[int, int], stop: tuple[int, int]):
        (self.p0, self.w0), (p1, w1) = start, stop
        self.slope = (w1 - self.w0) / (p1 - self.p0)
        #: how far the profiler's clock ran ahead of ``perf_counter_ns``
        #: from ``start`` to ``stop``
        self.drift_ns = (w1 - self.w0) - (p1 - self.p0)

    def __call__(self, t):
        """``t`` (an int or an integer array of ``perf_counter_ns``
        readings) on the profiler's clock, in integer nanoseconds."""
        d = np.asarray(t, np.int64) - self.p0
        out = self.w0 + np.rint(d * self.slope).astype(np.int64)
        return int(out) if out.ndim == 0 else out


_SEGMENT: contextvars.ContextVar["DeviceSegment | None"] = \
    contextvars.ContextVar("repro_torch_device_segment", default=None)


class DeviceSegment:
    """The device round trip of one drain on ``clock``: ``begin`` when the
    first :func:`on_device` stretch inside it started, ``end`` when the
    last one ended (both None if none ran).  Entered, it is the current
    thread's segment until it exits."""

    __slots__ = ("clock", "begin", "end", "_token")

    def __init__(self, clock: Callable[[], int]):
        self.clock = clock
        self.begin: int | None = None
        self.end: int | None = None

    def __enter__(self) -> "DeviceSegment":
        self._token = _SEGMENT.set(self)
        return self

    def __exit__(self, *exc) -> None:
        _SEGMENT.reset(self._token)


@contextlib.contextmanager
def on_device() -> Iterator[None]:
    """Mark the enclosed stretch (an upload, the kernels, the read-back)
    as device work of the current thread's :class:`DeviceSegment`, if
    any."""
    seg = _SEGMENT.get()
    if seg is None:
        yield
        return
    t0 = seg.clock()
    try:
        yield
    finally:
        if seg.begin is None:
            seg.begin = t0
        seg.end = seg.clock()
