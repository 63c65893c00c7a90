"""Columnar timeslice IR — the interchange type of the offline pipeline.

Everything downstream of the CMetric fold (critical-slice extraction, sample
attachment, call-path merging, ranking) used to traffic in ``list[CriticalSlice]``
Python objects, which made the accelerated fold feed a host-side per-slice
loop — exactly the serialization pathology the paper profiles.  The types
here replace that with aligned struct-of-arrays:

* :class:`SliceTable` — S aligned columns describing completed timeslices
  (worker, start_ns, end_ns, cm, threads_av, stack_id, n_at_exit).  This is
  what the CMetric backends emit and what the detector consumes; every
  pipeline stage over it is a numpy/JAX array op.
* :class:`CriticalTable` — a :class:`SliceTable` filtered by the criticality
  threshold, remembering the ``n_min`` that produced it.
* :class:`CriticalBuffer` — amortized-O(1) growable columnar buffer used by
  the live tracer (the online analogue: slices are appended one at a time as
  the probe fires, but the stored form is already columnar so ``.table()``
  is a copy-free-ish view, not a conversion loop).
* :class:`CriticalSlice` — the legacy per-slice record, kept as the row view
  (``table[i]``) and for the retained Python-loop oracle in the detector.

Times are absolute nanoseconds on the source log's clock so samples (which
carry ns timestamps) attach without rebasing; CMetrics are seconds.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator, Sequence

import numpy as np


@dataclasses.dataclass
class CriticalSlice:
    """Row view of one completed timeslice (legacy / oracle representation)."""

    worker: int
    start_ns: int
    end_ns: int
    cm: float            # seconds
    threads_av: float
    stack_id: int
    n_at_exit: int       # instantaneous active count at switch-out


_COLUMNS = ("worker", "start_ns", "end_ns", "cm", "threads_av", "stack_id",
            "n_at_exit")
_DTYPES = (np.int32, np.int64, np.int64, np.float64, np.float64, np.int32,
           np.int32)


@dataclasses.dataclass
class SliceTable:
    """Aligned columns, one row per completed timeslice (time-ordered by
    slice end, the order DEACTIVATE events fire)."""

    worker: np.ndarray      # int32[S]
    start_ns: np.ndarray    # int64[S] absolute ns
    end_ns: np.ndarray      # int64[S]
    cm: np.ndarray          # float64[S] seconds
    threads_av: np.ndarray  # float64[S]
    stack_id: np.ndarray    # int32[S] interned call-path id (or -1)
    n_at_exit: np.ndarray   # int32[S]

    # -- construction --------------------------------------------------------
    @classmethod
    def empty(cls) -> "SliceTable":
        return cls(*[np.zeros(0, dt) for dt in _DTYPES])

    @classmethod
    def from_arrays(cls, worker, start_ns, end_ns, cm, threads_av, stack_id,
                    n_at_exit) -> "SliceTable":
        cols = (worker, start_ns, end_ns, cm, threads_av, stack_id, n_at_exit)
        return cls(*[np.asarray(c, dt) for c, dt in zip(cols, _DTYPES)])

    @classmethod
    def from_records(cls, records: Iterable[CriticalSlice]) -> "SliceTable":
        rows = list(records)
        if not rows:
            return cls.empty()
        return cls.from_arrays(
            [r.worker for r in rows], [r.start_ns for r in rows],
            [r.end_ns for r in rows], [r.cm for r in rows],
            [r.threads_av for r in rows], [r.stack_id for r in rows],
            [r.n_at_exit for r in rows])

    @classmethod
    def concat(cls, tables: Sequence["SliceTable"]) -> "SliceTable":
        if not tables:
            return cls.empty()
        return cls(*[np.concatenate([getattr(t, c) for t in tables])
                     for c in _COLUMNS])

    # -- views ---------------------------------------------------------------
    def __len__(self) -> int:
        return int(self.worker.shape[0])

    def row(self, i: int) -> CriticalSlice:
        return CriticalSlice(
            worker=int(self.worker[i]), start_ns=int(self.start_ns[i]),
            end_ns=int(self.end_ns[i]), cm=float(self.cm[i]),
            threads_av=float(self.threads_av[i]),
            stack_id=int(self.stack_id[i]), n_at_exit=int(self.n_at_exit[i]))

    def __getitem__(self, i):
        if isinstance(i, (int, np.integer)):
            return self.row(int(i))
        return SliceTable(*[getattr(self, c)[i] for c in _COLUMNS])

    def __iter__(self) -> Iterator[CriticalSlice]:
        for i in range(len(self)):
            yield self.row(i)

    def to_records(self) -> list[CriticalSlice]:
        return list(self)

    def filter(self, mask: np.ndarray) -> "SliceTable":
        return SliceTable(*[getattr(self, c)[mask] for c in _COLUMNS])

    @property
    def duration_ns(self) -> np.ndarray:
        return self.end_ns - self.start_ns

    def critical(self, n_min: float) -> "CriticalTable":
        """Rows under the criticality threshold (paper §4.2 trigger)."""
        mask = self.threads_av < n_min
        return CriticalTable(*[getattr(self, c)[mask] for c in _COLUMNS],
                             n_min=float(n_min))

    def validate(self) -> None:
        s = len(self)
        for c, dt in zip(_COLUMNS, _DTYPES):
            col = getattr(self, c)
            if col.shape != (s,):
                raise ValueError(f"column {c} misaligned: {col.shape}")
        if s and np.any(self.end_ns < self.start_ns):
            raise ValueError("slice ends before it starts")


@dataclasses.dataclass
class CriticalTable(SliceTable):
    """A :class:`SliceTable` filtered by ``threads_av < n_min``."""

    n_min: float = float("nan")


class CriticalBuffer:
    """Growable columnar buffer of critical slices (online tracer storage).

    Append is amortized O(1) into doubling numpy arrays; ``table()`` exposes
    the filled prefix as a :class:`SliceTable` without a per-row conversion.
    Row access (``buf[i]``) and iteration yield :class:`CriticalSlice` views
    so legacy consumers (chrome-trace overlay, tests) keep working.
    """

    def __init__(self, capacity: int = 1024):
        self._cap = max(int(capacity), 1)
        self._cols = [np.zeros(self._cap, dt) for dt in _DTYPES]
        self._len = 0

    def __len__(self) -> int:
        return self._len

    def _grow(self) -> None:
        self._cap *= 2
        self._cols = [np.concatenate([c, np.zeros(len(c), c.dtype)])
                      for c in self._cols]

    def append(self, worker: int, start_ns: int, end_ns: int, cm: float,
               threads_av: float, stack_id: int, n_at_exit: int) -> None:
        if self._len == self._cap:
            self._grow()
        i = self._len
        vals = (worker, start_ns, end_ns, cm, threads_av, stack_id, n_at_exit)
        for col, v in zip(self._cols, vals):
            col[i] = v
        self._len = i + 1

    def extend_table(self, table: SliceTable,
                     mask: np.ndarray | None = None) -> None:
        """Bulk-append ``table`` rows (optionally only where ``mask``) —
        one vectorised copy per column, used by the tracer's batched flush
        instead of a per-slice Python loop."""
        src = table.filter(mask) if mask is not None else table
        s = len(src)
        if s == 0:
            return
        while self._len + s > self._cap:
            self._grow()
        lo = self._len
        for col, name in zip(self._cols, _COLUMNS):
            col[lo:lo + s] = getattr(src, name)
        self._len = lo + s

    @property
    def nbytes(self) -> int:
        return sum(c.nbytes for c in self._cols)

    def table(self) -> SliceTable:
        # snapshot length and column list once: a concurrent append (live
        # tracer threads) past this point can't misalign the returned view,
        # since rows below the snapshot are fully written before _len moves
        n = self._len
        cols = self._cols
        return SliceTable(*[c[:n] for c in cols])

    def __getitem__(self, i):
        if isinstance(i, (int, np.integer)):
            idx = int(i)
            if idx < 0:
                idx += self._len
            if not 0 <= idx < self._len:
                raise IndexError(i)
            return self.table().row(idx)
        return self.table()[i]

    def __iter__(self) -> Iterator[CriticalSlice]:
        return iter(self.table())
