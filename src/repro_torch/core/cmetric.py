"""Criticality Metric (CMetric) — the paper's §2/§4.1 algorithm.

Time is split into *switching intervals* ``T_i`` delimited by any worker
state-change event; every worker active during interval ``i`` earns
``T_i / n_i`` where ``n_i`` is the number of active workers.  A worker's
timeslice CMetric is recovered in O(1) per event with a running prefix
``global_cm`` and a per-worker snapshot ``local_cm`` (the paper's eBPF-map
trick)::

    global_cm        += (t - t_switch) / thread_count       # every event
    cm_hash[w]       += global_cm - local_cm[w]             # on switch-out
    local_cm[w]       = global_cm                           # on switch-in

Three implementations, equivalent up to float tolerance, registered in the
:mod:`repro_torch.core.backends` registry:

* ``numpy``  — :func:`compute_numpy`, float64 oracle (reference for all).
* ``vector`` — :func:`compute_vectorized`, beyond-paper data-parallel
  formulation in torch (cumsum + stable-sort pairing + index_add) on the
  default device.  O(E log E) work but fully parallel.
* ``fused``  — the vector pipeline with the interval fold swapped for the
  CUDA ``cmetric_fold`` kernel; fold, pairing and aggregation run on the
  device with no host round-trip between stages.  It is also registered as
  ``pallas``, the name of its counterpart in the JAX package.

The JAX package's ``stream`` backend (an event-at-a-time ``lax.scan``) has
no counterpart yet; :func:`_prefix_f32_seq` is kept for it.

All backends emit a :class:`~repro_torch.core.slices.SliceTable`;
:class:`CMetricResult` is a thin wrapper over it.

Each backend also registers a **carry-resumable chunk fold**:
``fold_chunk(carry, chunk) -> (carry, SliceTable)`` advances a
:class:`FoldCarry` — exactly the paper's Table-1 eBPF-map state — over one
batch of events.  Replaying *any* partition of a log reproduces the
whole-log result (bit-equal float64 for ``numpy``, float32 tolerance for
the device backends), which is what lets the live tracer maintain its
online state by batches and ``detect_offline(chunk_events=...)`` stream
unbounded logs in bounded memory.

Degenerate timeslices (``slice_cm == 0``) fall back to
``threads_av = max(n_at_exit, 1)`` — the instantaneous active count at
switch-out, including the exiting worker — in *every* backend (the numpy
oracle's semantics; the vector/fused paths used to hardcode 1.0, which
could flip criticality between backends).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.core import backends as backends_lib
from repro_torch.core.backends import register_backend
from repro_torch.core.events import ACTIVATE, DEACTIVATE, EventLog
from repro_torch.core.slices import CriticalTable, SliceTable


@dataclasses.dataclass
class CMetricResult:
    """Per-worker totals plus the per-timeslice table.

    ``table`` holds one row per completed timeslice (one per DEACTIVATE
    event), in absolute ns on the source log's clock; ``t0_ns`` is the log
    epoch so the legacy rebased-seconds views (``slice_start`` …) stay
    available as properties.  ``threads_av`` is the harmonic weighted
    average parallelism ``(end-start)/slice_cm`` (== n when parallelism is
    constant over the slice); the stack-trace trigger is
    ``threads_av < n_min`` (paper §4.2).
    """

    per_worker: np.ndarray        # float64[W] cumulative CMetric (cm_hash)
    table: SliceTable             # S rows, aligned columns (ns domain)
    t0_ns: int                    # log epoch for the seconds-domain views
    idle_time: float              # total time with zero active workers
    total_time: float             # t_last - t_first

    # -- legacy rebased-seconds views ---------------------------------------
    @property
    def slice_worker(self) -> np.ndarray:
        return self.table.worker

    @property
    def slice_start(self) -> np.ndarray:
        return (self.table.start_ns - self.t0_ns) * 1e-9

    @property
    def slice_end(self) -> np.ndarray:
        return (self.table.end_ns - self.t0_ns) * 1e-9

    @property
    def slice_cm(self) -> np.ndarray:
        return self.table.cm

    @property
    def slice_threads_av(self) -> np.ndarray:
        return self.table.threads_av

    @property
    def slice_stack(self) -> np.ndarray:
        return self.table.stack_id

    @property
    def num_slices(self) -> int:
        return len(self.table)

    def critical_mask(self, n_min: float) -> np.ndarray:
        return self.table.threads_av < n_min

    def critical_table(self, n_min: float) -> CriticalTable:
        return self.table.critical(n_min)


def _empty_result(num_workers: int) -> CMetricResult:
    return CMetricResult(np.zeros(num_workers), SliceTable.empty(), 0, 0.0,
                         0.0)


def _make_result(log: EventLog, per_worker, worker, start_s, end_s, cm,
                 threads_av, stack, n_at_exit, idle, total) -> CMetricResult:
    """Assemble a result from rebased-seconds slice columns (backend output
    domain), converting times back to the log's ns clock."""
    t0 = int(log.times[0]) if len(log) else 0
    table = SliceTable.from_arrays(
        worker=np.asarray(worker, np.int32),
        start_ns=t0 + np.round(np.asarray(start_s, np.float64)
                               * 1e9).astype(np.int64),
        end_ns=t0 + np.round(np.asarray(end_s, np.float64)
                             * 1e9).astype(np.int64),
        cm=np.asarray(cm, np.float64),
        threads_av=np.asarray(threads_av, np.float64),
        stack_id=np.asarray(stack, np.int32),
        n_at_exit=np.asarray(n_at_exit, np.int32),
    )
    return CMetricResult(per_worker=np.asarray(per_worker, np.float64),
                         table=table, t0_ns=t0, idle_time=float(idle),
                         total_time=float(total))


# ---------------------------------------------------------------------------
# numpy oracle
# ---------------------------------------------------------------------------

def compute_numpy(log: EventLog) -> CMetricResult:
    """float64 reference implementation (event-at-a-time, like the kernel probe)."""
    e = len(log)
    if e == 0:
        return _empty_result(log.num_workers)
    t = log.slice_seconds()
    w = log.workers
    d = log.deltas
    gcm = 0.0
    idle = 0.0
    count = 0
    local = np.zeros(log.num_workers)
    start = np.zeros(log.num_workers)
    cm = np.zeros(log.num_workers)
    sw, ss, se, sc, sa, sk, sn = [], [], [], [], [], [], []
    t_prev = t[0]
    for i in range(e):
        dt = t[i] - t_prev
        if count > 0:
            gcm += dt / count
        else:
            idle += dt
        t_prev = t[i]
        wi = int(w[i])
        if d[i] == ACTIVATE:
            local[wi] = gcm
            start[wi] = t[i]
            count += 1
        else:
            slice_cm = gcm - local[wi]
            cm[wi] += slice_cm
            dur = t[i] - start[wi]
            sw.append(wi)
            ss.append(start[wi])
            se.append(t[i])
            sc.append(slice_cm)
            sa.append(dur / slice_cm if slice_cm > 0 else float(max(count, 1)))
            sk.append(int(log.stacks[i]))
            sn.append(count)                 # n_at_exit: before the decrement
            count -= 1
    return _make_result(log, cm, sw, ss, se, sc, sa, sk, sn, idle,
                        t[-1] - t[0])


# ---------------------------------------------------------------------------
# vectorised (beyond-paper) formulation, in torch on the device
# ---------------------------------------------------------------------------

def _fold_interval_terms(times_s, deltas):
    """Active counts, interval contributions and the global_cm prefix.

    Returns ``(n, contrib, gcm, idle)``: ``n[i]`` is the active count after
    event ``i`` (length E; ``n[:-1]`` describes interval ``[t_i, t_{i+1})``),
    ``contrib[i]`` the interval's share of global_cm (length E-1) and
    ``gcm[e]`` the value of global_cm when event ``e`` fires (length E).
    This is the part the ``cmetric_fold`` kernel implements on the card.
    """
    dt = times_s[1:] - times_s[:-1]
    n = torch.cumsum(deltas, 0, dtype=torch.int32)
    ni = n[:-1]                                      # active during interval i
    zero = torch.zeros_like(dt)
    contrib = torch.where(ni > 0, dt / torch.clamp(ni, min=1), zero)
    gcm = torch.cat([contrib.new_zeros(1), torch.cumsum(contrib, 0)])
    idle = torch.sum(torch.where(ni > 0, zero, dt))
    return n, contrib, gcm, idle


def _pair_core(times_s, workers, n, gcm, idle, num_workers: int):
    """Pairing + aggregation stage shared by the vectorised and fused
    backends: ``n`` is the active count after each event and ``gcm`` the
    global_cm prefix (one entry per event each)."""
    e = times_s.shape[0]
    # Stable grouping by worker: within a group events alternate IN/OUT, so
    # consecutive (even, odd) positions form a timeslice.
    ws, perm = torch.sort(workers, stable=True)
    idx = torch.arange(e, device=times_s.device)
    boundary = torch.ones(e, dtype=torch.bool, device=times_s.device)
    boundary[1:] = ws[1:] != ws[:-1]
    group_first = torch.cummax(torch.where(boundary, idx, 0), 0).values
    pos = idx - group_first
    is_out_pos = pos % 2 == 1
    prev_global = perm[torch.clamp(idx - 1, min=0)]  # matching ACTIVATE event
    out_global = perm
    slice_cm = gcm[out_global] - gcm[prev_global]
    s_start = times_s[prev_global]
    s_end = times_s[out_global]
    dur = s_end - s_start
    # active count at the out event, including the exiting worker (numpy
    # oracle semantics for the zero-CMetric fallback)
    n_exit = n[out_global] + 1
    threads_av = torch.where(slice_cm > 0,
                             dur / torch.clamp(slice_cm, min=1e-30),
                             torch.clamp(n_exit, min=1).to(s_start.dtype))
    valid = is_out_pos
    per_worker = torch.zeros(num_workers, dtype=slice_cm.dtype,
                             device=times_s.device)
    per_worker.index_add_(0, ws, torch.where(valid, slice_cm,
                                             torch.zeros_like(slice_cm)))
    return (per_worker, idle, valid, ws, s_start, s_end, slice_cm, threads_av,
            n_exit, out_global)


def _vector_pipeline(times_s, workers, deltas, num_workers: int):
    n, _, gcm, idle = _fold_interval_terms(times_s, deltas)
    return _pair_core(times_s, workers, n, gcm, idle, num_workers)


def _result_from_pairing(log: EventLog, t, outs) -> CMetricResult:
    (per_worker, idle, valid, ws, s_start, s_end, s_cm, s_av, s_n,
     out_global) = outs
    # keep the slices and restore time order on the device; only the
    # finished columns cross to the host
    out_sorted, order = torch.sort(out_global[valid])
    sel = lambda x: x[valid][order].cpu().numpy()  # noqa: E731
    out_eo = out_sorted.cpu().numpy()
    return _make_result(log, per_worker.cpu().numpy(), sel(ws), sel(s_start),
                        sel(s_end), sel(s_cm), sel(s_av), log.stacks[out_eo],
                        sel(s_n), float(idle), float(t[-1] - t[0]))


def drive_pairing(log: EventLog, pipeline) -> CMetricResult:
    """Shared host driver for pairing-based backends: move the log to the
    default device, run ``pipeline(t, workers, deltas, num_workers)``
    returning :func:`_pair_core` outputs, and materialise the result
    table."""
    if len(log) == 0:
        return _empty_result(log.num_workers)
    dev = device_lib.resolve()
    t = torch.from_numpy(log.slice_seconds().astype(np.float32)).to(dev)
    workers = torch.from_numpy(np.ascontiguousarray(log.workers, np.int32))
    deltas = torch.from_numpy(np.ascontiguousarray(log.deltas))
    outs = pipeline(t, workers.to(dev), deltas.to(dev).to(torch.int32),
                    num_workers=log.num_workers)
    return _result_from_pairing(log, t, outs)


def compute_vectorized(log: EventLog) -> CMetricResult:
    """Data-parallel CMetric (sort + scans + index_add) in torch on the
    default device.  Same results as :func:`compute_numpy` up to float32
    tolerance; the pairing core is shared with the fused backend (which
    swaps in the fold kernel's gcm prefix)."""
    return drive_pairing(log, _vector_pipeline)


def _compute_fused(log: EventLog) -> CMetricResult:
    # Lazy import: avoids a module-level import cycle with the kernels.
    from repro_torch.kernels import ops
    return ops.compute_fused(log)


# ---------------------------------------------------------------------------
# carry-resumable chunked fold
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FoldCarry:
    """The paper's Table-1 eBPF-map state, as the carry of a chunked fold.

    ``fold_chunk(carry, chunk)`` advances this state by one batch of events
    and emits the batch's completed timeslices; replaying any partition of a
    log through it reproduces the whole-log result — bit-equal to
    :func:`compute_numpy` for the float64 ``numpy`` chunk backend (every
    accumulation is kept strictly sequential: ``np.add.accumulate`` seeded
    with the carried scalar, ``np.add.at`` into the carried per-worker
    hash), within float32 tolerance for the device backends.

    Fields mirror the eBPF maps: ``global_cm`` (running Σ T_i/n_i), ``idle``
    (time with zero active workers), ``thread_count``, per-worker
    ``local_cm``/``slice_start`` snapshots taken at switch-in, the ``open``
    mask (which workers are mid-timeslice at the chunk boundary),
    ``cm_hash`` (cumulative per-worker CMetric), and the clock state
    ``t0_ns`` (stream epoch) / ``t_switch_s`` (rebased time of the previous
    event, the paper's ``t_switch``).
    """

    num_workers: int
    t0_ns: int | None = None
    t_last_ns: int | None = None
    t_switch_s: float = 0.0
    global_cm: float = 0.0
    idle: float = 0.0
    thread_count: int = 0
    local_cm: np.ndarray = None
    slice_start: np.ndarray = None
    open: np.ndarray = None
    cm_hash: np.ndarray = None
    events: int = 0
    slices: int = 0

    def __post_init__(self):
        w = self.num_workers
        if self.local_cm is None:
            self.local_cm = np.zeros(w)
        if self.slice_start is None:
            self.slice_start = np.zeros(w)
        if self.open is None:
            self.open = np.zeros(w, bool)
        if self.cm_hash is None:
            self.cm_hash = np.zeros(w)

    @classmethod
    def init(cls, num_workers: int) -> "FoldCarry":
        return cls(num_workers=num_workers)

    def ensure_workers(self, num_workers: int) -> None:
        """Grow the per-worker maps (workers may register mid-stream)."""
        w = self.num_workers
        if num_workers <= w:
            return
        pad = num_workers - w
        self.local_cm = np.concatenate([self.local_cm, np.zeros(pad)])
        self.slice_start = np.concatenate([self.slice_start, np.zeros(pad)])
        self.open = np.concatenate([self.open, np.zeros(pad, bool)])
        self.cm_hash = np.concatenate([self.cm_hash, np.zeros(pad)])
        self.num_workers = num_workers

    @property
    def total_time(self) -> float:
        return self.t_switch_s

    @property
    def per_worker(self) -> np.ndarray:
        return self.cm_hash

    def per_worker_padded(self, num_workers: int) -> np.ndarray:
        """A copy of ``cm_hash`` padded/truncated to ``num_workers`` — the
        per-worker CMetric view consumers read while workers may still be
        registering (the carry only grows at fold time)."""
        out = np.zeros(num_workers)
        n = min(num_workers, self.cm_hash.shape[0])
        out[:n] = self.cm_hash[:n]
        return out

    def state(self) -> dict:
        """Consistent copy of the aggregate state for incremental reports
        (what :meth:`ProfileSession.snapshot` reads mid-stream; take it
        under the fold lock so totals and per-worker rows agree)."""
        return {
            "per_worker": self.cm_hash.copy(),
            "idle_time": self.idle,
            "total_time": self.total_time,
            "events": self.events,
            "slices": self.slices,
        }


def _prefix_exact(carry: FoldCarry, contrib, idle_contrib):
    """Strictly sequential float64 prefix — bit-equal to the numpy oracle's
    ``gcm += dt / count`` loop (``np.add.accumulate`` is left-to-right)."""
    g = np.add.accumulate(np.concatenate(([carry.global_cm], contrib)))[1:]
    idle = np.add.accumulate(
        np.concatenate(([carry.idle], idle_contrib)))[-1]
    return g, float(idle)


def _prefix_f32_seq(carry: FoldCarry, contrib, idle_contrib):
    """Sequential float32 prefix (the streaming scan's arithmetic)."""
    g = np.add.accumulate(np.concatenate(
        ([carry.global_cm], contrib)).astype(np.float32))[1:]
    idle = np.add.accumulate(np.concatenate(
        ([carry.idle], idle_contrib)).astype(np.float32))[-1]
    return g.astype(np.float64), float(idle)


def _prefix_vector(carry: FoldCarry, contrib, idle_contrib):
    """Data-parallel float32 prefix (torch cumsum on the default device)."""
    dev = device_lib.resolve()
    c = torch.from_numpy(np.asarray(contrib, np.float32)).to(dev)
    i = torch.from_numpy(np.asarray(idle_contrib, np.float32)).to(dev)
    g0 = torch.tensor(carry.global_cm, dtype=torch.float32, device=dev)
    i0 = torch.tensor(carry.idle, dtype=torch.float32, device=dev)
    g = g0 + torch.cumsum(c, 0)
    return g.cpu().numpy().astype(np.float64), float(i0 + torch.sum(i))


def _prefix_fused(carry: FoldCarry, contrib, idle_contrib):
    # Lazy import as for _compute_fused.
    from repro_torch.kernels import ops
    return ops.fold_chunk_prefix(carry.global_cm, carry.idle, contrib,
                                 idle_contrib)


def _fold_chunk(carry: FoldCarry, log: EventLog, prefix) -> tuple[
        FoldCarry, SliceTable]:
    """Advance ``carry`` over one time-sorted, sanitized chunk.

    The chunk must be consistent with ``carry.open`` (use
    :func:`repro_torch.core.events.sanitize_chunk` on dirty streams first) and
    start at or after ``carry.t_last_ns``.  Returns the same carry object,
    updated, plus one :class:`SliceTable` row per DEACTIVATE in the chunk
    (in event order, like every backend).
    """
    carry.ensure_workers(log.num_workers)
    e = len(log)
    if e == 0:
        return carry, SliceTable.empty()
    if carry.t0_ns is None:
        carry.t0_ns = int(log.times[0])
        carry.t_last_ns = carry.t0_ns      # first dt is 0, like the oracle
    t = (log.times - carry.t0_ns).astype(np.float64) * 1e-9
    w = log.workers
    d = log.deltas
    dt = np.empty(e, np.float64)
    dt[0] = t[0] - carry.t_switch_s
    dt[1:] = t[1:] - t[:-1]
    d64 = d.astype(np.int64)
    n_before = carry.thread_count + np.cumsum(d64) - d64
    pos_mask = n_before > 0
    contrib = np.where(pos_mask, dt / np.maximum(n_before, 1), 0.0)
    idle_contrib = np.where(pos_mask, 0.0, dt)
    g, idle_end = prefix(carry, contrib, idle_contrib)

    # -- pairing: each DEACTIVATE matches the previous event of its worker
    # group (alternation holds within a sanitized chunk) or the carry.
    idx = np.arange(e)
    order = np.argsort(w, kind="stable")
    ws = w[order]
    ds = d[order]
    firstg = np.concatenate([[True], ws[1:] != ws[:-1]])
    grp_first = np.maximum.accumulate(np.where(firstg, idx, 0))
    pos = idx - grp_first
    out_sorted = ds == DEACTIVATE
    out_global = order[out_sorted]
    has_prev = (pos > 0)[out_sorted]
    prev_global = order[np.maximum(idx - 1, 0)][out_sorted]
    w_out = ws[out_sorted]
    local = np.where(has_prev, g[prev_global], carry.local_cm[w_out])
    start_s = np.where(has_prev, t[prev_global],
                       carry.slice_start[w_out])
    slice_cm = g[out_global] - local
    end_s = t[out_global]
    dur = end_s - start_s
    n_exit = n_before[out_global]          # includes the exiting worker
    threads_av = np.where(
        slice_cm > 0, dur / np.where(slice_cm > 0, slice_cm, 1.0),
        np.maximum(n_exit, 1).astype(np.float64))

    # restore event (time) order, the order every backend emits slices in
    ord2 = np.argsort(out_global, kind="stable")
    w_out = w_out[ord2]
    out_eo = out_global[ord2]
    slice_cm = slice_cm[ord2]
    # sequential per-worker accumulation into the carried hash — the exact
    # order the oracle's ``cm[wi] += slice_cm`` runs in
    np.add.at(carry.cm_hash, w_out, slice_cm)
    table = SliceTable.from_arrays(
        worker=w_out,
        start_ns=carry.t0_ns + np.round(
            start_s[ord2] * 1e9).astype(np.int64),
        end_ns=carry.t0_ns + np.round(end_s[ord2] * 1e9).astype(np.int64),
        cm=slice_cm,
        threads_av=threads_av[ord2],
        stack_id=log.stacks[out_eo],
        n_at_exit=n_exit[ord2],
    )

    # -- carry update: per-worker last event decides the open snapshot
    lastg = np.concatenate([ws[1:] != ws[:-1], [True]])
    wl = ws[lastg]
    dl = ds[lastg]
    li = order[lastg]
    act = dl == ACTIVATE
    carry.local_cm[wl[act]] = g[li[act]]
    carry.slice_start[wl[act]] = t[li[act]]
    carry.open[wl] = act
    carry.thread_count += int(d64.sum())
    carry.global_cm = float(g[-1])
    carry.idle = idle_end
    carry.t_switch_s = float(t[-1])
    carry.t_last_ns = int(log.times[-1])
    carry.events += e
    carry.slices += int(len(table))
    return carry, table


def fold_chunk(carry: FoldCarry, log: EventLog,
               backend: str = "numpy") -> tuple[FoldCarry, SliceTable]:
    """Dispatch one chunk through the named backend's chunk fold."""
    return backends_lib.fold_chunk(carry, log, backend=backend)


def _make_fold_chunk(prefix):
    return functools.partial(_fold_chunk, prefix=prefix)


register_backend("numpy", compute_numpy,
                 capabilities={"oracle", "float64", "exact"},
                 fold_chunk=_make_fold_chunk(_prefix_exact))
register_backend("vector", compute_vectorized,
                 capabilities={"device", "parallel"},
                 fold_chunk=_make_fold_chunk(_prefix_vector))
# The fused backend stands in for the JAX package's "pallas" backend; the
# alias keeps that name working where callers pass it as a string.
for _name in ("fused", "pallas"):
    register_backend(_name, _compute_fused,
                     capabilities={"device", "parallel", "fused", "gpu"},
                     fold_chunk=_make_fold_chunk(_prefix_fused))


def compute(log: EventLog, backend: str = "fused", *,
            device=None) -> CMetricResult:
    """Dispatch through the :mod:`repro_torch.core.backends` registry, on
    ``device`` (default: :func:`repro_torch.device.default_device`)."""
    with device_lib.use_device(device):
        return backends_lib.compute(log, backend=backend)
