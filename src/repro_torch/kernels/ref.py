"""Plain PyTorch versions of the CUDA kernels.

Each one computes what its kernel computes, with ordinary tensor ops.  A
kernel wrapper takes its plain version for tensors on the CPU (the CPU
tests); ``chip_smoke.py`` holds every kernel against its plain version on
the card.  They mirror the JAX package's ``kernels/ref.py`` and the jnp
prefix of ``core/cmetric.py`` (and, for :func:`stream_ref`, its
``lax.scan``), with one deliberate difference: tags outside
``[0, num_bins)`` are dropped by :func:`hist_ref`, as the TPU kernel does,
where the JAX oracle clips them into the last bin.
"""
from __future__ import annotations

import numpy as np
import torch


def _scalar(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def fold_ref(dt, deltas, carry=None):
    """The carry-resumable CMetric interval fold.

    Args:
      dt:     f32[E] interval lengths; ``dt[i] = t[i+1]-t[i]`` (last entry 0).
      deltas: i32[E] +1 activate / -1 deactivate (0 allowed for padding).
      carry:  optional (count, gcm, idle) triple resuming a prior fold.

    Returns ``(n i32[E], gcm f32[E], total_cm, idle, count)``: the active
    count after each event, global_cm when each event fires (exclusive
    prefix), and the f32 scalars whose triple ``(total_cm, idle, count)`` is
    the next call's carry.
    """
    c0, g0, i0 = (0.0, 0.0, 0.0) if carry is None else carry
    n = torch.cumsum(deltas, 0, dtype=torch.int32) + int(c0)
    contrib = torch.where(n > 0, dt / torch.clamp(n, min=1).to(dt.dtype),
                          torch.zeros_like(dt))
    incl = torch.cumsum(contrib, 0)
    g0 = _scalar(g0, dt)
    gcm = g0 + incl - contrib                # exclusive prefix
    idle = _scalar(i0, dt) + torch.sum(
        torch.where((n <= 0) & (dt > 0), dt, torch.zeros_like(dt)))
    return n, gcm, g0 + incl[-1], idle, n[-1].to(torch.float32)


def carry_cumsum_ref(contrib, idle_contrib, carry):
    """Carry-seeded prefix: ``g = gcm0 + inclusive_cumsum(contrib)`` in f32
    and ``idle_end = idle0 + sum(idle_contrib)``; ``carry`` is
    ``(gcm0, idle0)``, taken as f32 before the adds.  Returns ``(g f32[E],
    gcm_end, idle_end)``."""
    g0, i0 = carry
    g = _scalar(g0, contrib) + torch.cumsum(contrib, 0)
    return g, g[-1], _scalar(i0, contrib) + torch.sum(idle_contrib)


def hist_ref(tags, weights, num_bins: int):
    """Counts i32[K] and weighted sums f32[K] of tag ids; tags that are
    negative or ``>= num_bins`` are dropped.  ``weights=None`` weighs every
    sample 1."""
    valid = (tags >= 0) & (tags < num_bins)
    t = tags[valid].to(torch.int64)
    counts = torch.zeros(num_bins, dtype=torch.int32, device=tags.device)
    counts.index_add_(0, t, torch.ones_like(t, dtype=torch.int32))
    w = (torch.ones(t.shape[0], dtype=torch.float32, device=tags.device)
         if weights is None else weights[valid])
    wsum = torch.zeros(num_bins, dtype=torch.float32, device=tags.device)
    wsum.index_add_(0, t, w)
    return counts, wsum


def stream_ref(times_s, workers, deltas, num_workers: int):
    """The streaming CMetric walk in float32: the JAX package's
    ``_streaming_scan``, one step per event.  It runs on the host in numpy
    (``torch.cumsum`` on the CPU accumulates float32 in float64), in
    whole-array operations that round each step to float32 in event
    order: ``np.add.accumulate`` is a strict left-to-right running sum,
    each switch-out takes the state of its worker's last switch-in, and
    ``np.add.at`` adds each worker's slices in event order.  Worker ids
    must lie in ``[0, num_workers)`` (the wrapper checks).  Returns what
    :func:`repro_torch.kernels.stream_scan.stream_scan` returns, as
    tensors on the input's device."""
    f32 = np.float32
    t = times_s.cpu().numpy()
    w = workers.cpu().numpy()
    is_in = deltas.cpu().numpy() > 0
    e = t.shape[0]
    step = np.where(is_in, 1, -1)
    count = np.cumsum(step) - step              # active before each event
    dt = t - np.concatenate([t[:1], t[:-1]])    # the first dt is 0
    active = count > 0
    share = np.where(active, dt / np.maximum(count, 1).astype(f32), f32(0))
    gcm = np.add.accumulate(share, dtype=f32)   # after each event
    idle = np.add.accumulate(np.where(active, f32(0), dt), dtype=f32)[-1]
    # each event's worker's last switch-in at or before it (-1: none)
    order = np.argsort(w, kind="stable")
    pos = np.arange(e)
    first = np.flatnonzero(np.r_[True, w[order][1:] != w[order][:-1]])
    seg_first = np.repeat(first, np.diff(np.r_[first, e]))
    last_in = np.maximum.accumulate(np.where(is_in[order], pos, -1))
    last = np.full(e, -1)
    last[order] = np.where(last_in >= seg_first, order[last_in], -1)
    out = ~is_in
    src = last[out]
    local = np.where(src >= 0, gcm[src], f32(0))
    start = np.where(src >= 0, t[src], f32(0))
    t_out = t[out]
    slice_cm = gcm[out] - local
    dur = t_out - start
    n_at_exit = count[out]
    with np.errstate(over="ignore"):            # the branch not taken
        threads_av = np.where(slice_cm > 0,
                              dur / np.maximum(slice_cm, f32(1e-30)),
                              np.maximum(n_at_exit, 1).astype(f32))
    w_out = w[out].astype(np.int32)
    cm = np.zeros(num_workers, f32)
    np.add.at(cm, w_out, slice_cm)
    dev = times_s.device

    def col(x, dtype):
        return torch.from_numpy(np.ascontiguousarray(x, dtype)).to(dev)

    rows = (col(w_out, np.int32), col(t_out - dur, f32), col(t_out, f32),
            col(slice_cm, f32), col(threads_av, f32),
            col(n_at_exit, np.int32))
    return (col(cm, f32), col(idle, f32).reshape(()),
            col(gcm[-1], f32).reshape(()), rows)


# ---- the stream_scan pipeline's stages ---------------------------------------
#
# Each launch of the stream_scan pipeline has its plain version here, in
# numpy float32 as stream_ref; stream_stages_ref composes them and equals
# stream_ref bit for bit.  Inputs and outputs are tensors, outputs on the
# device of the first input.

def _np(x):
    return x.cpu().numpy()


def _col(x, dtype, like):
    return torch.from_numpy(np.ascontiguousarray(x, dtype)).to(like.device)


def stream_prepass_ref(times_s, deltas):
    """Stage 1: ``(share f32[E], idle f32[E], out_idx i32[S], n_at_exit
    i32[S])``: each event's share of global_cm (``dt / count`` while the
    active count before it is positive, else 0) and of idle (``dt`` while
    it is not, else 0), with the first dt 0; the event of each switch-out
    (delta <= 0) in order, and the active count before it."""
    f32 = np.float32
    t = _np(times_s)
    is_in = _np(deltas) > 0
    step = np.where(is_in, 1, -1)
    count = np.cumsum(step) - step
    dt = t - np.concatenate([t[:1], t[:-1]])
    active = count > 0
    share = np.where(active, dt / np.maximum(count, 1).astype(f32), f32(0))
    idle = np.where(active, f32(0), dt)
    out_idx = np.flatnonzero(~is_in)
    return (_col(share, f32, times_s), _col(idle, f32, times_s),
            _col(out_idx, np.int32, times_s),
            _col(count[out_idx], np.int32, times_s))


def stream_chain_ref(share, idle):
    """Stage 2: ``(gcm f32[E], idle_total, gcm_total)``: global_cm after
    each event and the two totals, float32 running sums in order."""
    f32 = np.float32
    gcm = np.add.accumulate(_np(share), dtype=f32)
    idle_total = np.add.accumulate(_np(idle), dtype=f32)[-1]
    return (_col(gcm, f32, share), _col(idle_total, f32, share).reshape(()),
            _col(gcm[-1], f32, share).reshape(()))


def stream_pair_ref(workers, deltas, num_workers: int):
    """Stage 3: ``(src i32[S], place i32[S], wrange i32[W, 2])``: for the
    k-th switch-out, its worker's last switch-in at or before it (-1:
    none) and its place in the rows ordered stably by worker; for each
    worker the range ``[begin, end)`` of its rows' places, ``(0, 0)`` for
    a worker with no events."""
    w = _np(workers)
    is_in = _np(deltas) > 0
    e = w.shape[0]
    order = np.argsort(w, kind="stable")
    pos = np.arange(e)
    first = np.flatnonzero(np.r_[True, w[order][1:] != w[order][:-1]])
    seg_first = np.repeat(first, np.diff(np.r_[first, e]))
    last_in = np.maximum.accumulate(np.where(is_in[order], pos, -1))
    last = np.full(e, -1)
    last[order] = np.where(last_in >= seg_first, order[last_in], -1)
    out = ~is_in
    w_out = w[out]
    place = np.empty(w_out.shape[0], np.int64)
    place[np.argsort(w_out, kind="stable")] = np.arange(w_out.shape[0])
    n_out = np.bincount(w_out, minlength=num_workers)
    end = np.cumsum(n_out)
    has = np.bincount(w, minlength=num_workers) > 0
    wrange = np.stack([np.where(has, end - n_out, 0), np.where(has, end, 0)],
                      axis=1)
    return (_col(last[out], np.int32, workers),
            _col(place, np.int32, workers), _col(wrange, np.int32, workers))


def stream_rows_ref(times_s, workers, gcm, out_idx, src, place, n_at_exit):
    """Stage 4: ``(rows, slice_cm_by_place)``: the six row columns
    ``(worker, start, end, cm, threads_av, n_at_exit)``, row k the
    switch-out ``out_idx[k]`` paired with the switch-in ``src[k]`` (-1:
    none, which takes global_cm 0 and time 0); and each row's slice cm at
    its place ``place[k]``."""
    f32 = np.float32
    t, g = _np(times_s), _np(gcm)
    i, s, n = _np(out_idx), _np(src), _np(n_at_exit)
    local = np.where(s >= 0, g[s], f32(0))
    start = np.where(s >= 0, t[s], f32(0))
    slice_cm = g[i] - local
    dur = t[i] - start
    with np.errstate(over="ignore"):            # the branch not taken
        threads_av = np.where(slice_cm > 0,
                              dur / np.maximum(slice_cm, f32(1e-30)),
                              np.maximum(n, 1).astype(f32))
    by_place = np.empty_like(slice_cm)
    by_place[_np(place)] = slice_cm
    rows = (_col(_np(workers)[i], np.int32, times_s),
            _col(t[i] - dur, f32, times_s), _col(t[i], f32, times_s),
            _col(slice_cm, f32, times_s), _col(threads_av, f32, times_s),
            _col(n, np.int32, times_s))
    return rows, _col(by_place, f32, times_s)


def stream_cm_ref(slice_cm_by_place, wrange):
    """Stage 5: ``cm f32[W]``, each worker's slices ``slice_cm_by_place[
    begin:end]`` summed in order from 0."""
    f32 = np.float32
    r = _np(wrange).astype(np.int64)
    cm = np.zeros(r.shape[0], f32)
    np.add.at(cm, np.repeat(np.arange(r.shape[0]), r[:, 1] - r[:, 0]),
              _np(slice_cm_by_place))
    return _col(cm, f32, slice_cm_by_place)


def stream_stages_ref(times_s, workers, deltas, num_workers: int):
    """The five stages composed as the kernel composes them; returns what
    :func:`stream_ref` returns, bit for bit."""
    share, idle, out_idx, n_at_exit = stream_prepass_ref(times_s, deltas)
    gcm, idle_total, gcm_total = stream_chain_ref(share, idle)
    src, place, wrange = stream_pair_ref(workers, deltas, num_workers)
    rows, by_place = stream_rows_ref(times_s, workers, gcm, out_idx, src,
                                     place, n_at_exit)
    return (stream_cm_ref(by_place, wrange), idle_total, gcm_total, rows)
