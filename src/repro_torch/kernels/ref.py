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
