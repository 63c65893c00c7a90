"""CUDA kernel: the paper-faithful streaming CMetric scan.

One step per event, exactly the sched_switch probe of the paper (Table 1)::

    global_cm += (t - t_switch) / thread_count        # every event
    local_cm[w] = global_cm; start[w] = t              # switch-in
    cm_hash[w] += global_cm - local_cm[w]              # switch-out

all in float32, in event order.  :func:`stream_scan` replaces the JAX
package's ``_streaming_scan`` (``src/repro/core/cmetric.py``), a
``lax.scan`` rather than a Pallas kernel.

Design (``csrc/stream_scan.cu``): only the two float32 running sums,
global_cm and idle, must be walked in event order; the rest of a step is
parallel once they are known.  So one call is a pipeline of six launches
on the caller's stream, with a fork to a second stream and back:

1. prepass (whole grid, one pass with a decoupled look-back): each event's
   active count, share of global_cm and of idle, and for a switch-out its
   row (the k-th switch-out is row k) and ``n_at_exit``;
2. chain (one block): one lane walks global_cm and another idle, each on
   its own SM sub-partition, over tiles a third warp streams into shared
   memory with bulk copies (TMA); global_cm is stored every 256 events;
   then expand (whole grid) recomputes it after every event from those
   checkpoints, with the same adds in the same order;
3. pair (on the second stream, while the chain runs): ``torch.sort`` of
   the worker ids, stable, then a max-scan with a decoupled look-back over
   the sorted events gives each switch-out its worker's last switch-in at
   or before it, and each row its place in worker-major order;
4. rows (one thread a row): slice cm and duration from the two global_cm
   values and times, and the six columns;
5. cm (one warp a worker): each worker's slices summed in event order.

Bound: the chain of E dependent float32 adds, not the ~24 bytes an event
moves.  Each stage has its plain version in :mod:`repro_torch.kernels.ref`
(``stream_*_ref``); the ``*_stage`` functions here launch one stage alone,
so that a test or ``chip_smoke.py`` can hold it against its own.

The wrapper checks device, dtype, shape, contiguity and the range of the
worker ids, counts the switch-outs (the rows to allocate), allocates the
outputs with ``torch.empty`` and counts one launch in :data:`LAUNCHES`
per call, for the whole pipeline.  On a CPU tensor it runs
:func:`repro_torch.kernels.ref.stream_ref`; on a CUDA tensor it launches
the pipeline or raises.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.cmetric_fold import (check_device, check_vector,
                                              raise_on_error, vec_ok)

#: Calls of :func:`stream_scan` (one per call, for the pipeline's six
#: launches) on the card since the last reset; CPU calls and the stage
#: functions don't count.
LAUNCHES = {"stream": 0}

# One second stream per card for the pairing.  PyTorch's caching allocator
# keeps freed blocks per stream, so a stream of its own per call (from its
# pool of 32) would make the sort's outputs and scratch fresh device
# allocations call after call.
_SIDE: dict[int, torch.cuda.Stream] = {}     # guarded-by: _SIDE_LOCK
_SIDE_LOCK = threading.Lock()


def _side_stream(dev: torch.device) -> torch.cuda.Stream:
    with _SIDE_LOCK:
        side = _SIDE.get(dev.index)
        if side is None:
            side = _SIDE[dev.index] = torch.cuda.Stream(dev)
        return side


def stream_scan(times_s, workers, deltas, num_workers: int):
    """Walk the events in order (see :func:`ref.stream_ref`).

    Args:
      times_s:  f32[E] rebased event times, E > 0.
      workers:  i32[E] worker ids in ``[0, num_workers)``; an id outside
        raises ``ValueError``.
      deltas:   i32[E]; ``> 0`` is a switch-in, anything else a switch-out.

    Returns ``(cm f32[W], idle, gcm, rows)``: the per-worker CMetric, the
    idle time and final global_cm as 0-d f32 tensors, and ``rows`` =
    ``(worker i32[S], start f32[S], end f32[S], cm f32[S], threads_av
    f32[S], n_at_exit i32[S])``, one row per switch-out in event order.
    """
    check_vector(times_s, torch.float32, "times_s")
    check_vector(workers, torch.int32, "workers")
    check_vector(deltas, torch.int32, "deltas")
    if not times_s.shape == workers.shape == deltas.shape:
        raise ValueError("times_s, workers and deltas differ in shape")
    e = times_s.shape[0]
    if e == 0:
        raise ValueError("stream_scan needs at least one event")
    if num_workers < 1:
        raise ValueError(f"num_workers must be >= 1, got {num_workers}")
    dev = check_device([times_s, workers, deltas],
                       ["times_s", "workers", "deltas"])
    # the id range and the row count, in one wait for the device
    lo, hi, s = torch.stack([workers.min().long(), workers.max().long(),
                             (deltas <= 0).sum()]).tolist()
    if lo < 0 or hi >= num_workers:
        raise ValueError(f"worker ids span [{lo}, {hi}], outside "
                         f"[0, {num_workers})")
    if dev.type == "cpu":
        return ref.stream_ref(times_s, workers, deltas, num_workers)
    cm = torch.empty(num_workers, dtype=torch.float32, device=dev)
    scalars = torch.empty(2, dtype=torch.float32, device=dev)
    rows = (torch.empty(s, dtype=torch.int32, device=dev),
            *(torch.empty(s, dtype=torch.float32, device=dev)
              for _ in range(4)),
            torch.empty(s, dtype=torch.int32, device=dev))
    out = (cm, scalars[0], scalars[1], rows)
    launch(times_s, workers, deltas, num_workers, out)
    return out


def _padded(lib, e: int) -> int:
    """E rounded up to whole tiles: the length of share, idle and gcm."""
    tile = lib.gapp_stream_tile()
    return -(-e // tile) * tile


def launch(times_s, workers, deltas, num_workers: int, out) -> None:
    """Launch the pipeline on inputs :func:`stream_scan` has checked, into
    ``out``, outputs it allocated for them.  Every launch is queued on the
    caller's stream, but for the pairing, which a second stream runs
    between two CUDA events (forked after the prepass, joined before the
    rows), so the call can be captured in a CUDA graph.  No check and no
    wait for the device (the kernels refuse more than 2^31 - 1 events);
    the scratch is allocated here, per call."""
    lib = build.load("stream_scan")
    cm, idle, _, rows = out
    e, s = times_s.shape[0], rows[0].shape[0]
    dev = times_s.device
    p = _padded(lib, e)
    ntiles = p // lib.gapp_stream_tile()

    def empty(n, dtype):
        return torch.empty(n, dtype=dtype, device=dev)

    f32, i32 = torch.float32, torch.int32
    with torch.cuda.device(dev):
        main = torch.cuda.current_stream(dev)
        share, idle_terms, gcm = empty(p, f32), empty(p, f32), empty(p, f32)
        ckpt = empty(p // lib.gapp_stream_segment() + 1, f32)
        row_of, out_idx = empty(e, i32), empty(s, i32)
        pair, wrange = empty(2 * s, i32), empty(2 * num_workers, i32)
        by_place = empty(s, f32)
        pre_status = empty(2 * ntiles + 1, torch.int64)
        pair_status = empty(2 * ntiles + 1, torch.int64)
        raise_on_error(lib.gapp_stream_prepass(
            times_s.data_ptr(), deltas.data_ptr(), e, share.data_ptr(),
            idle_terms.data_ptr(), row_of.data_ptr(), out_idx.data_ptr(),
            rows[5].data_ptr(), pre_status.data_ptr(),
            vec_ok(times_s, deltas), main.cuda_stream),
            "gapp_stream_prepass")
        side = _side_stream(dev)
        fork, join = torch.cuda.Event(), torch.cuda.Event()
        fork.record(main)
        side.wait_event(fork)
        with torch.cuda.stream(side):
            sorted_w, order = torch.sort(workers, stable=True)
            rc = lib.gapp_stream_pair(
                sorted_w.data_ptr(), order.data_ptr(), deltas.data_ptr(),
                row_of.data_ptr(), e, num_workers, pair.data_ptr(),
                wrange.data_ptr(), pair_status.data_ptr(), side.cuda_stream)
            join.record(side)
        raise_on_error(rc, "gapp_stream_pair")
        raise_on_error(lib.gapp_stream_chain(
            share.data_ptr(), idle_terms.data_ptr(), e, ckpt.data_ptr(),
            idle.data_ptr(),            # (idle, gcm): one f32[2]
            main.cuda_stream), "gapp_stream_chain")
        raise_on_error(lib.gapp_stream_expand(
            share.data_ptr(), ckpt.data_ptr(), e, gcm.data_ptr(),
            main.cuda_stream), "gapp_stream_expand")
        main.wait_event(join)
        raise_on_error(lib.gapp_stream_rows(
            times_s.data_ptr(), workers.data_ptr(), gcm.data_ptr(),
            out_idx.data_ptr(), pair.data_ptr(), s,
            *(r.data_ptr() for r in rows), by_place.data_ptr(),
            main.cuda_stream), "gapp_stream_rows")
        raise_on_error(lib.gapp_stream_cm(
            by_place.data_ptr(), wrange.data_ptr(), num_workers,
            cm.data_ptr(), main.cuda_stream), "gapp_stream_cm")
    LAUNCHES["stream"] += 1


# ---- one stage alone, on the card, for the tests and chip_smoke.py ----------
# Each takes and returns what its plain version in ref.py does.

def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def prepass_stage(times_s, deltas):
    """Stage 1 alone: see :func:`ref.stream_prepass_ref`."""
    lib = build.load("stream_scan")
    dev, e = times_s.device, times_s.shape[0]
    s = int((deltas <= 0).sum())
    p = _padded(lib, e)
    share, idle = (torch.empty(p, dtype=torch.float32, device=dev)
                   for _ in range(2))
    row_of = torch.empty(e, dtype=torch.int32, device=dev)
    out_idx, n_at_exit = (torch.empty(s, dtype=torch.int32, device=dev)
                          for _ in range(2))
    status = torch.empty(2 * (p // lib.gapp_stream_tile()) + 1,
                         dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        raise_on_error(lib.gapp_stream_prepass(
            times_s.data_ptr(), deltas.data_ptr(), e, share.data_ptr(),
            idle.data_ptr(), row_of.data_ptr(), out_idx.data_ptr(),
            n_at_exit.data_ptr(), status.data_ptr(),
            vec_ok(times_s, deltas), _stream(dev)), "gapp_stream_prepass")
    return share[:e], idle[:e], out_idx, n_at_exit


def chain_buffers(share, idle):
    """``share`` and ``idle`` copied into zero-padded buffers of whole
    tiles, as the chain reads them, and the checkpoint and gcm buffers
    it writes."""
    lib = build.load("stream_scan")
    e, p = share.shape[0], _padded(lib, share.shape[0])
    bufs = [torch.zeros(n, dtype=torch.float32, device=share.device)
            for n in (p, p, p // lib.gapp_stream_segment() + 1, p)]
    bufs[0][:e] = share
    bufs[1][:e] = idle
    return bufs


def chain_launch(e: int, bufs, scalars) -> None:
    """The chain's walk alone over ``bufs`` from :func:`chain_buffers`,
    into its checkpoints and ``scalars`` f32[2] = (idle total, global_cm
    total)."""
    lib = build.load("stream_scan")
    share, idle, ckpt, _ = bufs
    with torch.cuda.device(share.device):
        raise_on_error(lib.gapp_stream_chain(
            share.data_ptr(), idle.data_ptr(), e, ckpt.data_ptr(),
            scalars.data_ptr(), _stream(share.device)), "gapp_stream_chain")


def chain_stage(share, idle):
    """Stage 2 alone, the walk and the expansion: see
    :func:`ref.stream_chain_ref`."""
    lib = build.load("stream_scan")
    e = share.shape[0]
    bufs = chain_buffers(share, idle)
    scalars = torch.empty(2, dtype=torch.float32, device=share.device)
    chain_launch(e, bufs, scalars)
    with torch.cuda.device(share.device):
        raise_on_error(lib.gapp_stream_expand(
            bufs[0].data_ptr(), bufs[2].data_ptr(), e, bufs[3].data_ptr(),
            _stream(share.device)), "gapp_stream_expand")
    return bufs[3][:e], scalars[0], scalars[1]


def pair_stage(workers, deltas, num_workers: int):
    """Stage 3 alone, with the stable sort: see
    :func:`ref.stream_pair_ref`."""
    lib = build.load("stream_scan")
    dev, e = workers.device, workers.shape[0]
    out = deltas <= 0
    s = int(out.sum())
    row_of = (torch.cumsum(out, 0, dtype=torch.int32) - 1).to(torch.int32)
    pair = torch.empty(2 * s, dtype=torch.int32, device=dev)
    wrange = torch.empty(2 * num_workers, dtype=torch.int32, device=dev)
    status = torch.empty(2 * (_padded(lib, e) // lib.gapp_stream_tile()) + 1,
                         dtype=torch.int64, device=dev)
    sorted_w, order = torch.sort(workers, stable=True)
    with torch.cuda.device(dev):
        raise_on_error(lib.gapp_stream_pair(
            sorted_w.data_ptr(), order.data_ptr(), deltas.data_ptr(),
            row_of.data_ptr(), e, num_workers, pair.data_ptr(),
            wrange.data_ptr(), status.data_ptr(), _stream(dev)),
            "gapp_stream_pair")
    pair = pair.view(s, 2)
    return pair[:, 0], pair[:, 1], wrange.view(num_workers, 2)


def rows_stage(times_s, workers, gcm, out_idx, src, place, n_at_exit):
    """Stage 4 alone: see :func:`ref.stream_rows_ref`."""
    lib = build.load("stream_scan")
    dev, s = times_s.device, out_idx.shape[0]
    pair = torch.stack([src, place], 1).to(torch.int32).contiguous()
    rows = (torch.empty(s, dtype=torch.int32, device=dev),
            *(torch.empty(s, dtype=torch.float32, device=dev)
              for _ in range(4)),
            n_at_exit.to(torch.int32).clone())
    by_place = torch.empty(s, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        raise_on_error(lib.gapp_stream_rows(
            times_s.data_ptr(), workers.data_ptr(), gcm.data_ptr(),
            out_idx.data_ptr(), pair.data_ptr(), s,
            *(r.data_ptr() for r in rows), by_place.data_ptr(),
            _stream(dev)), "gapp_stream_rows")
    return rows, by_place


def cm_stage(by_place, wrange):
    """Stage 5 alone: see :func:`ref.stream_cm_ref`."""
    lib = build.load("stream_scan")
    dev, w = by_place.device, wrange.shape[0]
    cm = torch.empty(w, dtype=torch.float32, device=dev)
    r = wrange.to(torch.int32).contiguous()
    with torch.cuda.device(dev):
        raise_on_error(lib.gapp_stream_cm(
            by_place.data_ptr(), r.data_ptr(), w, cm.data_ptr(),
            _stream(dev)), "gapp_stream_cm")
    return cm
