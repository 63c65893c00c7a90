"""CUDA kernel: the paper-faithful streaming CMetric scan.

One step per event, exactly the sched_switch probe of the paper (Table 1)::

    global_cm += (t - t_switch) / thread_count        # every event
    local_cm[w] = global_cm; start[w] = t              # switch-in
    cm_hash[w] += global_cm - local_cm[w]              # switch-out

all in float32, in event order.  :func:`stream_scan` replaces the JAX
package's ``_streaming_scan`` (``src/repro/core/cmetric.py``), a
``lax.scan`` rather than a Pallas kernel.

Design (``csrc/stream_scan.cu``): one launch of one block, which takes
the log in tiles staged in shared memory.  For each tile the block's
threads compute every event's active count, share of global_cm and output
row in parallel; one thread then walks the tile in order (the float32 sums
and the per-worker state, in shared memory while it fits:
:func:`smem_workers` workers, a global scratch array above that); and the
threads write the switch-outs' rows in parallel, the k-th switch-out as
row k, so the output is the compact slice table, not per-event arrays.
Bound: the chain of E dependent float32 adds, not the ~24 bytes an event
moves.

The wrapper checks device, dtype, shape, contiguity and the range of the
worker ids, counts the switch-outs (the rows to allocate), allocates the
outputs with ``torch.empty``, and counts its launches in :data:`LAUNCHES`.
On a CPU tensor it runs :func:`repro_torch.kernels.ref.stream_ref`; on a
CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.cmetric_fold import (check_device, check_vector,
                                              raise_on_error)

#: Kernel launches since the last reset (CPU calls don't count).
LAUNCHES = {"stream": 0}


def smem_workers() -> int:
    """Most workers whose state the kernel keeps in shared memory (builds
    the library on first use)."""
    return build.load("stream_scan").gapp_stream_smem_workers()


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


def launch(times_s, workers, deltas, num_workers: int, out) -> None:
    """Launch the kernel on inputs :func:`stream_scan` has checked, into
    ``out``, outputs it allocated for them; no check and no wait for the
    device, so that a CUDA graph can capture the call."""
    lib = build.load("stream_scan")
    cm, idle, _, rows = out
    dev = times_s.device
    # above the shared-memory limit the state is 16 bytes a worker in
    # device memory (torch's allocations are 16-byte aligned)
    gstate = (None if num_workers <= lib.gapp_stream_smem_workers()
              else torch.empty(4 * num_workers, dtype=torch.float32,
                               device=dev))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.gapp_stream_scan(
            times_s.data_ptr(), workers.data_ptr(), deltas.data_ptr(),
            times_s.shape[0], num_workers,
            None if gstate is None else gstate.data_ptr(), cm.data_ptr(),
            idle.data_ptr(),            # (idle, gcm): one f32[2]
            *(r.data_ptr() for r in rows), rows[0].shape[0], stream)
    raise_on_error(rc, "gapp_stream_scan")
    LAUNCHES["stream"] += 1
