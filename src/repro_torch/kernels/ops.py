"""Public entry points over the CUDA kernels.

The functions here run on the device of the tensors they are given, or on
:func:`repro_torch.device.default_device` where they take host arrays.
On CUDA every one launches its kernel; on the CPU it runs the kernel's
plain version (the CPU tests).  Nothing falls back from one to the other.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch import spans
from repro_torch.kernels import cmetric_fold as _fold
from repro_torch.kernels import stream_scan as _stream
from repro_torch.kernels import tag_hist as _hist


def cmetric_fold(times_s, deltas, carry=None):
    """Fold an event stream into ``(n, gcm, total_cm, idle, count)``.

    ``times_s`` are f32 event times (seconds, rebased); dt is derived here
    so callers hand over the raw stream.  ``carry`` optionally resumes a
    prior fold from its (count, gcm, idle) scalars; the final ``(total_cm,
    idle, count)`` triple of the return value is the next chunk's carry.
    """
    dt = torch.empty_like(times_s)
    torch.sub(times_s[1:], times_s[:-1], out=dt[:-1])
    dt[-1:] = 0.0
    return _fold.fold(dt, deltas.to(torch.int32), carry)


def fold_chunk_prefix(gcm0: float, idle0: float, contrib, idle_contrib, *,
                      device=None):
    """Device prefix for the chunked CMetric fold (see
    :func:`repro_torch.core.cmetric._fold_chunk`): carry-seeded cumsum of the
    host-computed per-event contributions on the ``carry_cumsum`` kernel.

    Returns ``(g float64[E], idle_end float)`` where ``g[i]`` is the
    global_cm value at event ``i``.  The upload through the read-back is
    the drain's device segment (:func:`repro_torch.spans.on_device`).
    """
    dev = device_lib.resolve(device)
    with spans.on_device():
        c = torch.from_numpy(np.asarray(contrib, np.float32)).to(dev)
        i = torch.from_numpy(np.asarray(idle_contrib, np.float32)).to(dev)
        g, _, idle_end = _fold.carry_cumsum(c, i, (gcm0, idle0))
        g, idle_end = g.cpu().numpy().astype(np.float64), float(idle_end)
    return g, idle_end


def tag_histogram(tags, weights=None, *, num_bins: int):
    """``(counts i32[K], wsum f32[K])`` of tag ids on the ``tag_hist``
    kernel; tags outside ``[0, num_bins)`` are dropped."""
    return _hist.hist(tags, weights, num_bins=num_bins)


def stream_scan(times_s, workers, deltas, num_workers: int):
    """The paper-faithful sequential CMetric walk on the ``stream_scan``
    kernel: ``(cm f32[W], idle, gcm, slice rows)``, see
    :func:`repro_torch.kernels.stream_scan.stream_scan`."""
    return _stream.stream_scan(times_s, workers, deltas, num_workers)


def _fused_pipeline(times_s, workers, deltas, num_workers: int):
    """The fold kernel followed by pairing and per-worker aggregation, all
    on the device: the gcm prefix and the active counts never leave it
    between stages."""
    from repro_torch.core import cmetric as cmetric_lib  # avoid import cycle
    n, gcm, _, idle, _ = cmetric_fold(times_s, deltas)
    return cmetric_lib._pair_core(times_s, workers, n, gcm, idle,
                                  num_workers)


def compute_fused(log):
    """CMetric backend: the fold kernel fused with the shared pairing and
    aggregation core, on the default device (see
    :func:`repro_torch.core.cmetric.drive_pairing`)."""
    from repro_torch.core import cmetric as cmetric_lib  # avoid import cycle
    return cmetric_lib.drive_pairing(log, _fused_pipeline)


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last :func:`reset_launch_counts`."""
    return {**_fold.LAUNCHES, **_hist.LAUNCHES, **_stream.LAUNCHES}


def reset_launch_counts() -> None:
    for counts in (_fold.LAUNCHES, _hist.LAUNCHES, _stream.LAUNCHES):
        for k in counts:
            counts[k] = 0
