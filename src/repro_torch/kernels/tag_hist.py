"""CUDA kernel: sample-tag frequency histogram (paper §4.4 merge step).

Replaces the TPU kernel ``_hist_kernel`` of the JAX package
(``src/repro/kernels/tag_hist.py``, wrapper ``hist``).  The detector merges
sampled tags into per-call-path frequency tables through one flat
histogram of (path, tag) keys; a weighted variant (weights = slice
CMetrics) gives the cumulative-CMetric-per-tag table in the same pass.

Design (``csrc/tag_hist.cu``): the TPU form compares sample blocks against
bin blocks as a one-hot matrix and accumulates across its sequential grid.
Here one thread takes one sample and adds it with atomics: into a private
copy of the bins in shared memory when they fit (K <= 6144), merged into
the output with global atomics at the end of each block; straight into the
output otherwise.  Counts are exact; the weighted sums are float atomics in
a varying order.  Tags that are negative or ``>= num_bins`` are dropped,
as the TPU kernel drops them.

Bound: memory, 8 bytes per sample (tag, weight) plus 8 per bin (count,
weighted sum).

On a CPU tensor the wrapper runs :func:`repro_torch.kernels.ref.hist_ref`;
on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.cmetric_fold import (check_device, check_vector,
                                              raise_on_error)

#: Kernel launches since the last reset (CPU calls don't count).
LAUNCHES = {"hist": 0}


def hist(tags, weights=None, *, num_bins: int):
    """Histogram and weighted histogram of tag ids.

    Args:
      tags:     i32[S] tag ids; those outside ``[0, num_bins)`` are dropped.
      weights:  f32[S] per-sample weights (default: every sample weighs 1).
      num_bins: K.

    Returns ``(counts i32[K], wsum f32[K])``.
    """
    check_vector(tags, torch.int32, "tags")
    if weights is not None:
        check_vector(weights, torch.float32, "weights")
        if weights.shape != tags.shape:
            raise ValueError(f"weights {tuple(weights.shape)} and tags "
                             f"{tuple(tags.shape)} differ in shape")
    num_bins = int(num_bins)
    if num_bins < 1:
        raise ValueError(f"num_bins must be positive, got {num_bins}")
    tensors = [tags] if weights is None else [tags, weights]
    dev = check_device(tensors, ["tags", "weights"])
    if dev.type == "cpu":
        return ref.hist_ref(tags, weights, num_bins)
    lib = build.load("tag_hist")
    counts = torch.empty(num_bins, dtype=torch.int32, device=dev)
    wsum = torch.empty(num_bins, dtype=torch.float32, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.gapp_tag_hist(tags.data_ptr(),
                               None if weights is None else weights.data_ptr(),
                               tags.shape[0], num_bins, counts.data_ptr(),
                               wsum.data_ptr(), sms, stream)
    raise_on_error(rc, "gapp_tag_hist")
    LAUNCHES["hist"] += 1
    return counts, wsum
