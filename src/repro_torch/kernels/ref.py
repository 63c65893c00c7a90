"""Plain PyTorch versions of the CUDA kernels.

Each one computes what its kernel computes, with ordinary tensor ops.  A
kernel wrapper takes its plain version for tensors on the CPU (the CPU
tests); ``chip_smoke.py`` holds every kernel against its plain version on
the card.  They mirror the JAX package's ``kernels/ref.py`` and the jnp
prefix of ``core/cmetric.py``, with one deliberate difference: tags outside
``[0, num_bins)`` are dropped by :func:`hist_ref`, as the TPU kernel does,
where the JAX oracle clips them into the last bin.
"""
from __future__ import annotations

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
