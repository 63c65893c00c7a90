"""Pipeline parallelism: the GPipe schedule as busy intervals.

The layer stack is split into ``n_stages`` stages and microbatches flow
stage to stage.  The schedule is the classic GPipe fill/steady/drain loop
of length ``n_micro + n_stages - 1``; the warm-up and drain slots are
*bubbles*, exactly the reduced-parallelism intervals GAPP's CMetric is
built to expose (see ``examples/pipeline_bubbles.py``: the per-stage busy
intervals of this schedule are ingested into the profiler and the bubble
fraction appears as stage-0/stage-N-1 criticality).

Only the schedule is ported.  The JAX package's ``gpipe()`` (the stage
loop over a mesh, activations passed on with ``ppermute``) needs the
port's multi-rank layer, which it does not have yet.
"""
from __future__ import annotations


def schedule_intervals(n_stages: int, n_micro: int, t_stage: float = 1.0):
    """The GPipe schedule as (stage, start, end) busy intervals — the
    ground-truth activity trace used to drive the profiler in tests and in
    examples/pipeline_bubbles.py.  Bubble fraction = (n_stages-1)/(n_micro +
    n_stages-1)."""
    out = []
    for s in range(n_stages):
        for m in range(n_micro):
            t0 = (s + m) * t_stage
            out.append((s, t0, t0 + t_stage))
    return out
