"""The plain reference of GAPP's analysis: the paper's CMetric fold
(section 4.1) event at a time, the section 3.2 tolerance rules, critical
slices (threads_av < n_min) and the ranking of call paths by summed
CMetric, over a captured event log given as columns.

A frozen copy of the float64 oracle's arithmetic; ``dtype`` selects the
accumulation precision (float64 for the reference, float16 for the
control).  It imports nothing of the port.
"""
from __future__ import annotations

import numpy as np

ACTIVATE = 1
# float32 spacings of the running global CMetric allowed, per event folded
# while a slice is open and two more, between a float32 fold's CMetric of
# that slice and this fold's: each stored value of the sum is rounded by at
# most half a spacing per event, so this is twice that bound
F32_ULPS = 1.0


def sanitize(workers: np.ndarray, deltas: np.ndarray,
             num_workers: int) -> np.ndarray:
    """Keep mask of the tolerance rules: a worker's events are kept while
    they alternate from idle; an ACTIVATE of an active worker and a
    DEACTIVATE of an idle one are dropped."""
    active = np.zeros(num_workers, bool)
    keep = np.zeros(len(workers), bool)
    for i, (w, d) in enumerate(zip(workers.tolist(), deltas.tolist())):
        on = d == ACTIVATE
        if on != active[w]:
            keep[i] = True
            active[w] = on
    return keep


def fold(times_ns: np.ndarray, workers: np.ndarray, deltas: np.ndarray,
         tags: np.ndarray, num_workers: int, dtype=np.float64) -> dict:
    """Per-worker CMetric and every closed slice (worker, end time, cm,
    threads_av, the tag its ACTIVATE carried, the global CMetric at its
    end, the count of events folded while it was open, its length in
    seconds), in ``dtype``."""
    keep = sanitize(workers, deltas, num_workers)
    t = ((times_ns[keep] - times_ns[keep][0]) * 1e-9).astype(dtype) \
        if keep.any() else np.zeros(0, dtype)
    w, d, tg = workers[keep], deltas[keep], tags[keep]
    t_end = times_ns[keep]
    gcm = dtype(0)
    count = 0
    local = np.zeros(num_workers, dtype)
    start = np.zeros(num_workers, dtype)
    open_tag = np.full(num_workers, -1, np.int64)
    open_at = np.zeros(num_workers, np.int64)
    cm = np.zeros(num_workers, dtype)
    rows = []
    t_prev = t[0] if len(t) else dtype(0)
    for i in range(len(t)):
        if count > 0:
            gcm = dtype(gcm + (t[i] - t_prev) / dtype(count))
        t_prev = t[i]
        wi = int(w[i])
        if d[i] == ACTIVATE:
            local[wi] = gcm
            start[wi] = t[i]
            open_tag[wi] = int(tg[i])
            open_at[wi] = i
            count += 1
        else:
            scm = dtype(gcm - local[wi])
            cm[wi] += scm
            dur = t[i] - start[wi]
            tav = float(dur / scm) if scm > 0 else float(max(count, 1))
            rows.append((wi, int(t_end[i]), float(scm), tav,
                         int(open_tag[wi]), float(gcm),
                         int(i - open_at[wi] - 1), float(dur)))
            count -= 1
    return {"per_worker": cm.astype(np.float64), "slices": rows}


def paths(result: dict, n_min: float) -> dict:
    """Summed CMetric of the critical slices by the tag they ran under."""
    out: dict = {}
    for _, _, scm, tav, tag, *_ in result["slices"]:
        if tav < n_min:
            out[tag] = out.get(tag, 0.0) + scm
    return out


def critical_keys(result: dict, n_min: float) -> set:
    return {(w, end) for w, end, _, tav, *_ in result["slices"]
            if tav < n_min}


def float32_ambiguous(result: dict, n_min: float) -> set:
    """Keys (worker, end time) of the slices whose criticality a fold
    that keeps the global CMetric in float32 cannot settle.  Each stored
    value of that running sum is rounded once per event it folds, so a
    slice's CMetric (the difference of two of them) may be off by
    ``F32_ULPS`` spacings of float32 at the sum's value at the slice's
    end, per event folded while the slice was open and two more; a slice is
    ambiguous when its threads_av over that range of CMetric reaches
    both sides of ``n_min``."""
    out = set()
    for w, end, scm, _, _, gcm, inside, dur in result["slices"]:
        if scm <= 0:
            continue        # no time passed: every fold takes the fallback
        err = F32_ULPS * (inside + 2) * float(np.spacing(np.float32(gcm)))
        lo = dur / (scm + err)
        hi = dur / (scm - err) if scm > err else float("inf")
        if lo < n_min <= hi:
            out.add((w, end))
    return out
