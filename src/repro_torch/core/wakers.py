"""Waker analysis + bottleneck classification (paper §7 future work).

The paper's conclusion sketches two extensions we implement here:

* **Waker edges** — "by combining GAPP's existing criticality information
  with an analysis of futex 'wakers' it is relatively easy to distinguish
  critical from non-critical lock holders".  Our analogue: when worker A
  deactivates at time t and worker B activates within ``eps`` after t, A
  plausibly *released* whatever B was waiting on.  Aggregating these edges
  weighted by the waiting worker's subsequent slice CMetric yields a
  wait-for attribution — which worker's completions unblock the most
  critical work (the wPerf-style view, built from the same event stream).

* **Bottleneck classification** — critical call paths are bucketed by tag
  taxonomy (data / checkpoint / collective / compute / serve / other), the
  "automate the process of bottleneck classification" step.
"""
from __future__ import annotations

import collections
import dataclasses


from repro_torch.core.detector import BottleneckReport
from repro_torch.core.events import EventLog


@dataclasses.dataclass
class WakerEdge:
    waker: int
    woken: int
    count: int
    cm_unblocked: float     # CMetric of the woken worker's following slices


def waker_edges(log: EventLog, eps_ns: int = 10_000) -> list[WakerEdge]:
    """Derive wake-up edges from deactivate→activate adjacency."""
    from repro_torch.core.cmetric import compute_numpy
    res = compute_numpy(log)
    # slice start (ns, rebased) -> slice cm, per worker
    t0 = int(log.times[0]) if len(log) else 0
    slice_by_start: dict[tuple[int, int], float] = {}
    for w, s, cm in zip(res.slice_worker, res.slice_start, res.slice_cm):
        slice_by_start[(int(w), t0 + int(round(s * 1e9)))] = float(cm)
    edges: dict[tuple[int, int], list] = collections.defaultdict(
        lambda: [0, 0.0])
    deact = [(int(t), int(w)) for t, w, d in
             zip(log.times, log.workers, log.deltas) if d == -1]
    act = [(int(t), int(w)) for t, w, d in
           zip(log.times, log.workers, log.deltas) if d == 1]
    ai = 0
    for t, w in deact:
        while ai < len(act) and act[ai][0] < t:
            ai += 1
        j = ai
        while j < len(act) and act[j][0] <= t + eps_ns:
            tw, ww = act[j]
            if ww != w:
                e = edges[(w, ww)]
                e[0] += 1
                e[1] += slice_by_start.get((ww, tw), 0.0)
            j += 1
    out = [WakerEdge(a, b, c, cm) for (a, b), (c, cm) in edges.items()]
    out.sort(key=lambda e: -e.cm_unblocked)
    return out


def critical_wakers(log: EventLog, top_k: int = 5,
                    eps_ns: int = 10_000) -> list[tuple[int, float]]:
    """Workers ranked by how much critical work their completions unblock."""
    agg: dict[int, float] = collections.defaultdict(float)
    for e in waker_edges(log, eps_ns):
        agg[e.waker] += e.cm_unblocked
    return sorted(agg.items(), key=lambda kv: -kv[1])[:top_k]


# ---------------------------------------------------------------------------
# classification
# ---------------------------------------------------------------------------

TAXONOMY = {
    "data": ("data/", "load", "wait_data", "prefetch"),
    "io": ("write", "read", "flush", "output", "disk", "file"),
    "checkpoint": ("ckpt", "save", "restore"),
    "collective": ("all_reduce", "all_gather", "all_to_all", "psum",
                   "barrier", "sync"),
    "serve": ("decode/", "prefill", "request", "slot"),
    "compute": ("step", "layer", "matmul", "ffn", "attn", "expert",
                "compute", "stage"),
}


def classify_tag(tag: str) -> str:
    low = tag.lower()
    for cls, keys in TAXONOMY.items():
        if any(k in low for k in keys):
            return cls
    return "other"


def classify_report(rep: BottleneckReport) -> dict[str, float]:
    """Cumulative critical CMetric per bottleneck class."""
    out: dict[str, float] = collections.defaultdict(float)
    for p in rep.paths:
        tag = rep.tag_name(p.stack[-1]) if p.stack else "other"
        out[classify_tag(tag)] += p.cmetric
    return dict(out)
