"""Causal what-if engine: counterfactual bottleneck projections.

GAPP's report ranks serialization bottlenecks; this module answers the
question the ranking begs — *what would fixing one be worth?*  In the
style of causal profilers (TASKPROF / COZ virtual speedups), a
counterfactual is computed by **replaying the fold over a time-warped
copy of the captured event log**: no re-capture, no instrumentation
change, pure columnar transforms.

Model
-----
Pick a target — a tag, a host, a worker, or a ranked path — and a
``shrink`` factor in ``[0, 1]`` (``0.0`` removes the targeted work
entirely, ``0.5`` halves it).  The engine then

1. re-folds the captured log once to get the baseline critical-slice
   table (bit-equal to the report's own fold on the numpy backend);
2. marks the targeted *critical* slices and, between every pair of
   adjacent events, compresses the interval iff **every worker active in
   that interval is inside a targeted critical slice** — time where the
   target is the only thing the machine is waiting on.  Intervals where
   untargeted work is also running are untouched: that work would still
   have to happen, so wall-clock cannot shrink there;
3. rebuilds event times as the cumsum of the warped interval lengths
   (monotonicity is preserved by construction) and re-folds the warped
   log through the standard detection pipeline.

The projection is *exact* for exclusively-serial sections (a worker
running alone, e.g. a serial optimizer step or a straggling expert's
tail) and conservative when the targeted work overlaps other work.
``examples/moe_imbalance.py`` and ``examples/pipeline_bubbles.py``
construct ground truth where the true gain is known; the gated
``--smoke whatif`` benchmark asserts projected-vs-measured agreement.

Surface
-------
* ``report.what_if("tag", shrink=0.0)`` → :class:`WhatIfResult`
  (projected end-to-end speedup, the new CMetric ranking with rank
  moves, per-worker load shift);
* ``report.sensitivity(params)`` → :class:`SensitivityResult`
  (tolerance/sampling perturbation sweep reporting rank stability);
* ``GET /api/whatif?tag=&shrink=`` on the live service returns the same
  document byte-for-byte (both sides are ``json.dumps(doc, indent=2)``
  over the same deterministic fold);
* the text/json exporters accept ``what_if=N`` to append projections
  for the top-N ranked paths.

Reports gain these abilities through a :class:`ReplaySpec` handle
attached at detection time (``detect`` / ``detect_offline`` / offline
:meth:`~repro_torch.core.session.ProfileSession.snapshot`); the handle holds a
log *provider*, not a copy — nothing is materialized until asked.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Callable

import numpy as np

from repro_torch import device as device_lib
from repro_torch.core import backends as backends_lib
from repro_torch.core import detector as detector_lib
from repro_torch.core.events import EventLog
from repro_torch.core.report import path_entries
from repro_torch.core.sampler import SampleBuffer, simulate_samples
from repro_torch.core.tracer import StackRegistry, TagRegistry

#: Version of the WhatIfResult / SensitivityResult JSON layout.
WHATIF_SCHEMA_VERSION = 1


@dataclasses.dataclass
class ReplaySpec:
    """Everything needed to re-fold a report's capture counterfactually.

    Attached to :class:`~repro_torch.core.detector.BottleneckReport` by the
    detection entry points.  ``log_provider`` is lazy — the event log is
    only materialized when a what-if/sensitivity query actually runs.
    """

    log_provider: Callable[[], EventLog]
    tags: TagRegistry
    stacks: StackRegistry
    n_min: float
    backend: str = "numpy"
    samples: SampleBuffer | None = None
    sample_dt_ns: int | None = None
    worker_names: list[str] | None = None
    worker_hosts: list[str] | None = None
    chunk_events: int | None = None
    device: object | None = None         # the capture's device= (None: default)

    def resolved_worker_names(self, num_workers: int) -> list[str]:
        if self.worker_names:
            return list(self.worker_names)
        return [f"w{i}" for i in range(num_workers)]


# ---------------------------------------------------------------------------
# the time warp (pure columnar transform)
# ---------------------------------------------------------------------------

def warp_log(log: EventLog, starts_ns: np.ndarray, ends_ns: np.ndarray,
             shrink: float) -> tuple[EventLog, float, int, float]:
    """Compress every inter-event interval fully covered by the targeted
    slices.

    An interval ``[t[i], t[i+1])`` is *compressible* iff at least one
    worker is active in it and the number of targeted slices covering it
    equals the active-worker count — i.e. every active worker is inside
    targeted work, so scaling the interval by ``shrink`` removes only
    targeted time.  Returns ``(warped_log, saved_s, compressed_intervals,
    compressed_s)``; the input log must be sanitized/time-sorted.
    """
    e = len(log)
    if e < 2 or starts_ns.size == 0:
        return log, 0.0, 0, 0.0
    t = log.times

    def snap(x):
        # slice boundaries are event times by construction, but device
        # backends round-trip them through float32 — snap to the nearest
        # event so a few-ns perturbation cannot shift the coverage window
        idx = np.searchsorted(t, x)
        lo = np.clip(idx - 1, 0, e - 1)
        hi = np.clip(idx, 0, e - 1)
        return np.where(np.abs(t[hi] - x) < np.abs(x - t[lo]), t[hi], t[lo])

    # active workers during interval i: running delta sum after event i
    n = np.cumsum(log.deltas.astype(np.int64))[:-1]
    # slice [start, end) covers intervals [a, b): boundary-delta cumsum
    a = np.searchsorted(t, snap(starts_ns), side="left")
    b = np.searchsorted(t, snap(ends_ns), side="left")
    cover = np.zeros(e, np.int64)
    np.add.at(cover, np.minimum(a, e - 1), 1)
    np.add.at(cover, np.minimum(b, e - 1), -1)
    c = np.cumsum(cover)[:-1]
    dt = (t[1:] - t[:-1]).astype(np.float64)
    compress = (n > 0) & (c >= n)
    if not compress.any():
        return log, 0.0, 0, 0.0
    new_dt = np.where(compress, dt * float(shrink), dt)
    compressed_ns = float(dt[compress].sum())
    saved_ns = (1.0 - float(shrink)) * compressed_ns
    new_t = np.empty(e, np.int64)
    new_t[0] = t[0]
    # cumsum of non-negative floats is non-decreasing and round is
    # monotone, so warped times stay sorted
    new_t[1:] = t[0] + np.round(np.cumsum(new_dt)).astype(np.int64)
    warped = EventLog(new_t, log.workers, log.deltas, log.tags,
                      log.stacks, log.num_workers)
    return warped, saved_ns * 1e-9, int(compress.sum()), compressed_ns * 1e-9


# ---------------------------------------------------------------------------
# target selection
# ---------------------------------------------------------------------------

def _stack_ids_containing(stacks: StackRegistry, tid: int) -> np.ndarray:
    return np.asarray([s for s, p in enumerate(stacks.paths) if tid in p],
                      np.int64)


def _slice_tags_from_events(log: EventLog, crit) -> np.ndarray:
    """Per-slice governing tag, recovered from the event stream.

    Stack ids are interned only for slices the *live* tracer deemed
    critical — and the fleet wire format drops them entirely — but every
    event carries its top-of-stack tag.  The tag governing a slice is the
    one at the most recent event at-or-before the slice start on that
    worker (a worker's events are time-sorted within the log)."""
    out = np.full(len(crit), -1, np.int64)
    for w in np.unique(crit.worker):
        m = crit.worker == w
        ew = log.workers == w
        t_w = log.times[ew]
        tag_w = log.tags[ew].astype(np.int64)
        idx = np.searchsorted(t_w, crit.start_ns[m], side="right") - 1
        vals = np.full(int(m.sum()), -1, np.int64)
        ok = idx >= 0
        vals[ok] = tag_w[idx[ok]]
        out[m] = vals
    return out


def _resolve_target(rep, spec: ReplaySpec, crit, log, kind: str, value):
    """Map a (kind, value) target to (mask over ``crit`` rows, selection
    doc).  Unknown names raise ``ValueError`` listing what *is* known."""
    nrows = len(crit)
    if kind == "tag":
        names = list(spec.tags.names)
        if isinstance(value, str):
            if value not in names:
                known = ", ".join(repr(n) for n in sorted(names)[:25])
                raise ValueError(
                    f"unknown tag {value!r}; known tags: {known or '<none>'}")
            tid = names.index(value)
        else:
            tid = int(value)
            if not 0 <= tid < len(names):
                raise ValueError(
                    f"tag id {tid} out of range 0..{len(names) - 1}")
        sids = _stack_ids_containing(spec.stacks, tid)
        mask = (np.isin(crit.stack_id, sids) if sids.size
                else np.zeros(nrows, bool))
        if nrows:
            # slices with no interned stack (live-non-critical, or any
            # fleet-ingested slice) still match through their event tags
            mask = mask | (_slice_tags_from_events(log, crit) == tid)
        return mask, {"kind": "tag", "value": names[tid], "tag_id": tid}
    if kind == "worker":
        wn = spec.resolved_worker_names(int(crit.worker.max()) + 1
                                        if nrows else 0)
        if isinstance(value, str):
            if value not in wn:
                known = ", ".join(repr(n) for n in wn[:25])
                raise ValueError(
                    f"unknown worker {value!r}; known: {known or '<none>'}")
            wid = wn.index(value)
        else:
            wid = int(value)
        mask = crit.worker == wid
        name = wn[wid] if 0 <= wid < len(wn) else f"w{wid}"
        return mask, {"kind": "worker", "value": name, "worker_id": wid}
    if kind == "host":
        wh = spec.worker_hosts or rep.worker_hosts
        if not wh:
            raise ValueError(
                "report has no host provenance; host= targeting needs a "
                "fleet report")
        wids = np.asarray([i for i, h in enumerate(wh) if h == value],
                          np.int64)
        if wids.size == 0:
            known = ", ".join(repr(h) for h in sorted(set(wh)))
            raise ValueError(f"unknown host {value!r}; known hosts: {known}")
        mask = np.isin(crit.worker, wids)
        return mask, {"kind": "host", "value": str(value),
                      "workers": [int(w) for w in wids]}
    if kind == "path":
        rank = int(value)
        if not 1 <= rank <= len(rep.paths):
            raise ValueError(
                f"path rank {rank} out of range 1..{len(rep.paths)}")
        target = rep.paths[rank - 1].stack
        npaths = len(spec.stacks.paths)
        sids = np.asarray([s for s, p in enumerate(spec.stacks.paths)
                           if p == target], np.int64)
        mask = (np.isin(crit.stack_id, sids) if sids.size
                else np.zeros(nrows, bool))
        if target == () and nrows:
            # NO_STACK / out-of-range ids all mean "no path"
            mask = mask | (crit.stack_id < 0) | (crit.stack_id >= npaths)
        return mask, {"kind": "path",
                      "value": rep.path_str(rep.paths[rank - 1]),
                      "rank": rank}
    raise ValueError(f"unknown target kind {kind!r}")


# ---------------------------------------------------------------------------
# results
# ---------------------------------------------------------------------------

def _finite(x: float) -> float | None:
    return float(x) if math.isfinite(x) else None


@dataclasses.dataclass
class WhatIfResult:
    """One counterfactual projection.  ``report`` is the full
    counterfactual :class:`~repro_torch.core.detector.BottleneckReport` (it
    carries its own replay handle, so projections compose); everything
    else is JSON-ready via :meth:`to_doc`."""

    selection: dict
    shrink: float
    baseline_total_s: float
    projected_total_s: float
    saved_s: float
    speedup: float
    matched_slices: int
    matched_cm_s: float
    compressed_intervals: int
    compressed_s: float
    per_worker: list[dict]
    ranking: list[dict]
    report: object = dataclasses.field(repr=False, default=None)

    def to_doc(self) -> dict:
        """The deterministic JSON document — ``/api/whatif`` serves
        exactly ``json.dumps(self.to_doc(), indent=2)``, so the wire
        bytes match :meth:`to_json` on the same capture."""
        return {
            "schema_version": WHATIF_SCHEMA_VERSION,
            "selection": self.selection,
            "shrink": self.shrink,
            "baseline_total_s": self.baseline_total_s,
            "projected_total_s": self.projected_total_s,
            "saved_s": self.saved_s,
            "speedup": _finite(self.speedup),
            "matched_slices": self.matched_slices,
            "matched_cm_s": self.matched_cm_s,
            "compressed_intervals": self.compressed_intervals,
            "compressed_s": self.compressed_s,
            "per_worker": self.per_worker,
            "ranking": self.ranking,
        }

    def to_json(self) -> str:
        return json.dumps(self.to_doc(), indent=2)


def what_if(rep, tag=None, *, shrink: float = 0.0, host: str | None = None,
            worker=None, path: int | None = None,
            top_n: int = 10) -> WhatIfResult:
    """Project the effect of shrinking one target's critical work.

    Exactly one of ``tag`` (name or id), ``host``, ``worker`` (name or
    id), or ``path`` (1-based rank in ``rep.paths``) selects the target;
    ``shrink`` scales its exclusively-critical time (``0.0`` removes
    it).  Raises ``RuntimeError`` if the report carries no replay
    handle and ``ValueError`` for unknown targets or a ``shrink``
    outside ``[0, 1]``.
    """
    spec = getattr(rep, "replay", None)
    if spec is None:
        raise RuntimeError(
            "report has no replay handle: what-if needs the captured event "
            "log (reports from detect()/detect_offline() and offline "
            "sessions carry one; build_report() alone does not)")
    if not 0.0 <= float(shrink) <= 1.0:
        raise ValueError(f"shrink must be in [0, 1], got {shrink}")
    chosen = [(k, v) for k, v in
              (("tag", tag), ("host", host), ("worker", worker),
               ("path", path)) if v is not None]
    if len(chosen) != 1:
        raise ValueError(
            "select exactly one target: tag=, host=, worker= or path=")
    kind, value = chosen[0]

    clean = spec.log_provider().sanitize()
    with device_lib.use_device(spec.device):
        res = backends_lib.compute(clean, backend=spec.backend)
    crit = res.critical_table(spec.n_min)
    mask, selection = _resolve_target(rep, spec, crit, clean, kind, value)
    matched = int(mask.sum())
    matched_cm = float(crit.cm[mask].sum()) if matched else 0.0

    warped, saved_s, n_comp, comp_s = warp_log(
        clean, crit.start_ns[mask], crit.end_ns[mask], float(shrink))
    wn = spec.resolved_worker_names(clean.num_workers)
    cf = detector_lib.detect_offline(
        warped, spec.tags, spec.stacks, spec.n_min,
        sample_dt_ns=spec.sample_dt_ns, backend=spec.backend,
        top_n=top_n, worker_names=wn, device=spec.device)
    cf.worker_hosts = spec.worker_hosts or rep.worker_hosts

    baseline_total = float(res.total_time)
    projected_total = float(cf.total_time)
    speedup = (baseline_total / projected_total if projected_total > 0
               else math.inf)

    base_rank = {rep.path_str(p): i + 1 for i, p in enumerate(rep.paths)}
    ranking = path_entries(cf, top_n)
    for e in ranking:
        prev = base_rank.get(e["path"])
        e["baseline_rank"] = prev
        e["rank_delta"] = (prev - e["rank"]) if prev is not None else None

    base_pw = np.asarray(res.per_worker, np.float64)
    cf_pw = np.asarray(cf.per_worker, np.float64)
    w = max(base_pw.shape[0], cf_pw.shape[0])
    bp = np.zeros(w)
    bp[:base_pw.shape[0]] = base_pw
    cp = np.zeros(w)
    cp[:cf_pw.shape[0]] = cf_pw
    hosts = spec.worker_hosts or rep.worker_hosts
    per_worker = []
    for wid in range(w):
        row = {"worker": wn[wid] if wid < len(wn) else f"w{wid}",
               "baseline_cmetric_s": float(bp[wid]),
               "projected_cmetric_s": float(cp[wid]),
               "delta_cmetric_s": float(cp[wid] - bp[wid])}
        if hosts and wid < len(hosts):
            row["host"] = hosts[wid]
        per_worker.append(row)

    return WhatIfResult(
        selection=selection, shrink=float(shrink),
        baseline_total_s=baseline_total, projected_total_s=projected_total,
        saved_s=saved_s, speedup=speedup,
        matched_slices=matched, matched_cm_s=matched_cm,
        compressed_intervals=n_comp, compressed_s=comp_s,
        per_worker=per_worker, ranking=ranking, report=cf)


# ---------------------------------------------------------------------------
# sensitivity: perturbation sweep over detection parameters
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SensitivityResult:
    """Rank-stability of the report under detection-parameter
    perturbation (the microarch-sensitivity idea applied to GAPP's own
    knobs: the ``n_min`` criticality threshold and the sampling
    cadence).  A ranking that survives the sweep is trustworthy; one
    that reshuffles is an artifact of the threshold."""

    baseline: dict
    variants: list[dict]
    rank_stability: dict
    summary: dict

    def to_doc(self) -> dict:
        return {
            "schema_version": WHATIF_SCHEMA_VERSION,
            "baseline": self.baseline,
            "variants": self.variants,
            "rank_stability": self.rank_stability,
            "summary": self.summary,
        }

    def to_json(self) -> str:
        return json.dumps(self.to_doc(), indent=2)


def sensitivity(rep, params: dict | None = None, *,
                top_k: int = 5) -> SensitivityResult:
    """Sweep detection parameters and report how stable the ranking is.

    ``params`` may override ``{"n_min_scale": (...), "sample_dt_scale":
    (...)}``; scales multiply the report's own ``n_min`` / sampling
    cadence.  One fold of the capture is shared by every ``n_min``
    variant (criticality is a post-fold filter), so the sweep costs one
    fold plus cheap merges.
    """
    spec = getattr(rep, "replay", None)
    if spec is None:
        raise RuntimeError(
            "report has no replay handle: sensitivity needs the captured "
            "event log")
    knobs = {"n_min_scale": (0.5, 0.75, 1.0, 1.25, 1.5),
             "sample_dt_scale": (0.5, 1.0, 2.0)}
    if params:
        unknown = set(params) - set(knobs)
        if unknown:
            raise ValueError(f"unknown sensitivity params: {sorted(unknown)}")
        knobs.update(params)

    clean = spec.log_provider().sanitize()
    with device_lib.use_device(spec.device):
        res = backends_lib.compute(clean, backend=spec.backend)
    wn = spec.resolved_worker_names(clean.num_workers)

    def build(n_min: float, samples):
        crit = res.critical_table(n_min)
        return detector_lib.build_report(
            crit, samples, spec.stacks, n_min,
            per_worker=res.per_worker, worker_names=wn,
            tag_names=list(spec.tags.names),
            tag_locations=list(spec.tags.locations),
            total_slices=res.num_slices, idle_time=res.idle_time,
            total_time=res.total_time, top_n=top_k,
            worker_hosts=spec.worker_hosts)

    base_top = [rep.path_str(p) for p in rep.paths[:top_k]]
    variants: list[dict] = []
    for s in knobs["n_min_scale"]:
        r = build(spec.n_min * float(s), spec.samples)
        variants.append({
            "param": "n_min_scale", "value": float(s),
            "n_min": spec.n_min * float(s),
            "critical_slices": r.total_critical,
            "top": [r.path_str(p) for p in r.paths],
        })
    if spec.sample_dt_ns:
        for s in knobs["sample_dt_scale"]:
            dt = max(int(spec.sample_dt_ns * float(s)), 1)
            samples = simulate_samples(clean, dt, spec.n_min)
            r = build(spec.n_min, samples)
            variants.append({
                "param": "sample_dt_scale", "value": float(s),
                "sample_dt_ns": dt,
                "critical_slices": r.total_critical,
                "top": [r.path_str(p) for p in r.paths],
            })

    base_set = set(base_top)
    top1_agree = 0
    for v in variants:
        vs = set(v["top"])
        union = len(base_set | vs)
        v["jaccard_vs_baseline"] = (len(base_set & vs) / union
                                    if union else 1.0)
        v["top1_agrees"] = bool(
            v["top"] and base_top and v["top"][0] == base_top[0])
        top1_agree += int(v["top1_agrees"])

    rank_stability = {}
    for i, p in enumerate(base_top, 1):
        ranks = [v["top"].index(p) + 1 for v in variants if p in v["top"]]
        rank_stability[p] = {
            "baseline_rank": i,
            "min_rank": min(ranks) if ranks else None,
            "max_rank": max(ranks) if ranks else None,
            "present_in": len(ranks),
            "variants": len(variants),
        }

    n_var = len(variants)
    summary = {
        "variants": n_var,
        "top1_stability": (top1_agree / n_var) if n_var else 1.0,
        "mean_jaccard": (sum(v["jaccard_vs_baseline"] for v in variants)
                         / n_var) if n_var else 1.0,
        "stable": bool(n_var == 0 or top1_agree == n_var),
    }
    return SensitivityResult(
        baseline={"n_min": spec.n_min, "sample_dt_ns": spec.sample_dt_ns,
                  "top": base_top},
        variants=variants, rank_stability=rank_stability, summary=summary)
