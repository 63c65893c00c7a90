"""Profile rendering — the Figure 7 / Table 2 / Figure 4-5 analogues.

These functions are registered as the ``"text"`` and ``"json"`` exporters
in :mod:`repro_torch.core.exporters`; prefer ``session.export(fmt)`` /
``export(report, fmt)`` so new formats stay pluggable.  The JSON schema is
versioned via ``schema_version`` (bump on breaking layout changes).
"""
from __future__ import annotations

import json

import numpy as np

from repro_torch.core.detector import BottleneckReport


def render_text(rep: BottleneckReport, max_paths: int | None = None,
                max_tags: int = 5, bar_width: int = 40,
                what_if: int | None = None,
                what_if_shrink: float = 0.0) -> str:
    """Human-readable profile: ranked call paths with sampled-tag frequency
    tables (Figure 7) followed by the per-worker CMetric chart (Figure 4/5).
    ``what_if=N`` appends counterfactual projections for the top-N paths
    (what removing each path's critical work would be worth)."""
    lines = []
    lines.append("=" * 72)
    lines.append("GAPP bottleneck profile")
    lines.append(f"  wall time        : {rep.total_time * 1e3:10.3f} ms")
    lines.append(f"  idle (n=0) time  : {rep.idle_time * 1e3:10.3f} ms")
    lines.append(f"  timeslices       : {rep.total_slices}")
    lines.append(f"  critical slices  : {rep.total_critical} "
                 f"(CR {100.0 * rep.critical_ratio:.2f}%)")
    ct = rep.critical_table
    if ct is not None and len(ct):
        lines.append("  critical av par  : "
                     f"{float(np.mean(ct.threads_av)):10.2f} "
                     f"(mean over {len(ct)} slices)")
    lines.append("=" * 72)
    paths = rep.paths if max_paths is None else rep.paths[:max_paths]
    for rank, p in enumerate(paths, 1):
        lines.append(f"#{rank}  CMetric {p.cmetric * 1e3:.3f} ms over "
                     f"{p.slices} slice(s)")
        lines.append(f"    path: {rep.path_str(p)}")
        total = sum(p.tag_counts.values())
        for tid, cnt in p.top_tags(max_tags):
            loc = rep.tag_locations[tid] if tid < len(rep.tag_locations) else "?"
            lines.append(f"      {cnt:6d} ({100.0 * cnt / max(total, 1):5.1f}%) "
                         f"{rep.tag_name(tid)}  [{loc}]")
        for tid, cnt in p.stack_top_counts.most_common(max_tags):
            lines.append(f"      {cnt:6d} (stack_top) {rep.tag_name(tid)}")
        lines.append("")
    # bottleneck classification (paper §7 extension)
    from repro_torch.core.wakers import classify_report
    classes = classify_report(rep)
    if classes:
        total_cm = sum(classes.values())
        parts = ", ".join(f"{k} {v / total_cm * 100:.0f}%" for k, v in
                          sorted(classes.items(), key=lambda kv: -kv[1]))
        lines.append(f"critical CMetric by class: {parts}")
        lines.append("")
    # host lanes (fleet reports): fleet-wide roll-up, then one worker lane
    # block per host; single-host reports keep the flat chart
    if rep.worker_hosts:
        lines.append("per-host CMetric")
        per_host = rep.per_host()
        top_h = max((h["cmetric_s"] for h in per_host.values()), default=0.0)
        for host, row in sorted(per_host.items(),
                                key=lambda kv: -kv[1]["cmetric_s"]):
            n = int(bar_width * row["cmetric_s"] / top_h) if top_h > 0 else 0
            av = (f"  av par {row['threads_av_mean']:.2f}"
                  if row["threads_av_mean"] is not None else "")
            lines.append(f"  {host:>24s} {row['cmetric_s'] * 1e3:12.3f} ms "
                         f"|{'#' * n}")
            lines.append(f"  {'':>24s} {row['workers']} worker(s), "
                         f"{row['critical']} critical "
                         f"({row['critical_cm_s'] * 1e3:.3f} ms){av}")
        lines.append("")
    lines.append("per-worker CMetric")
    top = float(np.max(rep.per_worker)) if rep.per_worker.size else 0.0
    for wid in np.argsort(-rep.per_worker):
        v = float(rep.per_worker[wid])
        n = int(bar_width * v / top) if top > 0 else 0
        name = rep.worker_names[wid] if wid < len(rep.worker_names) else str(wid)
        lines.append(f"  {name:>24s} {v * 1e3:12.3f} ms |{'#' * n}")
    if what_if:
        lines.append("")
        lines.append(f"what-if projections (shrink={what_if_shrink:g})")
        for e in what_if_entries(rep, what_if, what_if_shrink):
            sp = (f"{e['speedup']:.3f}x" if e["speedup"] is not None
                  else "inf")
            lines.append(f"  fix #{e['rank']} {e['path']}: {sp} "
                         f"end-to-end (saves {e['saved_s'] * 1e3:.3f} ms)")
    return "\n".join(lines)


# Version of the to_json layout; parsers should check it before relying on
# key positions.  2 == schema_version introduced (layout otherwise as v1);
# 3 == additive host-provenance keys (worker_hosts / per_host, present only
# for fleet reports — v2 parsers keep working);
# 4 == additive "what_if" key (counterfactual projections, present only
# when the export is asked for them via ``what_if=N`` — v3 parsers keep
# working).
JSON_SCHEMA_VERSION = 4


def path_entries(rep: BottleneckReport,
                 max_paths: int | None = None) -> list[dict]:
    """JSON-ready ranked bottleneck entries — the single builder behind
    ``to_json``'s ``paths`` array, the watch/stream payloads and the
    service's ``/api/top``, so the three surfaces cannot drift apart."""
    paths = rep.paths if max_paths is None else rep.paths[:max_paths]
    return [
        {
            "rank": i + 1,
            "path": rep.path_str(p),
            "cmetric_s": p.cmetric,
            "slices": p.slices,
            "samples": {rep.tag_name(t): c for t, c in
                        p.tag_counts.most_common()},
            "stack_top": {rep.tag_name(t): c for t, c in
                          p.stack_top_counts.most_common()},
        }
        for i, p in enumerate(paths)
    ]


def what_if_entries(rep: BottleneckReport, top_n: int,
                    shrink: float = 0.0) -> list[dict]:
    """Counterfactual projections for the top-N ranked paths — the
    ``what_if=N`` sections of the text/json exporters.  Needs the
    report's replay handle (raises ``RuntimeError`` without one)."""
    out = []
    for rank in range(1, min(int(top_n), len(rep.paths)) + 1):
        wi = rep.what_if(path=rank, shrink=shrink)
        out.append({
            "rank": rank,
            "path": wi.selection["value"],
            "shrink": wi.shrink,
            "speedup": wi.to_doc()["speedup"],
            "saved_s": wi.saved_s,
            "projected_total_s": wi.projected_total_s,
        })
    return out


def to_json(rep: BottleneckReport, what_if: int | None = None,
            what_if_shrink: float = 0.0) -> str:
    ct = rep.critical_table
    host_fields = {}
    if rep.worker_hosts:
        host_fields = {"worker_hosts": list(rep.worker_hosts),
                       "per_host": rep.per_host()}
    extra = {}
    if what_if:
        extra["what_if"] = {"shrink": what_if_shrink,
                            "projections": what_if_entries(
                                rep, what_if, what_if_shrink)}
    return json.dumps({
        "schema_version": JSON_SCHEMA_VERSION,
        **host_fields,
        "total_time_s": rep.total_time,
        "idle_time_s": rep.idle_time,
        "total_slices": rep.total_slices,
        "total_critical": rep.total_critical,
        "critical_ratio": rep.critical_ratio,
        "critical_threads_av_mean": (float(np.mean(ct.threads_av))
                                     if ct is not None and len(ct) else None),
        "critical_cm_s": (float(np.sum(ct.cm))
                          if ct is not None and len(ct) else 0.0),
        "per_worker_cmetric_s": rep.per_worker.tolist(),
        "worker_names": rep.worker_names,
        "paths": path_entries(rep),
        **extra,
    }, indent=2)


def imbalance_stats(per_worker: np.ndarray) -> dict:
    """Summary statistics used by the load-balance experiments (Fig. 4/5):
    coefficient of variation and max/mean ratio of per-worker CMetric."""
    pw = np.asarray(per_worker, np.float64)
    mean = float(pw.mean()) if pw.size else 0.0
    return {
        "mean": mean,
        "std": float(pw.std()) if pw.size else 0.0,
        "cv": float(pw.std() / mean) if mean > 0 else 0.0,
        "max_over_mean": float(pw.max() / mean) if mean > 0 else 0.0,
        "argmax": int(pw.argmax()) if pw.size else -1,
    }
