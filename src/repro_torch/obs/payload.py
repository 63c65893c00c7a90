"""The shared live-payload builder behind watch callbacks and the wire.

``session.watch(cb, payload=True)``, ``GET /api/stream`` and the
dashboard's poll loop all consume the same JSON-ready dict built here —
one builder, so the callback surface and the HTTP surface cannot drift
(watch payloads carry the ``worker_hosts`` / ``per_host`` host lanes by
reusing exactly this).
"""
from __future__ import annotations

from repro_torch.core.report import path_entries

#: Version of the payload layout (independent of the report JSON schema;
#: bump on breaking changes).
PAYLOAD_SCHEMA_VERSION = 1

# Capture-health counters surfaced under ``health`` — session-level keys
# first, then fleet-source keys (present only when the session reads a
# FleetSource).  Missing keys are simply absent, so single-host sessions
# get the slim form.
_SESSION_HEALTH_KEYS = ("events_pending", "ring_dropped",
                        "tolerance_dropped", "sanitize_dropped",
                        "watch_errors")
_SOURCE_HEALTH_KEYS = ("hosts", "buffered_rows", "shed_chunks",
                       "shed_rows", "clock_clamped", "idle_hosts",
                       "accepting")


def build_watch_payload(session, rep=None, top_n: int | None = None) -> dict:
    """One JSON-ready frame of live profile state.

    ``rep`` is the report to summarise (computed via
    ``session.snapshot(top_n)`` when not given — pass it when the caller
    already has this tick's snapshot, e.g. the watch firing loop, so the
    fold is not paid twice).
    """
    if rep is None:
        rep = session.snapshot(top_n)
    stats = session.stats()
    fleet = rep.worker_hosts is not None and len(rep.worker_hosts) > 0
    health = {k: stats[k] for k in _SESSION_HEALTH_KEYS if k in stats}
    source = stats.get("source")
    if isinstance(source, dict):
        for k in _SOURCE_HEALTH_KEYS:
            if k in source:
                health[k] = source[k]
    return {
        "schema_version": PAYLOAD_SCHEMA_VERSION,
        "mode": stats.get("mode"),
        "events_folded": stats.get("events_folded", 0),
        "total_time_s": rep.total_time,
        "total_slices": rep.total_slices,
        "total_critical": rep.total_critical,
        "critical_ratio": rep.critical_ratio,
        "top": path_entries(rep, top_n),
        "worker_hosts": list(rep.worker_hosts) if fleet else [],
        "per_host": rep.per_host() if fleet else {},
        "health": health,
    }
