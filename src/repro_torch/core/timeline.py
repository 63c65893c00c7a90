"""Chrome-trace export: drop the event log into chrome://tracing / Perfetto.

Each worker becomes a track; spans become complete ('X') events; critical
slices are emitted on a separate "critical" track with the CMetric attached
as an argument, so the eye goes straight to what the ranking found.

Registered as the ``"chrome"`` exporter in :mod:`repro_torch.core.exporters` —
``session.export("chrome", path=...)`` is the session-first spelling.  The
trace is a pure function of the frozen log, so it is invariant to *when*
the sharded tracer's drains ran during capture (covered by test).
"""
from __future__ import annotations

import json

import numpy as np

from repro_torch.core.events import EventLog
from repro_torch.core.tracer import Tracer


def to_chrome_trace(log: EventLog, tag_names: list[str] | None = None,
                    worker_names: list[str] | None = None,
                    critical=None,
                    worker_hosts: list[str] | None = None,
                    clock=None) -> str:
    """Serialize an EventLog as a Chrome trace JSON string.

    ``clock`` maps the log's nanoseconds (an integer array, or one int)
    onto another trace's, so the two load side by side: for a
    ``torch.profiler`` trace, :class:`repro_torch.spans.ClockMap` less
    the trace's ``baseTimeNanoseconds``.  Without it, times are the log's.

    ``critical``: optional critical slices to overlay — any iterable of
    CriticalSlice rows (a list, a live ``CriticalBuffer`` or a columnar
    ``SliceTable`` / ``CriticalTable``).

    ``worker_hosts`` (fleet reports) renders *host lanes*: each host
    becomes its own process (pid) named after it, with that host's worker
    tracks inside; the critical overlay moves to the lane after the hosts.
    Without it the layout is the single-host one (everything in pid 0).
    """
    hosts: list[str] = []
    pid_of_worker: dict[int, int] = {}
    if worker_hosts:
        hosts = list(dict.fromkeys(worker_hosts))
        pid_of_worker = {w: hosts.index(h)
                         for w, h in enumerate(worker_hosts)}
    crit_pid = len(hosts) if hosts else 1

    def _pid(w: int) -> int:
        return pid_of_worker.get(int(w), 0)

    def at(t):
        return t if clock is None else clock(t)

    times = log.times if clock is None \
        else clock(np.asarray(log.times, np.int64))
    events = []
    open_spans: dict[int, tuple[int, int]] = {}
    for t, w, d, tag in zip(times, log.workers, log.deltas, log.tags):
        if d == 1:
            open_spans[int(w)] = (int(t), int(tag))
        else:
            start = open_spans.pop(int(w), None)
            if start is None:
                continue
            t0, tag0 = start
            name = tag_names[tag0] if tag_names and 0 <= tag0 < len(tag_names) \
                else f"tag{tag0}"
            events.append({
                "name": name, "ph": "X", "pid": _pid(w), "tid": int(w),
                "ts": t0 / 1e3, "dur": (int(t) - t0) / 1e3,
            })
    meta = []
    for pid, host in enumerate(hosts):
        meta.append({"name": "process_name", "ph": "M", "pid": pid,
                     "args": {"name": host}})
    if worker_names:
        for wid, name in enumerate(worker_names):
            meta.append({"name": "thread_name", "ph": "M", "pid": _pid(wid),
                         "tid": wid, "args": {"name": name}})
    for cs in critical or []:
        events.append({
            "name": "CRITICAL", "ph": "X", "pid": crit_pid, "tid": cs.worker,
            "ts": at(cs.start_ns) / 1e3,
            "dur": (at(cs.end_ns) - at(cs.start_ns)) / 1e3,
            "args": {"cmetric_ms": cs.cm * 1e3,
                     "threads_av": cs.threads_av},
        })
    if critical:
        meta.append({"name": "process_name", "ph": "M", "pid": crit_pid,
                     "args": {"name": "critical slices"}})
    return json.dumps({"traceEvents": meta + events,
                       "displayTimeUnit": "ms"})


def dump_chrome_trace(tracer: Tracer, path: str) -> None:
    """Write a tracer's (or ProfileSession's) full trace to ``path``."""
    if hasattr(tracer, "export"):                 # ProfileSession (any source)
        tracer.export("chrome", path=path)
        return
    log = tracer.freeze()
    data = to_chrome_trace(log, tag_names=list(tracer.tags.names),
                           worker_names=tracer.worker_names(),
                           critical=tracer.critical)
    with open(path, "w") as f:
        f.write(data)
