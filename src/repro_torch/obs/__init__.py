"""Observability primitives for the continuous-profiling service.

Small, dependency-free building blocks the serving layer
(:mod:`repro_torch.fleet.service`) composes:

* :mod:`repro_torch.obs.http` — just enough HTTP/1.1 to parse a GET and frame
  a response (plus chunked transfer for ``/api/stream``), all pure
  functions over byte buffers so the selector event loop never blocks;
* :mod:`repro_torch.obs.prom` — Prometheus text exposition over the profiler's
  own stats dicts (no client library);
* :mod:`repro_torch.obs.payload` — the shared top-N/host-lanes payload builder
  behind ``session.watch(..., payload=True)`` and ``GET /api/stream``;
* :mod:`repro_torch.obs.dashboard` — the inline no-dependency HTML dashboard
  served at ``GET /``.
"""
from repro_torch.obs.http import (HttpError, Request, chunk, parse_request,
                            response, stream_head)
from repro_torch.obs.payload import build_watch_payload
from repro_torch.obs.prom import flatten_stats, render_metrics

__all__ = [
    "HttpError", "Request", "build_watch_payload", "chunk",
    "flatten_stats", "parse_request", "render_metrics", "response",
    "stream_head",
]
