"""GAPP core on PyTorch/CUDA: criticality-metric serialization-bottleneck
profiler.

Architecture — capture, analysis and output are one streaming pipeline
around a :class:`~repro_torch.core.session.ProfileSession`::

    EventSource (``session.py``)
      ├── TracerSource   live sharded lock-free capture (``tracer.py``)
      ├── LogSource      offline EventLog replay in chunk_events batches
      └── SpillSource    replay of a disk-spilled capture (``spill.py``)
        │
        ▼  background drain+fold worker (overlaps capture)
    drain      k-way-merge the per-worker shards by timestamp
    sanitize   §3.2 tolerance rules against the carried per-worker state
    fold       carry-resumable ``fold_chunk``/``FoldCarry`` (``cmetric.py``)
               — the paper's Table-1 eBPF-map state, advanced batch-wise;
               backends registered in ``backends.py``
               (numpy | stream | vector | fused, alias pallas)
    store      accumulated log: in-RAM ``EventStore`` or an append-only
               disk ``SpillStore`` (resident memory O(chunk_events))
        │
        ▼  at any time, without stopping the workload
    session.snapshot()  →  Detector (``detector.py``, vectorised over the
                           columnar SliceTable of ``slices.py``): sample
                           attachment, path merge, tag tables
        │
        ▼
    BottleneckReport → exporter registry (``exporters.py``:
        text | json | chrome | callback | watch | remote) —
        ``session.export(fmt)`` or live push via ``session.watch(...)``

CMetric backends: ``numpy`` (the float64 oracle), ``stream`` (the
paper-faithful float32 walk on the CUDA ``stream_scan`` kernel),
``vector`` (torch ops on the device) and ``fused`` (the CUDA fold kernel
plus pairing on the device; its chunk fold's prefix on the
``carry_cumsum`` kernel, and the detector's histogram on the ``tag_hist``
kernel).  The session, ``compute()`` and ``detect_offline()`` default to
``fused``.  Device work runs on :func:`repro_torch.device.default_device`
(CUDA) unless ``device=`` says otherwise; a ``Tracer``/``ProfileSession``
resolves its device once, at construction, and holds it on every thread
that drains or reads it.

``session.result()`` quiesces and returns the final report — bit-equal on
the ``numpy`` backend to ``detect_offline`` over the frozen log, for any
drain/snapshot schedule.  ``Gapp``/``profile_log`` (``profiler.py``) are
deprecated thin wrappers kept for old call sites.

Multi-host: the :mod:`repro_torch.fleet` package streams drained chunks
over a socket (``RemoteSink`` → ``IngestServer``, attached via
``session.export("remote", addr=...)``) and merges N host streams into
one session through ``FleetSource`` — same pipeline, reports carry host
provenance (``report.worker_hosts`` / per-host exporter lanes).

The offline dataflow (``detect_offline``) is the same pipeline driven
synchronously: EventLog → sanitize → CMetric backend → SliceTable →
detector → report; ``detect_offline(chunk_events=...)`` streams it through
the identical chunk fold in bounded memory.
"""
from repro_torch.core.events import (ACTIVATE, DEACTIVATE, EventLog, EventRing,
                                     EventStore, ShardedEventRing, sanitize_chunk,
                                     synthetic_log, tolerance_keep)
from repro_torch.core.slices import (CriticalBuffer, CriticalSlice, CriticalTable,
                                     SliceTable)
from repro_torch.core.backends import (available_backends, backends_with,
                                       backends_with_fold_chunk, get_backend,
                                       register_backend)
from repro_torch.core.cmetric import (CMetricResult, FoldCarry, compute,
                                      compute_numpy, compute_streaming,
                                      compute_vectorized, fold_chunk)
from repro_torch.core.tracer import (LockedTracer, StackRegistry, TagRegistry,
                                     Tracer, WorkerHandle)
from repro_torch.core.sampler import SampleBuffer, SamplingProbe, simulate_samples
from repro_torch.core.detector import (BottleneckReport, PathProfile, build_report,
                                       detect, detect_offline, merge_table)
from repro_torch.core.report import imbalance_stats, render_text, to_json
from repro_torch.core.spill import SpillStore
from repro_torch.core.exporters import (available_exporters, export, get_exporter,
                                        register_exporter)
from repro_torch.core.session import (EventSource, LogSource, ProfileSession,
                                      SpillSource, TracerSource)
from repro_torch.core.profiler import Gapp, profile_log

__all__ = [
    "ACTIVATE", "DEACTIVATE", "EventLog", "EventRing", "EventStore",
    "ShardedEventRing", "sanitize_chunk", "synthetic_log", "tolerance_keep",
    "SliceTable", "CriticalTable", "CriticalBuffer", "CriticalSlice",
    "available_backends", "backends_with", "backends_with_fold_chunk",
    "get_backend", "register_backend",
    "CMetricResult", "FoldCarry", "compute", "compute_numpy",
    "compute_streaming", "compute_vectorized", "fold_chunk",
    "StackRegistry", "TagRegistry", "Tracer", "LockedTracer", "WorkerHandle",
    "SampleBuffer", "SamplingProbe", "simulate_samples",
    "BottleneckReport", "PathProfile", "build_report", "detect",
    "detect_offline", "merge_table", "imbalance_stats", "render_text",
    "to_json",
    "SpillStore", "available_exporters", "export", "get_exporter",
    "register_exporter",
    "ProfileSession", "EventSource", "TracerSource", "LogSource",
    "SpillSource",
    "Gapp", "profile_log",
]
from repro_torch.core.wakers import (classify_report, classify_tag,  # noqa: E402
                                     critical_wakers, waker_edges)

__all__ += ["classify_report", "classify_tag", "critical_wakers",
            "waker_edges"]
from repro_torch.core.timeline import dump_chrome_trace, to_chrome_trace  # noqa: E402,F401

__all__ += ["dump_chrome_trace", "to_chrome_trace"]
