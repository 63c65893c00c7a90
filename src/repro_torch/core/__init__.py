"""GAPP core on PyTorch/CUDA: criticality-metric serialization-bottleneck
profiler, offline analysis path.

The offline dataflow (``detect_offline``)::

    EventLog → §3.2 sanitize → CMetric backend → SliceTable
      → detector (sample attachment, path merge, (path, tag) tables)
      → BottleneckReport → exporter registry (text | json | chrome | ...)

CMetric backends (``backends.py``): ``numpy`` (the float64 oracle),
``vector`` (torch ops on the device) and ``fused`` (alias ``pallas``: the
CUDA fold kernel plus pairing on the device, with the detector's histogram
on the ``tag_hist`` kernel).  ``detect_offline(chunk_events=...)`` streams
the same pipeline through the carry-resumable chunk fold
(``fold_chunk``/``FoldCarry``), whose fused prefix runs on the
``carry_cumsum`` kernel.  Device work runs on
:func:`repro_torch.device.default_device` (CUDA) unless ``device=`` says
otherwise.

The live session, spill store and deprecated ``Gapp`` wrappers of the JAX
package are not ported yet.
"""
from repro_torch.core.events import (ACTIVATE, DEACTIVATE, EventLog,
                                     EventRing, EventStore, ShardedEventRing,
                                     sanitize_chunk, synthetic_log,
                                     tolerance_keep)
from repro_torch.core.slices import (CriticalBuffer, CriticalSlice,
                                     CriticalTable, SliceTable)
from repro_torch.core.backends import (available_backends, backends_with,
                                       backends_with_fold_chunk, get_backend,
                                       register_backend)
from repro_torch.core.cmetric import (CMetricResult, FoldCarry, compute,
                                      compute_numpy, compute_vectorized,
                                      fold_chunk)
from repro_torch.core.tracer import (LockedTracer, StackRegistry, TagRegistry,
                                     Tracer, WorkerHandle)
from repro_torch.core.sampler import (SampleBuffer, SamplingProbe,
                                      simulate_samples)
from repro_torch.core.detector import (BottleneckReport, PathProfile,
                                       build_report, detect, detect_offline,
                                       merge_table)
from repro_torch.core.report import imbalance_stats, render_text, to_json
from repro_torch.core.exporters import (available_exporters, export,
                                        get_exporter, register_exporter)
from repro_torch.core.wakers import (classify_report, classify_tag,
                                     critical_wakers, waker_edges)
from repro_torch.core.timeline import dump_chrome_trace, to_chrome_trace

__all__ = [
    "ACTIVATE", "DEACTIVATE", "EventLog", "EventRing", "EventStore",
    "ShardedEventRing", "sanitize_chunk", "synthetic_log", "tolerance_keep",
    "SliceTable", "CriticalTable", "CriticalBuffer", "CriticalSlice",
    "available_backends", "backends_with", "backends_with_fold_chunk",
    "get_backend", "register_backend",
    "CMetricResult", "FoldCarry", "compute", "compute_numpy",
    "compute_vectorized", "fold_chunk",
    "StackRegistry", "TagRegistry", "Tracer", "LockedTracer", "WorkerHandle",
    "SampleBuffer", "SamplingProbe", "simulate_samples",
    "BottleneckReport", "PathProfile", "build_report", "detect",
    "detect_offline", "merge_table", "imbalance_stats", "render_text",
    "to_json", "available_exporters", "export", "get_exporter",
    "register_exporter",
    "classify_report", "classify_tag", "critical_wakers", "waker_edges",
    "dump_chrome_trace", "to_chrome_trace",
]
