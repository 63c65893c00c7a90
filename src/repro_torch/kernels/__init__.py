"""CUDA kernels for the profiler's post-processing hot spots.

``cmetric_fold`` — coupled prefix scans (active count + global_cm) over the
event stream, and the carry-seeded prefix of the chunked fold; ``tag_hist``
— sample-tag frequency / weighted-CMetric tables; ``decode_attn`` — the
decode step's attention over each slot's written KV-cache rows.  Each
kernel is CUDA C++ for ``sm_90a`` under ``csrc/``, built by ``build.py`` at
first use; each has a plain PyTorch version (in ``ref.py``, or beside its
wrapper in ``decode_attn.py``), which its wrapper runs for CPU tensors;
``ops.py`` holds the public entry points.  (``ops.cmetric_fold``
is not re-exported here, so that ``repro_torch.kernels.cmetric_fold`` stays
the wrapper module.)
"""
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ops import compute_fused, tag_histogram

__all__ = ["ops", "ref", "compute_fused", "tag_histogram"]
