"""repro_torch: the GAPP criticality profiler on PyTorch and CUDA.

A port of the JAX package ``repro`` that mirrors it module for module.
Device work runs on :func:`repro_torch.device.default_device` (CUDA) unless
the caller asks for another device; see :mod:`repro_torch.device`.
"""
