"""CMetric backend registry.

Every offline CMetric implementation (the numpy float64 oracle, the
data-parallel vector formulation and the fused CUDA pipeline) registers
itself here under a short name with a set of capability tags.  ``compute``
dispatches by name; callers that want
"whatever runs on device" can select by capability instead of hardcoding a
backend string.

The registry replaces the old module-level ``_BACKENDS`` dict in
``repro_torch.core.cmetric`` plus the special-cased lazy ``pallas`` import in
``cmetric.compute``: a backend may register a loader that defers heavy
imports (the CUDA kernels) until first use, so importing ``repro_torch.core``
never builds or loads a kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable

# A backend maps an EventLog to a CMetricResult; typed loosely to keep this
# module import-cycle-free (cmetric imports backends, not vice versa).
BackendFn = Callable[..., object]


@dataclasses.dataclass(frozen=True)
class Backend:
    name: str
    fn: BackendFn
    capabilities: frozenset[str]
    # carry-resumable chunk fold: (FoldCarry, EventLog) -> (FoldCarry,
    # SliceTable).  Optional — backends without one only support whole-log
    # computes; ``fold_chunk`` below raises for them.
    chunk_fn: BackendFn | None = None

    def __call__(self, log):
        return self.fn(log)


_REGISTRY: dict[str, Backend] = {}


def register_backend(name: str, fn: BackendFn | None = None, *,
                     capabilities: Iterable[str] = (),
                     fold_chunk: BackendFn | None = None) -> BackendFn:
    """Register ``fn`` as CMetric backend ``name``.

    Usable directly (``register_backend("numpy", compute_numpy)``) or as a
    decorator (``@register_backend("mine", capabilities={"device"})``).
    ``fold_chunk`` optionally attaches the backend's carry-resumable chunk
    fold (see :class:`repro_torch.core.cmetric.FoldCarry`).  Re-registering a
    name replaces it (tests swap in instrumented backends).
    """
    def _register(f: BackendFn) -> BackendFn:
        _REGISTRY[name] = Backend(name, f, frozenset(capabilities),
                                  fold_chunk)
        return f
    return _register(fn) if fn is not None else _register


def unregister_backend(name: str) -> None:
    _REGISTRY.pop(name, None)


def get_backend(name: str) -> Backend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown CMetric backend {name!r}; available: "
            f"{', '.join(available_backends())}") from None


def available_backends() -> list[str]:
    return sorted(_REGISTRY)


def backends_with(capability: str) -> list[str]:
    """Names of backends advertising ``capability`` (e.g. 'device')."""
    return sorted(b.name for b in _REGISTRY.values()
                  if capability in b.capabilities)


def compute(log, backend: str = "numpy"):
    """Dispatch an EventLog through the named backend."""
    return get_backend(backend)(log)


def backends_with_fold_chunk() -> list[str]:
    """Names of backends that support the carry-resumable chunk fold."""
    return sorted(b.name for b in _REGISTRY.values()
                  if b.chunk_fn is not None)


def fold_chunk(carry, log, backend: str = "numpy"):
    """Advance a :class:`repro_torch.core.cmetric.FoldCarry` over one chunk with
    the named backend; returns ``(carry, SliceTable)``."""
    b = get_backend(backend)
    if b.chunk_fn is None:
        raise ValueError(f"backend {backend!r} has no chunked fold; "
                         f"available: {', '.join(backends_with_fold_chunk())}")
    return b.chunk_fn(carry, log)
