"""Deprecated facades over :class:`~repro_torch.core.session.ProfileSession`.

``Gapp`` and ``profile_log`` were the original batch-shaped API (capture
everything, ``freeze()``, detect once).  The profiler is now streaming-first:
use :class:`ProfileSession` directly —

=====================================  =====================================
old                                    new
=====================================  =====================================
``g = Gapp(...)``                      ``s = ProfileSession(...)``
``with g.running(): ...``              ``with s.running(): ...`` (or ``with s:``)
``g.report()``                         ``s.snapshot()`` (any time, live) /
                                       ``s.result()`` (final, on close)
``g.render()``                         ``s.export("text")``
``g.freeze()``                         ``s.freeze()``
``g.offline_report(backend=...)``      ``s.offline_report(backend=...)``
``profile_log(log, ...)``              ``ProfileSession.offline(log, ...).result()``
=====================================  =====================================

Both wrappers keep working (they delegate everything to a session and stay
bit-compatible on the ``numpy`` fold backend; like the session they default
to the ``fused`` backend on CUDA unless ``device=`` says otherwise) but new
call sites should
speak session: it adds the background drain+fold worker, ``watch()`` live
updates, the exporter registry and disk spill (``spill_path=``).
"""
from __future__ import annotations

import warnings

from repro_torch.core import detector as detector_lib
from repro_torch.core.events import EventLog
from repro_torch.core.session import ProfileSession
from repro_torch.core.tracer import StackRegistry, TagRegistry


class Gapp:
    """Deprecated live facade (tracer + probe + detection) — now a thin
    wrapper over one :class:`ProfileSession`; see the module docstring for
    the migration table.  ``.session`` exposes the underlying session;
    ``.tracer``/``.probe`` remain for existing call sites."""

    def __init__(self, n_min: float | None = None, dt: float = 0.003,
                 top_m: int = 8, top_n: int = 10, capacity: int = 1 << 16,
                 clock=None, fold_backend: str = "fused",
                 autoflush: bool = True, spill_path: str | None = None,
                 chunk_events: int = 1 << 16, device=None):
        warnings.warn("Gapp is deprecated; use repro_torch.core.ProfileSession",
                      DeprecationWarning, stacklevel=2)
        self.session = ProfileSession(
            n_min=n_min, dt=dt, top_m=top_m, top_n=top_n, capacity=capacity,
            clock=clock, fold_backend=fold_backend, autoflush=autoflush,
            spill_path=spill_path, chunk_events=chunk_events, device=device)
        self.tracer = self.session.tracer
        self.probe = self.session.probe
        self.top_n = top_n

    # --- worker / span API (delegates) ------------------------------------
    def register_worker(self, name: str, kind: str = "thread") -> int:
        return self.session.register_worker(name, kind)

    def handle(self, wid: int):
        """The worker's lock-free probe endpoint (hot-path begin/end)."""
        return self.session.handle(wid)

    def span(self, wid: int, tag: str):
        return self.session.span(wid, tag)

    def frame(self, wid: int, tag: str):
        return self.session.frame(wid, tag)

    def begin(self, wid: int, tag: str, loc: str | None = None) -> int:
        # Hot-path fix: the seed walked sys._getframe and built a location
        # string on EVERY begin; the callsite is now resolved once per
        # distinct tag inside the tracer (or passed explicitly via loc=).
        return self.session.begin(wid, tag, loc)

    def end(self, wid: int) -> None:
        return self.session.end(wid)

    def ingest(self, *a, **k):
        return self.session.ingest(*a, **k)

    # --- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        self.session.start()

    def stop(self) -> None:
        self.session.stop()

    def running(self):
        return self.session.running()

    # --- results -------------------------------------------------------------
    def report(self, top_n: int | None = None):
        return self.session.snapshot(top_n or self.top_n)

    def render(self, **kw) -> str:
        return self.session.export("text", **kw)

    def freeze(self) -> EventLog:
        return self.session.freeze()

    def offline_report(self, backend: str = "vector",
                       sample_dt_ns: int | None = None,
                       top_n: int | None = None,
                       chunk_events: int | None = None):
        return self.session.offline_report(
            backend=backend, sample_dt_ns=sample_dt_ns,
            top_n=top_n or self.top_n, chunk_events=chunk_events)


def profile_log(
    log: EventLog,
    tags: TagRegistry,
    stacks: StackRegistry,
    n_min: float,
    sample_dt_ns: int | None = 3_000_000,
    backend: str = "fused",
    top_n: int = 10,
    worker_names: list[str] | None = None,
    chunk_events: int | None = None,
    device=None,
) -> "detector_lib.BottleneckReport":
    """Deprecated one-call offline pipeline — now
    ``ProfileSession.offline(...).result()``; ``chunk_events`` streams the
    replay in bounded memory."""
    warnings.warn("profile_log is deprecated; use "
                  "repro_torch.core.ProfileSession.offline(log, ...).result()",
                  DeprecationWarning, stacklevel=2)
    return ProfileSession.offline(
        log, tags, stacks, n_min=n_min, backend=backend,
        chunk_events=chunk_events, sample_dt_ns=sample_dt_ns, top_n=top_n,
        worker_names=worker_names, device=device).result()
