"""Report exporter registry — the output-side twin of :mod:`backends`.

Every way of getting a :class:`~repro_torch.core.detector.BottleneckReport` out of
the profiler registers here under a short name, mirroring the CMetric
backend registry: ``register_exporter(name, fn, capabilities=...)`` and
``export(report, fmt, ...)`` dispatches by name, so new output formats plug
in without touching the pipeline.  Built-ins:

* ``"text"``     — :func:`repro_torch.core.report.render_text` (Figure-7 profile)
* ``"json"``     — :func:`repro_torch.core.report.to_json` (versioned schema)
* ``"chrome"``   — :func:`repro_torch.core.timeline.to_chrome_trace`; needs the
  event log, which it pulls from ``session=`` (a
  :class:`~repro_torch.core.session.ProfileSession`) or an explicit ``log=``
* ``"callback"`` — invokes ``callback(report)`` (one-shot push)
* ``"watch"``    — subscribes ``callback`` to *live* incremental reports on
  a session (``export(rep, "watch", session=s, callback=cb, every=0.5)``
  == ``s.watch(cb, every=0.5)``); the session's background drain worker
  pushes a fresh top-N report every ``every`` seconds while the workload
  runs.  Returns the unsubscribe handle.

Exporter signature: ``fn(report, *, session=None, **kw)``; ``session`` is
the originating session when the export goes through
:meth:`ProfileSession.export`, giving exporters access to the event log and
live state without the report having to carry them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable

from repro_torch.core.report import render_text, to_json
from repro_torch.core.timeline import to_chrome_trace

ExporterFn = Callable[..., object]


@dataclasses.dataclass(frozen=True)
class Exporter:
    name: str
    fn: ExporterFn
    capabilities: frozenset[str]

    def __call__(self, rep, **kw):
        return self.fn(rep, **kw)


_REGISTRY: dict[str, Exporter] = {}

# Exporters that live in optional packages: resolved on first use so the
# core never imports them eagerly (``session.export("remote", addr=...)``
# just works without an explicit ``import repro_torch.fleet``).
_LAZY_EXPORTERS = {"remote": "repro_torch.fleet.transport"}


def register_exporter(name: str, fn: ExporterFn | None = None, *,
                      capabilities: Iterable[str] = ()) -> ExporterFn:
    """Register ``fn`` as exporter ``name`` (direct call or decorator, like
    :func:`repro_torch.core.backends.register_backend`).  Re-registering a name
    replaces it."""
    def _register(f: ExporterFn) -> ExporterFn:
        _REGISTRY[name] = Exporter(name, f, frozenset(capabilities))
        return f
    return _register(fn) if fn is not None else _register


def unregister_exporter(name: str) -> None:
    _REGISTRY.pop(name, None)


def get_exporter(name: str) -> Exporter:
    try:
        return _REGISTRY[name]
    except KeyError:
        pass
    mod = _LAZY_EXPORTERS.get(name)
    if mod is not None:
        import importlib
        importlib.import_module(mod)    # registers on import
        if name in _REGISTRY:
            return _REGISTRY[name]
    known = ", ".join(sorted(set(available_exporters())
                             | set(_LAZY_EXPORTERS)))
    raise KeyError(
        f"unknown exporter {name!r}; available: {known}") from None


def available_exporters() -> list[str]:
    return sorted(_REGISTRY)


def exporters_with(capability: str) -> list[str]:
    return sorted(e.name for e in _REGISTRY.values()
                  if capability in e.capabilities)


def export(rep, fmt: str = "text", *, session=None, **kw):
    """Dispatch ``rep`` through the named exporter."""
    return get_exporter(fmt)(rep, session=session, **kw)


# ---------------------------------------------------------------------------
# built-ins
# ---------------------------------------------------------------------------

@register_exporter("text", capabilities={"human"})
def _export_text(rep, *, session=None, **kw) -> str:
    out = render_text(rep, **kw)
    if session is not None:
        try:
            stats = session.stats()
        except Exception:
            stats = {}
        src = stats.get("source") or {}
        shed = int(src.get("shed_chunks") or 0)
        lost = int(src.get("lost_chunks") or 0)
        idle = int(src.get("idle_hosts") or 0)
        if shed or lost or idle:
            # degraded capture: the ranking above folded an incomplete
            # stream — say so right next to the numbers it skews
            out += ("\ncapture health: DEGRADED — "
                    f"{shed} chunk(s) shed under overload "
                    "(recoverable from fleet journals), "
                    f"{lost} chunk(s) lost in transit, "
                    f"{idle} idle host(s) released from the watermark\n")
    return out


@register_exporter("json", capabilities={"machine", "versioned"})
def _export_json(rep, *, session=None, **kw) -> str:
    """``what_if=N`` (optionally ``what_if_shrink=``) appends the
    counterfactual projections block — computed only on request, so the
    default export (and ``/api/report`` byte-equality) costs nothing."""
    return to_json(rep, **kw)


@register_exporter("chrome", capabilities={"trace"})
def _export_chrome(rep, *, session=None, log=None, path=None,
                   tag_names=None, worker_names=None, critical=None,
                   worker_hosts=None, clock=None) -> str:
    """Chrome-trace JSON.  The report alone does not carry the event stream,
    so the log comes from ``log=`` or ``session.freeze()``; names, host
    lanes and the critical overlay default to the report's.  ``clock``
    puts the times on another trace's clock (see
    :func:`~repro_torch.core.timeline.to_chrome_trace`)."""
    if log is None:
        if session is None:
            raise ValueError("chrome exporter needs log= or session=")
        log = session.freeze()
    data = to_chrome_trace(
        log,
        tag_names=tag_names if tag_names is not None else rep.tag_names,
        worker_names=(worker_names if worker_names is not None
                      else rep.worker_names),
        critical=critical if critical is not None else rep.critical_table,
        worker_hosts=(worker_hosts if worker_hosts is not None
                      else rep.worker_hosts),
        clock=clock)
    if path is not None:
        with open(path, "w") as f:
            f.write(data)
    return data


@register_exporter("callback", capabilities={"push"})
def _export_callback(rep, *, session=None, callback=None, **kw):
    if callback is None:
        raise ValueError("callback exporter needs callback=")
    callback(rep)
    return rep


@register_exporter("watch", capabilities={"push", "live", "incremental",
                                          "subscription"})
def _export_watch(rep, *, session=None, callback=None, every: float = 0.5,
                  top_n: int | None = None, payload: bool = False, **kw):
    """Subscribe ``callback`` to live top-N updates on ``session``; the
    drain worker pushes a fresh incremental report every ``every`` seconds
    (plus one final report at close).  Returns the unsubscribe handle.
    ``payload=True`` delivers the JSON-ready ``/api/stream`` frame (with
    ``worker_hosts``/``per_host`` lanes and ``health``) instead of the
    report object — see :func:`repro_torch.obs.payload.build_watch_payload`."""
    if session is None or callback is None:
        raise ValueError("watch exporter needs session= and callback=")
    return session.watch(callback, every=every, top_n=top_n,
                         payload=payload)
