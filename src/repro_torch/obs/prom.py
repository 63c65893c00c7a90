"""Prometheus text exposition (format 0.0.4) without a client library.

The profiler's self-telemetry already lives in plain stats dicts
(``session.stats()``, ``IngestServer.stats()``, ``RemoteSink.stats()``,
``ProfilerService.stats()``); :func:`flatten_stats` turns any of them
into metric samples and :func:`render_metrics` prints the exposition.
Every sample is exported as a gauge: most of the underlying values are
monotonic counters, but the stats dicts are snapshots with no reset
protocol, and gauges keep ``rate()``-style queries working without
lying about counter semantics.

Metric names are ``<prefix>_<key>`` with nested dicts joined by ``_``;
the key set is pinned to the JAX package's by the port's tests, so a renamed
counter fails CI before it silently breaks someone's dashboards.
"""
from __future__ import annotations

import re
from typing import Iterable, Iterator

_NAME_BAD = re.compile(r"[^a-zA-Z0-9_]")

#: One exported sample: (metric_name, labels-or-None, float value).
Sample = tuple  # (str, dict | None, float)


def sanitize_name(name: str) -> str:
    """Coerce a stats key into a legal metric-name component."""
    out = _NAME_BAD.sub("_", str(name))
    if not out or out[0].isdigit():
        out = "_" + out
    return out


def escape_label(value) -> str:
    return (str(value).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _fmt(value: float) -> str:
    f = float(value)
    if f.is_integer() and abs(f) < 2 ** 53:
        return str(int(f))
    return repr(f)


def flatten_stats(prefix: str, stats: dict,
                  labels: dict | None = None) -> Iterator[Sample]:
    """Yield one gauge sample per numeric/bool leaf of ``stats``.

    Nested dicts extend the metric name (``a: {b: 1}`` ->
    ``<prefix>_a_b``); strings, lists and ``None`` leaves are skipped —
    they are identity/config, not telemetry.  ``labels`` (e.g.
    ``{"host": hid}``) is attached to every yielded sample.
    """
    for key, value in stats.items():
        name = f"{prefix}_{sanitize_name(key)}"
        if isinstance(value, bool):
            yield (name, labels, 1.0 if value else 0.0)
        elif isinstance(value, (int, float)):
            yield (name, labels, float(value))
        elif isinstance(value, dict):
            yield from flatten_stats(name, value, labels)


def render_metrics(samples: Iterable[Sample],
                   help_text: dict[str, str] | None = None) -> str:
    """Render samples as the Prometheus text format, grouped and sorted
    by metric name (a stable exposition diffs cleanly in tests)."""
    by_name: dict[str, list] = {}
    for name, labels, value in samples:
        by_name.setdefault(name, []).append((labels, value))
    lines: list[str] = []
    for name in sorted(by_name):
        if help_text and name in help_text:
            lines.append(f"# HELP {name} {help_text[name]}")
        lines.append(f"# TYPE {name} gauge")
        for labels, value in by_name[name]:
            if labels:
                lab = ",".join(f'{sanitize_name(k)}="{escape_label(v)}"'
                               for k, v in sorted(labels.items()))
                lines.append(f"{name}{{{lab}}} {_fmt(value)}")
            else:
                lines.append(f"{name} {_fmt(value)}")
    return "\n".join(lines) + "\n"
