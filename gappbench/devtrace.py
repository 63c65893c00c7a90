"""The traced run: ``torch.profiler`` over the window, reduced to what the
per-layer readers and the result's ``device`` and ``breakdown`` need.

The window is marked by the span ``gappbench/window``.  The device's busy
time is the union of its kernels, copies and sets inside that span; an
idle gap is a stretch of the window with nothing on the device, named by
the innermost host operation or harness span (``gappbench/...``) that was
open on the thread running the window at the gap's middle.
"""
from __future__ import annotations

import collections

import torch

WINDOW = "gappbench/window"


class Tracing:
    """Opens and closes the profiler around the window; a no-op when off."""

    def __init__(self, on: bool, device):
        self.on = on
        self.device = device
        self.prof = None
        self._span = None

    @property
    def mark(self):
        return torch.profiler.record_function if self.on else None

    def open(self) -> None:
        if not self.on:
            return
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        self._span = torch.profiler.record_function(WINDOW)
        self._span.__enter__()

    def close(self) -> None:
        if not self.on or self._span is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._span.__exit__(None, None, None)
        self._span = None
        self.prof.stop()

    def summary(self) -> dict | None:
        return summarize(self.prof) if self.prof is not None else None


def _annotation(e) -> bool:
    """A span's mirror on the device's timeline (``record_function`` shows
    there too), which is no device work."""
    if e.name().startswith("gappbench/"):
        return True
    flag = getattr(e, "is_user_annotation", None)      # not in torch 2.11
    kind = getattr(e, "activity_type", None)
    return bool(flag and flag()) or (
        kind is not None and "annotation" in str(kind()).lower())


def _union(intervals: list) -> list:
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def summarize(prof) -> dict:
    """Busy seconds, the window's seconds, device time and launches by
    kernel name, and idle seconds by what the host was doing."""
    events = prof.profiler.kineto_results.events()
    win = next((e for e in events if e.name() == WINDOW), None)
    if win is None:
        raise RuntimeError("the trace holds no window span")
    w0, w1 = win.start_ns(), win.end_ns()
    main = win.start_thread_id()
    dev, host = [], []
    by_name: dict = collections.defaultdict(lambda: [0.0, 0])
    for e in events:
        a, b = e.start_ns(), e.end_ns()
        if b <= w0 or a >= w1:
            continue
        if e.device_type() != torch.autograd.DeviceType.CPU:
            if _annotation(e):
                continue
            a, b = max(a, w0), min(b, w1)
            dev.append((a, b))
            k = by_name[e.name()]
            k[0] += (b - a) * 1e-9
            k[1] += 1
        elif e.start_thread_id() == main and e.name() != WINDOW:
            host.append((a, b, e.name()))
    busy = _union(dev)
    busy_s = sum(b - a for a, b in busy) * 1e-9
    gaps = []
    edge = w0
    for a, b in busy:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    if edge < w1:
        gaps.append((edge, w1))
    idle = _name_gaps(gaps, host)
    return {"busy_s": busy_s, "window_s": (w1 - w0) * 1e-9,
            "kernels": {k: v for k, v in by_name.items()},
            "idle": idle}


def _name_gaps(gaps: list, host: list) -> dict:
    """Idle seconds by the innermost host span open at each gap's middle
    (host spans on one thread nest, so a stack sweep finds it)."""
    host.sort(key=lambda h: (h[0], -h[1]))
    out: dict = collections.defaultdict(float)
    stack: list = []
    j = 0
    for a, b in sorted(gaps):
        mid = (a + b) // 2
        while j < len(host) and host[j][0] <= mid:
            while stack and stack[-1][1] <= host[j][0]:
                stack.pop()
            stack.append(host[j])
            j += 1
        while stack and stack[-1][1] <= mid:
            stack.pop()
        name = stack[-1][2] if stack else "(no host span)"
        out[name] += (b - a) * 1e-9
    return dict(out)


def breakdown(summary: dict) -> dict:
    """The result's ``breakdown``: the ten device operations that took most
    time and the ten host operations the device waited on most."""
    ops = sorted(summary["kernels"].items(), key=lambda kv: -kv[1][0])[:10]
    gaps = sorted(summary["idle"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k[:120], v[0]] for k, v in ops],
            "idle_gaps": [[k[:120], v] for k, v in gaps]}
