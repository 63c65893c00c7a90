#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's analysis, live, serving, training and recurrent-model paths on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. Setup: the card's name and power limit, the kernels' build (``nvcc`` at
   first use, one process per source, in parallel), and a capture of 2^24
   events made from a seed: 1,024 workers x 8,192 timeslices in
   bulk-synchronous rounds, 64 tags, 50 interned call paths and a sample
   buffer.  Every other round is a serial section: one group of 32 workers
   holds a lock while the other 992 wait, and half of those held slices
   run the injected call path ``INJECTED_PATH``.
2. Each CUDA kernel against its plain PyTorch version, on the card, with
   CUDA-event times beside the kernel's byte bound, the plain version's
   time, one PyTorch call that computes part of the function (``library``;
   for fold the two ``torch.cumsum`` calls alone, int32 deltas and f32
   contributions, without the division, the carry or the idle sum) and the
   like-for-like composite of PyTorch calls (``composite``):
   fold at E = 2^24; carry_cumsum at E = 2^24 and at one main-path chunk
   (2^20 events, the carry on the device);
   tag_hist at S = 2^24 with uniform tags over K = 3,300 and K = 2^20 and
   with skewed tags (90% in 64 bins), weighted; stream_scan on the first
   2^16 events of the capture against its plain version (float32 in event
   order, on the host), then it and its plain version timed at E = 2^24,
   the whole call eager and from a CUDA graph, each of its launches' device
   time from one profiled call, and its chain launch alone against the
   chain bound.
3. The main path: ``detect_offline`` with the fused backend, whole-log and
   with ``chunk_events=1<<20``, checked against the float64 ``numpy``
   chunked fold (per-worker CMetric, slice counts, critical-set flips, the
   top-ranked path), with every kernel's launch count read around it.
   tag_hist is then timed on the keys the detector handed it (no weights).
   Then ``detect_offline`` with the ``stream`` backend whole-log: its
   stream_scan call held against the plain version on the same 2^24
   inputs, slice count equal to the oracle's, every value finite; its
   float32 error against the oracle is printed, not held to a limit (a
   2^24-term float32 chain drops increments below half an ulp by design).
4. Offline session and spill: ``ProfileSession.offline(..., backend=
   "fused", chunk_events=1<<20)`` over the capture, and the capture
   written to a ``SpillStore`` (in a temporary directory) and replayed
   through ``SpillSource`` into a fused session; both checked like phase 3.
5. Live session on the card: a ``ProfileSession`` (fused, CUDA) over 32
   threads, one of which holds a lock-protected ``write_output`` section;
   a mid-run ``snapshot()``, then ``result()`` against ``detect_offline``
   on the frozen log with the ``numpy`` backend, and ``serve()``'s
   ``/api/report`` against ``export("json")``, byte for byte.
6. Fleet: the ``repro_torch.examples.fleet_dashboard`` flow (two hosts'
   ``RemoteSink``s into an ``IngestServer`` with a fleet_dir, a fused
   session over its ``FleetSource``); ``/api/report`` against
   ``export("json")`` and, served from the fleet_dir, ``/api/whatif``
   against the offline ``what_if(...).to_json()``, byte for byte.

7. Serve: the model workload.  Four tiny archs (deepseek-7b, qwen3-32b,
   gemma3-1b, grok-1-314b) in float32, the same parameters forward and
   8 teacher-forced decode steps on the card and on the CPU (rtol/atol
   1e-4, TF32 off); deepseek-7b at its full published width (30 layers,
   d_model 4096, 6.91e9 parameters, float32 masters drawn on the card from
   the seed), decode against forward in float32 at 8 positions (rtol/atol
   1e-3); then the ``serve_engine`` example's flow at full width in
   bfloat16: an ``Engine`` of 8 slots and a 128-slot cache under a GAPP
   ``ProfileSession`` on the card, 16 requests (3 and 7 of 192 tokens),
   every request finished, a long request ranked first, a finite
   ``what_if``.  Before the full width, the tiny deepseek-7b ``Engine``
   in float32 on the card and on the CPU over the same 16 requests (its
   in-place writes, slot reuse and ring wrap): every output token equal.
   After the run, the serving copy's bfloat16 forward and decode logits
   against the float32 forward at rtol/atol 0.15 (the reference's bf16
   bound).  Then 8 decode steps under ``torch.profiler`` (the device's
   busy time and kernels a step), and the same flow without and with
   the session in turns, twice each: ms a step against the decode step's
   byte bound, tokens/s, the host's issue time, the session's drains and
   their latency, and the GAPP overhead ratio (printed, not held to a
   limit).
8. Train: the training path.  The same four tiny archs in float32, the
   same parameters, three ``make_train_step`` steps (backward with remat,
   AdamW) on the card and on the CPU: each loss and the parameters and
   moments after the third at rtol/atol 1e-4 (TF32 off).  Then the
   ``train_lm`` example's flow at gemma3-1b's full published width (26
   layers, d_model 1152, vocab 262,144, 5:1 local:global with a 512-token
   window; 999,811,584 parameters, nothing cut), float32 masters drawn on
   the card from the seed, bf16 compute, B = 4, S = 1,024, each phase a
   ``Trainer`` under a fused GAPP ``ProfileSession`` on the card: phase 1
   healthy for 8 steps with one asynchronous checkpoint at its last step
   (params, mu, nu; ~12 GB in a temporary directory, restored bit for
   bit, then deleted); phase 2 for 8 steps with the loader slowed to 1.5x
   phase 1's step.  Held: every loss and grad norm finite, phase 1's last
   loss below its first, ``trainer``, ``data_loader`` and ``ckpt_writer``
   workers of the report, a ``data/generate`` path among phase 2's top
   two.  Printed: ms a step (median), tokens/s, the step's FLOPs against
   989 TFLOP/s bf16, peak device memory, the checkpoint's bytes, snapshot
   and write seconds, ``torch.profiler`` over 3 steps (device busy time,
   kernels a step, the heaviest kernels and host operators), and the
   GAPP overhead: the healthy flow without and with the session in turns,
   twice each.
9. Recurrent: the two recurrent archs.  Their tiny configs
   (recurrentgemma-2b: RG-LRU + local attention; rwkv6-1.6b) in float32,
   card against CPU: forward and 8 teacher-forced decode steps, and three
   train steps (rtol/atol 1e-4).  Each at its full published width in
   float32 on masters drawn on the card from the seed, teacher-forced
   decode against forward at rtol/atol 1e-3: rwkv6-1.6b (24 layers,
   d_model 2048, head dim 64, chunk 128, vocab 65,536) at B = 1, T = 256,
   two whole chunks, where the gap is printed by position and each
   layer's chunked time mix is held against its steps on the forward's
   own inputs instead; recurrentgemma-2b (26 layers, d_model 2560, lru
   2560, window 2048, vocab 256,000) at B = 2, T = 64; each forward's
   device work under ``torch.profiler`` with its RG-LRU scan or RWKV time
   mix replayed alone; each bfloat16 serving copy's forward and 4 decode
   steps equal to the float32 masters' computing in bfloat16, bit for
   bit, and its logits against float32 printed.  Then phase 7's flow for
   recurrentgemma-2b at full width: the ``serve_engine`` example's 16
   requests on an ``Engine`` of 8 slots and a 128-slot cache in bfloat16
   over the float32 masters under a GAPP session (every request finished,
   a long request ranked first, every kernel call held), the decode
   step's device work, and without/with the session in turns.

Each path of phases 3-9 runs with every kernel's launch count set to 0
just before it and read just after, and must launch the kernels it goes
through.  Every kernel call such a path makes is recorded (its inputs and
outputs, cloned on the card) and held against the kernel's plain version
on the same inputs after the run, at the tolerances of phase 2: so the
kernels are also checked at the shapes the live and fleet paths hand them
(drain chunks of tens of events, a few hundred keys).

The last three lines are the card's name and power limit, one JSON object
with a row per kernel (the other shapes it was timed at under ``shapes``;
``launches`` summed over the paths of phases 3-9), and ``{"ok": true,
"device": {...}}``.

``--profile`` adds one more run of each main-path mode under ``cProfile``
and ``torch.profiler``: the host functions that take the time, and the
device's busy time and idle share over the run; and the host's time by
function over phase 7's profiled decode steps (cProfile).
``--kernels-only --src DIR`` times the kernels of the ``repro_torch`` under
``DIR`` (another checkout's) at the same shapes, phases 2 and the key
histogram only, to set two versions side by side in one run.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet: HBM3 rate, and float32 rate outside the
# tensor cores.  Both assume the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# Cycles from one dependent float32 add to the next on an SM: "about 4"
# for most arithmetic instructions on compute capability 7.x and later
# (CUDA C++ Programming Guide, "Maximize Utilization", multiprocessor
# level).  The stream scan's chain bound is E of them at the SM clock.
FADD_LATENCY_CYCLES = 4

INJECTED_PATH = (0, 1, 2, 3)   # main > train_step > allreduce > lock_acquire
WAIT_PATH = (0, 1, 4)          # main > train_step > barrier_wait
T0_NS = 1_000_000_000_000      # the capture clock's origin
PARALLEL_US, SERIAL_US, HELD_US = 600, 820, 800
SEED = 0
REPEATS = 20                   # timed calls per kernel, after one warm-up


def make_capture(seed: int, num_workers: int = 1024, rounds: int = 8192,
                 group: int = 32, *, num_tags: int = 64, num_paths: int = 50,
                 tick_ns: int = 100_000, n_min: float | None = None):
    """Plain numpy fields of a capture with an injected serialization
    bottleneck, built vectorised.

    Every worker runs one timeslice per round.  Odd rounds are serial: the
    round's group of ``group`` workers holds a lock for ~800 us (half of
    those slices on ``INJECTED_PATH``, the rest on random paths) while the
    other workers wait after a short ~10 us slice on ``WAIT_PATH``.  Even
    rounds are parallel: every worker runs ~580 us on a random path.  Times
    lie on a 1 us grid.  Samples are what the periodic probe would record
    every ``tick_ns`` while fewer than ``n_min`` (default ``2 * group``)
    workers are active: each active worker's top-of-stack tag.

    Returns ``(log_fields, tag_names, tag_locations, stack_paths,
    sample_fields, n_min)`` for :func:`repro_torch.convert.capture_from_numpy`.
    """
    rng = np.random.default_rng(seed)
    w, r, g = num_workers, rounds, group
    n_min = 2.0 * g if n_min is None else n_min
    tag_names = [f"fn{i:02d}" for i in range(num_tags)]
    tag_locations = [f"app/mod{i % 8}.py:{100 + 10 * i}"
                     for i in range(num_tags)]
    paths = [INJECTED_PATH, WAIT_PATH]
    while len(paths) < num_paths:
        depth = int(rng.integers(2, 5))
        p = (0,) + tuple(int(x) for x in rng.choice(
            np.arange(5, num_tags), size=depth, replace=False))
        if p not in paths:
            paths.append(p)
    path_top = np.asarray([p[-1] for p in paths], np.int32)

    serial = np.arange(r) % 2 == 1
    length = np.where(serial, SERIAL_US, PARALLEL_US).astype(np.int64)
    t_round = np.concatenate([[0], np.cumsum(length)[:-1]])
    start = t_round[:, None] + rng.integers(0, 21, (r, w))
    end = t_round[:, None] + PARALLEL_US - rng.integers(1, 21, (r, w))
    path = rng.integers(2, num_paths, (r, w)).astype(np.int32)
    sr = np.flatnonzero(serial)
    holder = (np.arange(w)[None, :] // g) == (np.arange(sr.size)
                                              % (w // g))[:, None]
    start[sr] = t_round[sr, None] + rng.integers(0, 3, (sr.size, w))
    end[sr] = np.where(
        holder, t_round[sr, None] + HELD_US - rng.integers(1, 11, (sr.size, w)),
        t_round[sr, None] + rng.integers(5, 16, (sr.size, w)))
    held_path = np.where(rng.random((sr.size, w)) < 0.5, 0,
                         rng.integers(2, num_paths, (sr.size, w)))
    path[sr] = np.where(holder, held_path, 1)

    # events: ACTIVATE at each start, DEACTIVATE at each end; DEACTIVATE
    # first at equal times
    times = np.concatenate([start.ravel(), end.ravel()])
    deltas = np.repeat(np.asarray([1, -1], np.int8), r * w)
    order = np.argsort(times * 2 + (deltas > 0), kind="stable")
    workers = np.tile(np.arange(w, dtype=np.int32), 2 * r)[order]
    tags = np.tile(path_top[path.ravel()], 2)[order]
    stacks = np.concatenate([np.full(r * w, -1, np.int32),
                             path.ravel()])[order]
    times = times[order]
    deltas = deltas[order]
    log_fields = {"times": T0_NS + times * 1000, "workers": workers,
                  "deltas": deltas, "tags": tags, "stacks": stacks,
                  "num_workers": w}

    # the probe: ticks from the first event on, as the offline replay of
    # the sampler places them; a worker is active at a tick iff its slice
    # started at or before it and ends after it
    tick_us = tick_ns // 1000
    ticks = np.arange(times[0] + tick_us, times[-1], tick_us)
    rnd = np.searchsorted(t_round, ticks, side="right") - 1
    st, sw, sg = [], [], []
    for lo in range(0, ticks.size, 4096):
        tk, rk = ticks[lo:lo + 4096], rnd[lo:lo + 4096]
        active = (start[rk] <= tk[:, None]) & (tk[:, None] < end[rk])
        low = active.sum(1) < n_min
        ti, wi = np.nonzero(active[low])
        st.append(tk[low][ti])
        sw.append(wi.astype(np.int32))
        sg.append(path_top[path[rk[low][ti], wi]])
    sample_fields = {"times": T0_NS + np.concatenate(st) * 1000,
                     "workers": np.concatenate(sw),
                     "tags": np.concatenate(sg)}
    return log_fields, tag_names, tag_locations, paths, sample_fields, n_min


def check(ok, what: str) -> None:
    """Fail the run (exit status 1) unless ``ok``."""
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def _critical_keys(table) -> set:
    """(worker, end time in us) of each critical slice: the fused backend
    rebases times through float32, which moves them by well under 0.5 us,
    and the capture's times lie on a 1 us grid."""
    end_us = np.round((table.end_ns - T0_NS) / 1000.0).astype(np.int64)
    return set(zip(table.worker.tolist(), end_us.tolist()))


def profile_main_path(label: str, run) -> None:
    """One ``run()`` under cProfile and torch.profiler: the host functions
    with the most cumulative time, and the device's busy time (kernels and
    copies) against the wall time."""
    import cProfile
    import io
    import pstats

    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prog = cProfile.Profile()
        t = time.perf_counter()
        prog.enable()
        run()
        torch.cuda.synchronize()
        prog.disable()
        wall = time.perf_counter() - t
    # device-side rows only (kernels, copies): each aten op's device time
    # is also listed under the kernels it launched
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0
              and not e.key.startswith("Activity Buffer")]
    busy_us = sum(e.self_device_time_total for e in events)
    print(f"[profile] fused {label}: wall {wall:.3f} s, device busy "
          f"{busy_us / 1e6:.4f} s, device idle share "
          f"{1.0 - busy_us / 1e6 / wall:.4f}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"[profile] fused {label} device: {e.key[:60]:60s} "
              f"{e.self_device_time_total / 1e3:9.3f} ms x{e.count}")
    out = io.StringIO()
    pstats.Stats(prog, stream=out).sort_stats("cumulative").print_stats(25)
    for line in out.getvalue().splitlines():
        if line.strip() and ("/" in line or "{" in line):
            print(f"[profile] fused {label} host: "
                  f"{line.strip().replace(ROOT + os.sep, '')}")


def time_ms(fn, repeats: int = REPEATS) -> float:
    """Mean CUDA-event time of ``fn()`` over ``repeats`` calls, after one
    warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(repeats):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / repeats


def graph_ms(fn, repeats: int = REPEATS) -> float | None:
    """Mean time of ``fn()`` replayed from one CUDA graph of ``repeats``
    calls: the device's time for the call without the host's time to issue
    it, which dominates at small shapes.  None when ``fn`` cannot be
    captured (an operation that synchronises, as ``bincount`` does)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            for _ in range(repeats):
                fn()
    except RuntimeError:
        torch.cuda.synchronize()
        return None
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(5):
        graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / (5 * repeats)


def bound_ms(nbytes: float, nops: float) -> tuple[float, str]:
    """The least time the card could take: bytes over the memory rate or
    operations over the float32 rate, whichever is larger."""
    tb, to = nbytes / HBM_BYTES_PER_S, nops / FP32_OPS_PER_S
    return (max(tb, to) * 1e3, "bytes" if tb >= to else "operations")


def _fmt(ms) -> str:
    return "-" if ms is None else f"{ms:.4f} ms"


class KernelRows:
    """The rows of the ``kernels`` JSON line: one per kernel, at the first
    shape it is timed at, with the other shapes under ``shapes``.
    ``launches`` stays None until a main-path run has counted them."""

    def __init__(self):
        self.rows = {}

    def add(self, key, name, source, replaces, shape, err, ms, plain_ms,
            nbytes, nops, library_ms, composite_ms, bound=None, **extra):
        """``bound`` overrides the bytes-or-operations bound with a
        ``(ms, by)`` the caller reckoned (the stream scan's chain)."""
        b_ms, b_by = bound_ms(nbytes, nops) if bound is None else bound
        entry = {"shape": shape, "max_abs_err": err, "ms": ms,
                 "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                 "library_ms": library_ms, "composite_ms": composite_ms,
                 **extra}
        more = "".join(f", {k} {_fmt(v) if k.endswith('_ms') else v}"
                       for k, v in extra.items())
        print(f"[kernel] {name} {shape}: {ms:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by}, {100 * b_ms / ms:.1f}% of bound), plain "
              f"{plain_ms:.4f} ms, library {_fmt(library_ms)}, composite "
              f"{_fmt(composite_ms)}, max_abs_err {err:.3e}{more}")
        if key not in self.rows:
            self.rows[key] = {"name": name, "route": "cuda", "source": source,
                              "replaces": replaces, "launches": None, **entry,
                              "shapes": []}
        else:
            self.rows[key]["shapes"].append(entry)


FOLD_SRC = "src/repro_torch/kernels/csrc/cmetric_fold.cu"
HIST_SRC = "src/repro_torch/kernels/csrc/tag_hist.cu"
STREAM_SRC = "src/repro_torch/kernels/csrc/stream_scan.cu"


def hold_fold(label, dt, deltas, carry, out) -> dict:
    """A fold call's outputs ``out`` against its plain version on the same
    inputs and a float64 prefix: ``n`` and the count equal; gcm within
    1e-5 max|gcm| of the float64 prefix (or no further than the plain
    version is) and of the plain version; total_cm and idle to 1e-5."""
    import torch
    from repro_torch.kernels import ref
    n_k, g_k, tot_k, idle_k, cnt_k = out
    n_p, g_p, tot_p, idle_p, cnt_p = ref.fold_ref(dt, deltas, carry)
    check(torch.equal(n_k, n_p), f"fold {label}: n differs from the plain "
          "version")
    _, g0, i0 = (0.0, 0.0, 0.0) if carry is None else (float(c)
                                                       for c in carry)
    c64 = torch.where(n_k > 0, dt.double() / n_k.clamp(min=1).double(),
                      torch.zeros_like(dt, dtype=torch.float64))
    incl64 = float(np.float32(g0)) + torch.cumsum(c64, 0)
    g64 = incl64 - c64
    scale = float(g64.abs().max())
    err_k = float((g_k.double() - g64).abs().max())
    err_p = float((g_p.double() - g64).abs().max())
    diff = float((g_k - g_p).abs().max())
    tol = 1e-5 * scale
    check(err_k <= max(tol, err_p), f"fold {label}: gcm misses the float64 "
          "bound")
    check(diff <= tol + err_p, f"fold {label}: gcm disagrees with the plain "
          "version")
    tot64 = float(incl64[-1])
    idle64 = float(np.float32(i0)) + float(torch.where(
        (n_k <= 0) & (dt > 0), dt.double(), torch.zeros_like(c64)).sum())
    check(abs(float(tot_k) - tot64) <= 1e-5 * max(abs(tot64), 1e-9),
          f"fold {label}: total_cm")
    check(abs(float(idle_k) - idle64) <= 1e-5 * max(idle64, 1e-9),
          f"fold {label}: idle")
    check(float(cnt_k) == float(cnt_p), f"fold {label}: final count")
    return {"diff": diff, "err_k": err_k, "err_p": err_p, "tol": tol}


def check_fold(rows, dt, deltas, log, e):
    """The fold kernel against its plain version and a float64 prefix."""
    import torch
    from repro_torch.kernels import cmetric_fold as fold_k
    from repro_torch.kernels import ref
    out = fold_k.fold(dt, deltas)
    st = hold_fold(f"E={e}", dt, deltas, None, out)
    print(f"[kernel] fold gcm vs float64 prefix: kernel {st['err_k']:.3e}, "
          f"plain {st['err_p']:.3e}, bound 1e-5*max|gcm| = {st['tol']:.3e}")
    check(float(out[4]) == float(log.deltas.sum()), "fold: final count")
    n_k = out[0]
    contrib = torch.where(n_k > 0, dt / n_k.clamp(min=1).float(),
                          torch.zeros_like(dt))

    def kernel():
        return fold_k.fold(dt, deltas)

    def library():
        return (torch.cumsum(deltas, 0, dtype=torch.int32),
                torch.cumsum(contrib, 0))

    rows.add("fold", "cmetric_fold.fold", FOLD_SRC,
             "src/repro/kernels/cmetric_fold.py:52", f"E={e}", st["diff"],
             time_ms(kernel), time_ms(lambda: ref.fold_ref(dt, deltas)),
             16.0 * e, 4.0 * e, time_ms(library), None,
             graph_ms=graph_ms(kernel), library_graph_ms=graph_ms(library))
    return n_k


def hold_carry_cumsum(label, contrib, idle_c, carry, out) -> dict:
    """A carry_cumsum call's outputs ``out`` against its plain version on
    the same inputs and a float64 prefix: g within 1e-5 max|g| of the
    float64 prefix (or no further than the plain version is) and of the
    plain version; gcm_end is g[-1]; idle_end to 1e-5."""
    import torch
    from repro_torch.kernels import ref
    c_vals = tuple(float(c) for c in carry)
    gk, ek, ik = out
    gp, _, ip = ref.carry_cumsum_ref(contrib, idle_c, c_vals)
    g64 = float(np.float32(c_vals[0])) + torch.cumsum(contrib.double(), 0)
    i64 = float(np.float32(c_vals[1])) + float(idle_c.double().sum())
    scale = float(g64.abs().max())
    err_k = float((gk.double() - g64).abs().max())
    err_p = float((gp.double() - g64).abs().max())
    diff = float((gk - gp).abs().max())
    tol = 1e-5 * scale
    check(err_k <= max(tol, err_p), f"carry_cumsum {label}: g misses the "
          "bound")
    check(diff <= tol + err_p, f"carry_cumsum {label}: g disagrees with "
          "plain")
    check(abs(float(ek) - float(gk[-1])) <= 1e-6 * scale,
          f"carry_cumsum {label}: gcm_end is not g[-1]")
    check(abs(float(ik) - i64) <= 1e-5 * max(abs(i64), 1e-9),
          f"carry_cumsum {label}: idle_end vs float64")
    check(abs(float(ik) - float(ip)) <= 1e-5 * max(abs(i64), 1e-9),
          f"carry_cumsum {label}: idle_end vs plain")
    return {"diff": diff, "err_k": err_k, "err_p": err_p, "tol": tol}


def check_carry_cumsum(rows, contrib, idle_c, carry, shape, repeats):
    """carry_cumsum against its plain version and a float64 prefix, timed
    beside ``torch.cumsum`` alone and the like-for-like composite (cumsum,
    carry add, idle sum)."""
    import torch
    from repro_torch.kernels import cmetric_fold as fold_k
    from repro_torch.kernels import ref
    e = contrib.shape[0]
    c_vals = tuple(float(c) for c in carry)
    st = hold_carry_cumsum(shape, contrib, idle_c, carry,
                           fold_k.carry_cumsum(contrib, idle_c, carry))
    print(f"[kernel] carry_cumsum {shape} g vs float64 prefix: kernel "
          f"{st['err_k']:.3e}, plain {st['err_p']:.3e}, bound 1e-5*max|g| = "
          f"{st['tol']:.3e}")
    g0 = torch.as_tensor(c_vals[0], dtype=torch.float32, device=contrib.device)
    i0 = torch.as_tensor(c_vals[1], dtype=torch.float32, device=contrib.device)

    def composite():
        g = g0 + torch.cumsum(contrib, 0)
        return g, g[-1], i0 + torch.sum(idle_c)

    def kernel():
        return fold_k.carry_cumsum(contrib, idle_c, carry)

    rows.add("carry_cumsum", "cmetric_fold.carry_cumsum", FOLD_SRC,
             "src/repro/kernels/cmetric_fold.py:146", shape, st["diff"],
             time_ms(kernel, repeats),
             time_ms(lambda: ref.carry_cumsum_ref(contrib, idle_c, c_vals),
                     repeats),
             12.0 * e, 2.0 * e,
             time_ms(lambda: torch.cumsum(contrib, 0), repeats),
             time_ms(composite, repeats), graph_ms=graph_ms(kernel, repeats),
             library_graph_ms=graph_ms(lambda: torch.cumsum(contrib, 0),
                                       repeats))


def hold_hist(label, tg, wt, k, out) -> float:
    """A tag_hist call's outputs ``out`` against its plain version on the
    same inputs: counts equal, weighted sums to rtol 1e-4 (float atomics
    add in another order), and the counts as f32 when unweighted.  Returns
    max |wsum - plain|."""
    import torch
    from repro_torch.kernels import ref
    ck, wk = out
    cp, wp = ref.hist_ref(tg, wt, k)
    check(torch.equal(ck, cp), f"tag_hist {label}: counts differ")
    check(torch.allclose(wk, wp, rtol=1e-4, atol=1e-6),
          f"tag_hist {label}: weighted sums differ beyond rtol 1e-4")
    if wt is None:
        check(torch.equal(wk, ck.float()), f"tag_hist {label}: wsum is not "
              "counts as f32")
    return float((wk - wp).abs().max())


def check_hist(rows, tg, wt, k, shape, repeats, key="hist"):
    """tag_hist against its plain version, timed beside
    ``torch.bincount`` (with the weights when there are any) and the
    like-for-like composite: the tag filter, the counts and the weighted
    sums (or the counts as f32)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import tag_hist as hist_k
    s = tg.shape[0]
    err = hold_hist(shape, tg, wt, k, hist_k.hist(tg, wt, num_bins=k))
    # where the bins live (a checkout older than ``bins_path`` has one place)
    path = (hist_k.bins_path(k, wt is not None)
            if hasattr(hist_k, "bins_path") else None)
    keep = (tg >= 0) & (tg < k)
    tv = tg[keep]
    wv = None if wt is None else wt[keep]

    def composite():
        t = tg[(tg >= 0) & (tg < k)]
        counts = torch.bincount(t, minlength=k)
        if wt is None:
            return counts, counts.float()
        return counts, torch.bincount(
            t, weights=wt[(tg >= 0) & (tg < k)], minlength=k)

    per_sample = 4.0 if wt is None else 8.0
    rows.add(key, "tag_hist.hist", HIST_SRC,
             "src/repro/kernels/tag_hist.py:22", shape, err,
             time_ms(lambda: hist_k.hist(tg, wt, num_bins=k), repeats),
             time_ms(lambda: ref.hist_ref(tg, wt, k), repeats),
             per_sample * s + 8.0 * k, 2.0 * s,
             time_ms(lambda: torch.bincount(tv, weights=wv, minlength=k),
                     repeats),
             time_ms(composite, repeats), path=path,
             graph_ms=graph_ms(lambda: hist_k.hist(tg, wt, num_bins=k),
                               repeats))


def sm_clock_hz() -> float:
    """The card's maximum SM clock, from nvidia-smi."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()
    return float(out[0]) * 1e6


def stream_columns(log, dev):
    """The capture's columns as ``stream_scan`` takes them, on ``dev``."""
    import torch
    return (torch.from_numpy(log.slice_seconds().astype(np.float32)).to(dev),
            torch.from_numpy(log.workers.astype(np.int32)).to(dev),
            torch.from_numpy(log.deltas.astype(np.int32)).to(dev))


def hold_stream(label, times_s, workers, deltas, num_workers, out):
    """A stream_scan call's outputs ``out`` against its plain version on
    the same inputs: rows, workers and n_at_exit equal; the per-worker
    CMetric, idle, global_cm and the float columns to rtol 1e-6.  Returns
    ``(bit_equal, max_abs_err, rows)``."""
    import torch
    from repro_torch.kernels import ref
    p = ref.stream_ref(times_s, workers, deltas, num_workers)
    kr, pr = out[3], p[3]
    check(kr[0].shape == pr[0].shape == (int((deltas <= 0).sum()),),
          f"stream {label}: row count")
    check(torch.equal(kr[0], pr[0]) and torch.equal(kr[5], pr[5]),
          f"stream {label}: worker or n_at_exit differs from the plain "
          "version")
    pairs = (("per-worker CMetric", out[0], p[0]), ("idle", out[1], p[1]),
             ("global_cm", out[2], p[2]), ("start", kr[1], pr[1]),
             ("end", kr[2], pr[2]), ("slice cm", kr[3], pr[3]),
             ("threads_av", kr[4], pr[4]))
    for what, a, b in pairs:
        check(torch.allclose(a, b, rtol=1e-6, atol=0.0),
              f"stream {label}: {what} beyond rtol 1e-6 of the plain version")
    bit_equal = all(torch.equal(a, b) for _, a, b in pairs)
    err = max(float((a.double() - b.double()).abs().max()) if a.numel()
              else 0.0 for _, a, b in pairs)
    return bit_equal, err, int(kr[0].shape[0])


def stream_device_times(call) -> dict:
    """Device time of each kernel (and copy) one ``call()`` launches, in
    ms by name, from ``torch.profiler``: the stream scan's stages."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0}


def check_stream(rows, log, dev):
    """stream_scan against its plain version on the first 2^16 events of
    the capture, then it and its plain version timed at the whole capture
    (phase 3 holds the whole-capture call of the main path), eager and
    replayed from a CUDA graph, with each stage's device time from one
    profiled call and the chain launch timed alone.  Its bound is the
    dependent chain: E float32 adds in series at FADD_LATENCY_CYCLES each,
    at the card's maximum SM clock; the chain launch is held to the same
    bound."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import stream_scan as stream_k
    nw = log.num_workers
    sub = log.chunk(0, 1 << 16).sanitize()
    cols = stream_columns(sub, dev)
    bit_equal, err, n_rows = hold_stream(
        f"E={len(sub)}", *cols, nw, stream_k.stream_scan(*cols, nw))
    print(f"[kernel] stream E={len(sub)} vs plain version: {n_rows} rows, "
          f"bit-equal {bit_equal}, max_abs_err {err:.3e}")
    e = len(log)
    s = int((log.deltas <= 0).sum())
    t, w, d = stream_columns(log, dev)

    def kernel():
        return stream_k.stream_scan(t, w, d, nw)

    out = kernel()

    def launch():   # the launch alone, which a CUDA graph can capture
        stream_k.launch(t, w, d, nw, out)

    # the plain version is a host walk of seconds: one timed call
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref.stream_ref(t, w, d, nw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    hz = sm_clock_hz()
    chain_ms = e * FADD_LATENCY_CYCLES / hz * 1e3
    nbytes = 12.0 * e + 24.0 * s + 4.0 * nw
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound = ((chain_ms, "operations") if chain_ms >= byte_ms
             else (byte_ms, "bytes"))
    print(f"[kernel] stream bound at E={e}: chain {e} x "
          f"{FADD_LATENCY_CYCLES} cycles at {hz / 1e6:.0f} MHz = "
          f"{chain_ms:.4f} ms; bytes {nbytes:.0f} at 3.35 TB/s = "
          f"{byte_ms:.4f} ms")
    extra = {}
    # (another checkout, under --src, may predate the staged pipeline)
    if hasattr(stream_k, "chain_launch"):
        share, idle, _, _ = stream_k.prepass_stage(t, d)
        bufs = stream_k.chain_buffers(share, idle)
        del share, idle
        scalars = torch.empty(2, dtype=torch.float32, device=dev)
        walk_ms = time_ms(lambda: stream_k.chain_launch(e, bufs, scalars), 5)
        check(float(scalars[1]) == float(out[2])
              and float(scalars[0]) == float(out[1]),
              "stream: the chain alone disagrees with the pipeline's sums")
        del bufs
        extra = {"chain_ms": walk_ms,
                 "chain_share": round(chain_ms / walk_ms, 4)}
        print(f"[kernel] stream chain launch alone at E={e}: "
              f"{walk_ms:.4f} ms, {100 * chain_ms / walk_ms:.1f}% of the "
              f"{chain_ms:.4f} ms chain bound")
    stages = stream_device_times(kernel)
    print("[kernel] stream stages, device ms of one call (torch.profiler): "
          + ", ".join(f"{k[:48]} {v:.4f}" for k, v in sorted(
              stages.items(), key=lambda kv: -kv[1])))
    rows.add("stream", "stream_scan.stream_scan", STREAM_SRC,
             "src/repro/core/cmetric.py:194", f"E={e}", err,
             time_ms(kernel, 20), plain_ms, nbytes, 0.0, None, None,
             bound=bound, checked_shape=f"E={len(sub)}", bit_equal=bit_equal,
             graph_ms=graph_ms(launch, 1), stages=stages, **extra)


#: Each kernel wrapper, by its launch-count key: (module, function).
WRAPPERS = {"fold": ("cmetric_fold", "fold"),
            "carry_cumsum": ("cmetric_fold", "carry_cumsum"),
            "hist": ("tag_hist", "hist"),
            "stream": ("stream_scan", "stream_scan")}


def _on_card(x) -> bool:
    return x.is_cuda


def _clone(x):
    import torch
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, (tuple, list)):
        return type(x)(_clone(v) for v in x)
    return x


@contextlib.contextmanager
def recording():
    """Keep every call a path makes to a kernel wrapper with tensors on the
    card: its arguments by name and its outputs, cloned on the card right
    after the call.  :func:`hold_recorded` then holds the path's own
    launches against the plain versions, so the checks launch nothing that
    the path's counts would see."""
    import importlib
    import inspect
    calls = {key: [] for key in WRAPPERS}
    lock = threading.Lock()
    saved = []
    for key, (mod_name, attr) in WRAPPERS.items():
        name = f"repro_torch.kernels.{mod_name}"
        if importlib.util.find_spec(name) is None:    # an older checkout
            continue
        mod = importlib.import_module(name)
        real = getattr(mod, attr)
        sig = inspect.signature(real)

        def wrapper(*args, _real=real, _sig=sig, _key=key, **kw):
            out = _real(*args, **kw)
            if _on_card(args[0]):
                bound = _sig.bind(*args, **kw)
                bound.apply_defaults()
                with lock:
                    calls[_key].append((_clone(dict(bound.arguments)),
                                        _clone(out)))
            return out

        setattr(mod, attr, wrapper)
        saved.append((mod, attr, real))
    try:
        yield calls
    finally:
        for mod, attr, real in saved:
            setattr(mod, attr, real)


def hold_recorded(label, calls, launches) -> None:
    """Hold each recorded call of a path against its kernel's plain
    version, at the tolerances of phase 2, and print what was held; every
    launch the path counted must have been recorded."""
    out = []
    for key, held in calls.items():
        check(len(held) == launches.get(key, 0), f"{label}: {len(held)} "
              f"{key} calls recorded, {launches.get(key, 0)} launched")
        diffs = []
        for i, (a, res) in enumerate(held):
            what = f"{label} call {i}"
            if key == "fold":
                diffs.append(hold_fold(what, a["dt"], a["deltas"],
                                       a["carry"], res)["diff"])
            elif key == "carry_cumsum":
                diffs.append(hold_carry_cumsum(
                    what, a["contrib"], a["idle_contrib"], a["carry"],
                    res)["diff"])
            elif key == "hist":
                diffs.append(hold_hist(what, a["tags"], a["weights"],
                                       a["num_bins"], res))
            else:
                bit_equal, err, n_rows = hold_stream(
                    what, a["times_s"], a["workers"], a["deltas"],
                    a["num_workers"], res)
                print(f"[held] {what}: stream E={a['times_s'].shape[0]}, "
                      f"{n_rows} rows, bit-equal {bit_equal}, max_abs_err "
                      f"{err:.3e}")
                diffs.append(err)
        if held:
            out.append(f"{key} {len(held)} calls (max |kernel - plain| "
                       f"{max(diffs):.3e})")
    print(f"[held] {label}: against the plain versions on the same inputs: "
          f"{', '.join(out) or 'no calls'}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile one run of each main-path mode")
    ap.add_argument("--kernels-only", action="store_true",
                    help="phase 2 and the main-path key histogram only (one "
                    "unchecked whole-log run records the keys)")
    ap.add_argument("--src", default=os.path.join(ROOT, "src"),
                    help="directory holding the repro_torch package to drive "
                    "(another checkout's, to time its kernels alike)")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch import convert
    from repro_torch.core import detect_offline, export
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import cmetric_fold as fold_k

    t_script = time.perf_counter()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[setup] card: {smi}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; kernels from {fold_k.__file__}")

    # -- phase 1: build + capture --------------------------------------------
    t = time.perf_counter()
    logs = build.build_all()
    print(f"[setup] kernels built in {time.perf_counter() - t:.1f} s "
          f"({', '.join(logs) or 'already built'})")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[setup] ptxas {name}: {line.strip()}")
    t = time.perf_counter()
    fields, tag_names, tag_locs, paths, sample_fields, n_min = make_capture(
        SEED)
    log, tags, stacks, samples = convert.capture_from_numpy(
        fields, tag_names, tag_locs, paths, sample_fields)
    e = len(log)
    print(f"[setup] capture: {e} events, {log.num_workers} workers, "
          f"{len(stacks)} paths, {len(tags)} tags, {len(samples)} samples, "
          f"n_min {n_min:g}, span {(log.times[-1] - log.times[0]) * 1e-9:.3f}"
          f" s; built in {time.perf_counter() - t:.1f} s")

    # -- phase 2: kernels against their plain versions -----------------------
    rows = KernelRows()
    t32 = torch.from_numpy(log.slice_seconds().astype(np.float32)).to(dev)
    dt = torch.empty_like(t32)
    dt[:-1] = t32[1:] - t32[:-1]
    dt[-1] = 0.0
    deltas = torch.from_numpy(log.deltas.astype(np.int32)).to(dev)
    n_k = check_fold(rows, dt, deltas, log, e)

    # the chunked fold's inputs: per-event contributions (host side in the
    # pipeline, float64, then cast) and a nonzero carry; then one chunk of
    # the main path's size with the carry a 0-d device tensor, as a carry
    # returned by an earlier call is
    nb = (n_k - deltas).double()
    dt_prev = torch.cat([dt.new_zeros(1), dt[:-1]]).double()
    contrib = torch.where(nb > 0, dt_prev / nb.clamp(min=1),
                          torch.zeros_like(nb)).float()
    idle_c = torch.where(nb > 0, torch.zeros_like(nb), dt_prev).float()
    del nb, dt_prev, n_k
    check_carry_cumsum(rows, contrib, idle_c, (0.125, 0.0625), f"E={e}",
                       REPEATS)
    chunk = 1 << 20
    lo = e // 2
    carry_dev = (torch.tensor(2.5, device=dev), torch.tensor(0.75, device=dev))
    check_carry_cumsum(rows, contrib[lo:lo + chunk].clone(),
                       idle_c[lo:lo + chunk].clone(), carry_dev,
                       f"E={chunk} device-carry", 200)
    del contrib, idle_c, t32, dt, deltas

    rng = np.random.default_rng(SEED + 1)
    s = 1 << 24
    wt = torch.from_numpy(rng.random(s, dtype=np.float32)).to(dev)
    for k in (3300, 1 << 20):
        tg = torch.from_numpy(rng.integers(-8, k + 8, s).astype(np.int32))
        check_hist(rows, tg.to(dev), wt, k, f"S={s} K={k} uniform", REPEATS)
    # the detector's kind of skew: 90% of the samples in 64 bins
    k = 3300
    hot = rng.integers(0, k, 64)
    tg = np.where(rng.random(s) < 0.9, hot[rng.integers(0, 64, s)],
                  rng.integers(-8, k + 8, s)).astype(np.int32)
    check_hist(rows, torch.from_numpy(tg).to(dev), wt, k,
               f"S={s} K={k} skewed 90% in 64 bins", REPEATS)
    del tg, wt
    # (another checkout, under --src, may predate the stream kernel)
    if importlib.util.find_spec("repro_torch.kernels.stream_scan"):
        check_stream(rows, log, dev)
    torch.cuda.empty_cache()

    # -- phase 3: the main path -----------------------------------------------
    # Every kernel call is recorded on the way: each is held against its
    # plain version after the run, and the keys the detector handed
    # tag_hist give the histogram's main-path row below.
    with recording() as calls:
        if args.kernels_only:
            detect_offline(log, tags, stacks, n_min, samples=samples,
                           backend="fused")
        else:
            t = time.perf_counter()
            ref_rep = detect_offline(log, tags, stacks, n_min,
                                     samples=samples, backend="numpy",
                                     chunk_events=1 << 20)
            print(f"[main] numpy chunked oracle: "
                  f"{time.perf_counter() - t:.2f} s")
            runs = main_path(log, tags, stacks, n_min, samples, ref_rep, e,
                             detect_offline, export, ops)
    if not args.kernels_only:
        hold_recorded("fused whole-log and chunked", calls, {
            key: runs["whole-log"][key] + runs["chunked"][key]
            for key in runs["chunked"]})
    first = calls["hist"][0][0]
    keys, weights, k = first["tags"], first["weights"], first["num_bins"]
    del calls
    check(weights is None, "the detector weighed its key histogram")
    check_hist(rows, keys, None, k,
               f"S={keys.shape[0]} K={k} main-path keys, no weights", 200)

    if args.kernels_only:
        print(json.dumps({"kernels": list(rows.rows.values())}))
        return 0
    runs["stream"] = stream_path(log, tags, stacks, n_min, samples, ref_rep,
                                 e, detect_offline, ops)
    runs.update(session_paths(log, tags, stacks, n_min, samples, ref_rep, e,
                              export, ops))
    runs["live session"] = live_path(ops)
    runs["fleet"] = fleet_path(ops)
    runs["serve"] = serve_path(ops, dev, host_profile=args.profile)
    runs["train"] = train_path(ops, dev, smi)
    runs["recurrent"] = recurrent_path(ops, dev, smi,
                                       host_profile=args.profile)
    for key, row in rows.rows.items():
        row["launches"] = sum(r[key] for r in runs.values())
    if args.profile:
        for label, chunk in (("whole-log", None), ("chunked", 1 << 20)):
            profile_main_path(label, lambda chunk=chunk: detect_offline(
                log, tags, stacks, n_min, samples=samples, backend="fused",
                chunk_events=chunk))
    print(f"[main] whole script {time.perf_counter() - t_script:.1f} s")

    print(smi)
    print(json.dumps({"kernels": [rows.rows[k] for k in (
        "fold", "carry_cumsum", "hist", "stream")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


def main_path(log, tags, stacks, n_min, samples, ref_rep, e, detect_offline,
              export, ops) -> dict:
    """``detect_offline`` fused, whole-log and chunked, each checked against
    the float64 oracle ``ref_rep``; returns each run's kernel launches,
    counted from 0 just before the run and read just after."""
    import torch
    runs = {}
    for label, chunk in (("whole-log", None), ("chunked", 1 << 20)):
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        rep = detect_offline(log, tags, stacks, n_min, samples=samples,
                             backend="fused", chunk_events=chunk)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        launches = ops.launch_counts()
        runs[label] = launches
        print(f"[main] fused {label}: {secs:.3f} s, {e / secs:.4g} events/s, "
              f"launches {launches}")
        check_report(f"fused {label}", rep, ref_rep, export)
    whole, chunked = runs["whole-log"], runs["chunked"]
    check(whole["fold"] >= 1 and whole["hist"] >= 1,
          f"whole-log run launched {whole}")
    check(chunked["carry_cumsum"] >= 1 and chunked["hist"] >= 1,
          f"chunked run launched {chunked}")
    return runs


def check_report(label, rep, ref_rep, export) -> None:
    """A report of the capture against the float64 oracle's: equal slice
    counts, per-worker CMetric to rtol 1e-3, critical-set flips under 0.1%,
    the injected path first, non-empty exports."""
    attached = sum(sum(p.tag_counts.values()) for p in rep.paths)
    print(f"[main] {label}: {rep.total_slices} slices, {rep.total_critical} "
          f"critical, {attached} samples attached in the top paths")
    check(rep.total_slices == ref_rep.total_slices,
          f"{label}: slice count {rep.total_slices} vs "
          f"{ref_rep.total_slices}")
    pw, pr = rep.per_worker, ref_rep.per_worker
    worst = float(np.max(np.abs(pw - pr) / np.abs(pr)))
    check(np.all(np.isfinite(pw)) and pw.shape == pr.shape,
          f"{label}: per-worker CMetric not finite or misshapen")
    check(np.allclose(pw, pr, rtol=1e-3, atol=0.0),
          f"{label}: per-worker CMetric off by {worst:.3e} (rtol 1e-3)")
    a, b = _critical_keys(rep.critical_table), _critical_keys(
        ref_rep.critical_table)
    flips = len(a ^ b)
    print(f"[main] {label} vs float64 oracle: per-worker max rel "
          f"err {worst:.3e}, critical-set flips {flips} of "
          f"{rep.total_slices} slices "
          f"({100.0 * flips / rep.total_slices:.5f}%)")
    check(flips < 1e-3 * rep.total_slices, f"{label}: too many flips")
    check(rep.total_critical >= 100_000 and attached >= 100_000,
          f"{label}: fewer than 1e5 critical slices or samples")
    check(rep.paths[0].stack == INJECTED_PATH,
          f"{label}: top path {rep.path_str(rep.paths[0])}")
    check(ref_rep.paths[0].stack == INJECTED_PATH, "oracle top path")
    doc = json.loads(export(rep, "json"))
    check(bool(doc["paths"]) and bool(export(rep, "text")),
          f"{label}: empty export")
    print(f"[main] {label} top path: {rep.path_str(rep.paths[0])} "
          f"{rep.paths[0].cmetric:.6f} s CMetric "
          f"(oracle {ref_rep.paths[0].cmetric:.6f} s)")


def stream_path(log, tags, stacks, n_min, samples, ref_rep, e,
                detect_offline, ops) -> dict:
    """``detect_offline`` with the ``stream`` backend, whole-log: its one
    ``stream_scan`` call held against the plain version on the same 2^24
    inputs, the slice count equal to the oracle's and every value finite.
    Its float32 error against the float64 oracle and its top path are
    printed, not held to a limit.  Returns the run's kernel launches."""
    import torch
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    with recording() as calls:
        rep = detect_offline(log, tags, stacks, n_min, samples=samples,
                             backend="stream")
        torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launches = ops.launch_counts()
    hold_recorded("stream whole-log", calls, launches)
    check(len(calls["stream"]) == 1 and calls["stream"][0][0][
        "times_s"].shape[0] == e, "stream: not one whole-capture call")
    print(f"[main] stream whole-log: {secs:.3f} s, {e / secs:.4g} events/s, "
          f"{rep.total_slices} slices, {rep.total_critical} critical, "
          f"launches {launches}")
    check(launches["stream"] >= 1, f"stream run launched {launches}")
    check(rep.total_slices == ref_rep.total_slices,
          f"stream: slice count {rep.total_slices} vs {ref_rep.total_slices}")
    ct = rep.critical_table
    check(np.all(np.isfinite(rep.per_worker))
          and all(np.all(np.isfinite(getattr(ct, c)))
                  for c in ("cm", "threads_av")),
          "stream: a value is not finite")
    pw, pr = rep.per_worker, ref_rep.per_worker
    print(f"[main] stream vs float64 oracle (printed, no limit): per-worker "
          f"max rel err {float(np.max(np.abs(pw - pr) / np.abs(pr))):.3e}; "
          f"top path {rep.path_str(rep.paths[0])} "
          f"{rep.paths[0].cmetric:.6f} s CMetric (oracle "
          f"{ref_rep.path_str(ref_rep.paths[0])} "
          f"{ref_rep.paths[0].cmetric:.6f} s)")
    return launches


def session_paths(log, tags, stacks, n_min, samples, ref_rep, e, export,
                  ops) -> dict:
    """An offline fused session over the capture, and the capture spilled
    to a ``SpillStore`` and replayed through ``SpillSource`` into a fused
    session, each checked like the main path, with every kernel call held
    against its plain version.  Returns each run's kernel launches."""
    import torch
    from repro_torch.core import ProfileSession, SpillSource, SpillStore
    runs = {}

    def run(label, make):
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        with recording() as calls:
            sess = make()
            rep = sess.result()
            torch.cuda.synchronize()
        secs = time.perf_counter() - t
        launches = ops.launch_counts()
        runs[label] = launches
        hold_recorded(label, calls, launches)
        print(f"[session] {label}: {secs:.3f} s, {e / secs:.4g} events/s, "
              f"device {sess.device}, launches {launches}")
        check(sess.device.type == "cuda" and sess.fold_backend == "fused",
              f"{label}: ran on {sess.device} / {sess.fold_backend}")
        check(launches["carry_cumsum"] >= 1 and launches["hist"] >= 1,
              f"{label} launched {launches}")
        check_report(label, rep, ref_rep, export)

    run("offline session", lambda: ProfileSession.offline(
        log, tags, stacks, n_min=n_min, samples=samples, backend="fused",
        chunk_events=1 << 20))
    with tempfile.TemporaryDirectory(prefix="gapp-smoke-") as d:
        path = os.path.join(d, "capture.gappspill")
        t = time.perf_counter()
        store = SpillStore(path, chunk_events=1 << 20)
        store.append_columns(log.times, log.workers, log.deltas, log.tags,
                             log.stacks)
        store.close()
        print(f"[session] spill of {e} rows: {os.path.getsize(path)} bytes "
              f"written in {time.perf_counter() - t:.3f} s")
        run("spill replay", lambda: ProfileSession(
            SpillSource(path, log.num_workers, tags, stacks,
                        chunk_events=1 << 20),
            n_min=n_min, samples=samples, chunk_events=1 << 20))
    return runs


def get_url(addr, path: str) -> bytes:
    with urllib.request.urlopen(f"http://{addr[0]}:{addr[1]}{path}",
                                timeout=60) as r:
        return r.read()


def _live_run(n_threads):
    """The live workload of :func:`live_path`: returns the session, its
    mid-run snapshot, its result and its drains."""
    from repro_torch.core import ProfileSession
    s = ProfileSession(n_min=None, dt=0.001)
    check(s.device.type == "cuda" and s.fold_backend == "fused",
          f"live session on {s.device} / {s.fold_backend}")
    drains = []
    s.tracer.on_drain.append(drains.append)
    lock = threading.Lock()
    wids = [s.register_worker(f"worker{i}") for i in range(n_threads)]
    go = threading.Barrier(n_threads + 1)
    errors = []

    def worker(i):
        try:
            go.wait(timeout=60)
            for _ in range(10):
                with s.span(wids[i], "parallel_compute"):
                    time.sleep(0.004)
                if i == 0:
                    with s.span(wids[i], "write_output"):
                        with lock:
                            time.sleep(0.012)
        except Exception as e:      # noqa: BLE001 -- reported below
            errors.append(e)

    with s.running():
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(n_threads)]
        for th in threads:
            th.start()
        go.wait(timeout=60)
        time.sleep(0.05)
        mid = s.snapshot()          # the workload is still running
        for th in threads:
            th.join(timeout=120)
    check(not errors and not any(th.is_alive() for th in threads),
          f"live workload failed: {errors}")
    return s, mid, s.result(), drains


def live_path(ops) -> dict:
    """A live fused session on the card over 32 threads (quickstart's
    shape: worker 0 also holds a lock-protected ``write_output`` section
    three times as long as the parallel phase), with a snapshot mid-run;
    its result against the ``numpy`` backend offline on the frozen log,
    its ``/api/report`` against ``export("json")``.  Returns the run's
    kernel launches."""
    import torch
    from repro_torch.core import detect_offline
    n_threads = 32
    ops.reset_launch_counts()
    t = time.perf_counter()
    with recording() as calls:
        s, mid, rep, drains = _live_run(n_threads)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launches = ops.launch_counts()
    hold_recorded("live session", calls, launches)
    st = s.stats()
    print(f"[live] {n_threads} threads: {secs:.3f} s, mid-run snapshot "
          f"{mid.total_slices} slices, final {rep.total_slices} slices, "
          f"{st['events_folded']} events folded in {len(drains)} drains, "
          f"{st['samples']['stored']} samples, launches {launches}")
    check(launches["carry_cumsum"] >= 1 and launches["hist"] >= 1,
          f"live session launched {launches}")
    oracle = detect_offline(
        s.freeze(), s.tags, s.stacks, s._resolved_n_min(),
        samples=s.probe.buffer if len(s.probe.buffer) else None,
        backend="numpy", worker_names=s.tracer.worker_names())
    check(rep.total_slices == oracle.total_slices == 10 * n_threads + 10,
          f"live: slices {rep.total_slices} vs oracle {oracle.total_slices}")
    check(np.allclose(rep.per_worker, oracle.per_worker, rtol=1e-3, atol=0.0),
          "live: per-worker CMetric beyond rtol 1e-3 of the oracle")
    top = rep.path_str(rep.paths[0])
    check("write_output" in top, f"live: top path {top}")
    print(f"[live] top path {top} {rep.paths[0].cmetric:.6f} s CMetric "
          f"(oracle {oracle.path_str(oracle.paths[0])} "
          f"{oracle.paths[0].cmetric:.6f} s)")
    svc = s.serve()
    try:
        body = get_url(svc.address, "/api/report")
    finally:
        svc.close()
    check(body == s.export("json").encode("utf-8"),
          "live: /api/report differs from export('json')")
    return launches


def fleet_path(ops) -> dict:
    """The fleet_dashboard example's flow on the card: two producer hosts
    (fused live sessions, one with a serial ``commit_txn`` section) stream
    through ``RemoteSink``s into an ``IngestServer`` with a fleet_dir, and
    a fused session folds its ``FleetSource``.  ``/api/report`` against
    ``export("json")``; then, served from the fleet_dir, ``/api/whatif``
    against the offline ``what_if(...).to_json()``.  Returns the run's
    kernel launches."""
    from repro_torch.core import ProfileSession
    from repro_torch.device import default_device
    from repro_torch.examples.fleet_dashboard import run_host
    from repro_torch.fleet import FleetSource, IngestServer, ProfilerService
    ops.reset_launch_counts()
    t = time.perf_counter()
    errors = []
    dev = default_device()          # the hosts' threads get it explicitly

    def host(name):
        try:
            run_host(name, server.address, name == "db-1", dev)
        except Exception as e:      # noqa: BLE001 -- reported below
            errors.append(e)

    with recording() as calls:
        with tempfile.TemporaryDirectory(prefix="gapp-smoke-fleet-") as d:
            fleet_dir = os.path.join(d, "fleet")
            server = IngestServer(fleet_dir=fleet_dir)
            server.start()
            try:
                fleet = ProfileSession(server.source, n_min=2.0)
                fleet.start()
                hosts = [threading.Thread(target=host, args=(name,))
                         for name in ("web-0", "db-1")]
                for th in hosts:
                    th.start()
                for th in hosts:
                    th.join(timeout=120)
                check(not errors and not any(th.is_alive() for th in hosts),
                      f"fleet hosts failed: {errors}")
                check(server.wait_idle(60),
                      f"ingest not idle: {server.stats()}")
                rep = fleet.result()
                svc = fleet.serve(server=server)
                try:
                    body = get_url(svc.address, "/api/report")
                finally:
                    svc.close()
            finally:
                server.close()
            check(fleet.device.type == "cuda"
                  and fleet.fold_backend == "fused", f"fleet session on "
                  f"{fleet.device} / {fleet.fold_backend}")
            check(body == fleet.export("json").encode("utf-8"),
                  "fleet: /api/report differs from export('json')")
            top = rep.path_str(rep.paths[0])
            check("commit_txn" in top and sorted(rep.per_host()) == [
                "db-1", "web-0"], f"fleet: top path {top}, hosts "
                  f"{sorted(rep.per_host())}")
            off = ProfilerService.from_fleet_dir(fleet_dir, n_min=2.0).start()
            try:
                wbody = get_url(off.address,
                                "/api/whatif?tag=commit_txn&shrink=0")
            finally:
                off.close()
            offline = ProfileSession(FleetSource.from_fleet_dir(fleet_dir),
                                     n_min=2.0).result()
            want = offline.what_if("commit_txn", shrink=0.0)
            check(wbody == want.to_json().encode("utf-8"),
                  "fleet: /api/whatif differs from the offline what_if")
    launches = ops.launch_counts()
    hold_recorded("fleet", calls, launches)
    print(f"[fleet] 2 hosts: {time.perf_counter() - t:.3f} s, "
          f"{rep.total_slices} slices, top path {top} "
          f"{rep.paths[0].cmetric:.6f} s CMetric, what-if commit_txn x0 "
          f"speedup {want.speedup:.4f}, launches {launches}")
    check(launches["carry_cumsum"] >= 1 and launches["hist"] >= 1,
          f"fleet launched {launches}")
    return launches


# -- phase 7: the serving path -----------------------------------------------

#: tiny archs held card against CPU: dense MHA, GQA with qk_norm, local +
#: global with tied embeddings, MoE with logit softcap
SERVE_TINY_ARCHS = ("deepseek-7b", "qwen3-32b", "gemma3-1b", "grok-1-314b")
SERVE_ARCH = "deepseek-7b"


def forward_and_decode(params, cfg, tokens):
    """Forward logits over ``tokens`` (B, T) and the logits of T
    teacher-forced decode steps from a zeroed cache of T slots, stacked to
    (B, T, V), both on the host."""
    import torch
    from repro_torch.models import decode_step, forward, init_decode_state
    b, t_len = tokens.shape
    dev = tokens.device
    full, _ = forward(params, {"tokens": tokens}, cfg)
    state = init_decode_state(cfg, b, t_len, device=dev)
    steps = []
    for t in range(t_len):
        lg, state = decode_step(params, tokens[:, t], torch.full(
            (b,), t, dtype=torch.int32, device=dev), state, cfg)
        steps.append(lg)
    return full.cpu(), torch.stack(steps, 1).cpu()


def _max_diff(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def tiny_archs_on_card(dev, archs=SERVE_TINY_ARCHS, tag="serve") -> None:
    """Tiny ``archs`` in float32, the same parameters (drawn on the CPU
    from the seed, then copied to the card): forward and 8 teacher-forced
    decode steps on both devices, held at rtol/atol 1e-4 (float32 products
    without TF32, summed in another order)."""
    import torch
    from repro_torch import configs
    from repro_torch.models import init_lm
    from repro_torch.models.common import tree_map
    check(not torch.backends.cuda.matmul.allow_tf32,
          "float32 matmuls would run in TF32")
    for arch in archs:
        cfg = dataclasses.replace(configs.get_tiny(arch),
                                  compute_dtype=torch.float32)
        cpu_p = init_lm(torch.Generator().manual_seed(SEED), cfg,
                        device="cpu")
        dev_p = tree_map(lambda x: x.to(dev), cpu_p)
        tokens = torch.from_numpy(np.random.default_rng(SEED).integers(
            0, cfg.vocab_size, (2, 8)).astype(np.int32))
        on_cpu = forward_and_decode(cpu_p, cfg, tokens)
        on_card = forward_and_decode(dev_p, cfg, tokens.to(dev))
        diffs = [_max_diff(a, b) for a, b in zip(on_card, on_cpu)]
        print(f"[{tag}] tiny {arch} float32, card against CPU: forward max "
              f"|diff| {diffs[0]:.3e}, decode {diffs[1]:.3e} (rtol/atol "
              f"1e-4)")
        for what, a, b in zip(("forward", "decode"), on_card, on_cpu):
            check(torch.allclose(a, b, rtol=1e-4, atol=1e-4),
                  f"tiny {arch}: {what} on the card off the CPU's")


def full_width_float32(params, cfg, dev, batch=2, t_len=8,
                       tag="serve", hold=True) -> None:
    """A model at full width, computing in float32 on the masters
    themselves: ``batch`` sequences of ``t_len`` tokens from the seed,
    teacher-forced ``decode_step`` at every position against ``forward``,
    held at rtol/atol 1e-3 (the same float32 products, grouped by cuBLAS
    differently for the step's rows and the sequence's; a recurrent
    block's scan or chunked form against its step form; logits are
    ~N(0, 1)).  ``hold`` False prints the gap by position instead (see
    :func:`rwkv_chunked_against_steps`)."""
    import torch
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    tokens = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (batch, t_len)).astype(np.int32)).to(dev)
    t = time.perf_counter()
    full, dec = forward_and_decode(params, cfg32, tokens)
    secs = time.perf_counter() - t
    d = _max_diff(full, dec)
    ok = bool(torch.isfinite(full).all() and torch.isfinite(dec).all())
    print(f"[{tag}] full-width {cfg.name} float32, decode against forward "
          f"at {t_len} positions x {batch} sequences: max |diff| {d:.3e} "
          f"({'rtol/atol 1e-3' if hold else 'printed'}), logits "
          f"{tuple(full.shape)} finite {ok}, {secs:.2f} s")
    check(ok, f"{tag}: full-width float32 logits not finite")
    if hold:
        check(torch.allclose(dec, full, rtol=1e-3, atol=1e-3),
              f"full-width float32 decode off forward by {d:.3e}")
    else:
        by_pos = (dec.double() - full.double()).abs().amax(dim=(0, 2))
        over = (dec - full).abs() > 1e-3 + 1e-3 * full.abs()
        print(f"[{tag}]   by position: t=0 {float(by_pos[0]):.3e}, "
              f"t>=1 at most {float(by_pos[1:].max()):.3e} (t="
              f"{int(by_pos[1:].argmax()) + 1}); logits past rtol/atol 1e-3"
              f" at positions {sorted(set(over.nonzero()[:, 1].tolist()))}")
    return tokens, full


def rwkv_chunked_against_steps(params, cfg, tokens, tag="recurrent") -> None:
    """RWKV-6's chunked time mix at full width against its token-by-token
    form, layer by layer on the float32 forward's own inputs: each
    layer's ``rwkv_tmix`` over the whole sequence from a zero state
    against T ``rwkv_tmix_step`` calls, outputs and final state held at
    rtol/atol 1e-3 (the two forms are equal in exact arithmetic).  Also
    printed: the median and the smallest per-head mean squares of the time
    mix's output before its group norm (``ln_x``, an RMS norm with eps
    1e-6, which scales each head to unit size and so carries a small
    head's rounding to the logits unscaled), beside the logits' gap by
    position that :func:`full_width_float32` prints."""
    import torch
    from repro_torch.models import forward
    from repro_torch.models import recurrent as rec
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    real, real_norm = rec.rwkv_tmix, rec.rms_norm
    inputs, squares = [], []

    def spy(p, x, c, state=None):
        inputs.append((p, x))
        return real(p, x, c, state)

    def norm_spy(x, scale, eps=1e-6):
        squares.append((x.float() ** 2).mean(-1)[0])     # (S, NH)
        return real_norm(x, scale, eps)
    rec.rwkv_tmix = spy
    try:
        with torch.no_grad():
            forward(params, {"tokens": tokens}, cfg32)
    finally:
        rec.rwkv_tmix = real
    t = time.perf_counter()
    worst = (0.0, -1)
    with torch.no_grad():
        for layer, (p, x) in enumerate(inputs):
            rec.rms_norm = norm_spy
            try:
                y, st = real(p, x, cfg32)
            finally:
                rec.rms_norm = real_norm
            s = rec.init_rwkv_state(cfg32, x.shape[0], device=x.device)
            ys = []
            for i in range(x.shape[1]):
                yi, s = rec.rwkv_tmix_step(p, x[:, i:i + 1], s, cfg32)
                ys.append(yi)
            ys = torch.cat(ys, 1)
            d = max(_max_diff(y, ys), _max_diff(st["s"], s["s"]))
            worst = max(worst, (d, layer))
            check(torch.allclose(ys, y, rtol=1e-3, atol=1e-3)
                  and torch.allclose(s["s"], st["s"], rtol=1e-3, atol=1e-3),
                  f"{tag}: layer {layer}'s chunked time mix off its steps by "
                  f"{d:.3e}")
    sq = torch.stack(squares)                            # (L, S, NH)
    low = sq.flatten().argsort()[:8].tolist()
    n_s, n_h = sq.shape[1], sq.shape[2]
    where = ", ".join(f"t={i // n_h % n_s} layer {i // (n_s * n_h)} "
                      f"{float(sq.flatten()[i]):.2e}" for i in low)
    print(f"[{tag}] {cfg.name} chunked time mix against {tokens.shape[1]} "
          f"steps, every layer on the forward's inputs: max |diff| "
          f"{worst[0]:.3e} (layer {worst[1]}; rtol/atol 1e-3), "
          f"{time.perf_counter() - t:.2f} s; per-head mean square before "
          f"the group norm: median {float(sq.median()):.2e}, smallest "
          f"{where}")


def serving_copy_on_card(params, cfg, tokens, full32, tag="recurrent"):
    """The serving copy (bf16 matrices, the float32 ones kept) against the
    float32 masters at full width, both computing in bf16: forward and 4
    decode steps equal bit for bit (the copy gives the per-call casts'
    values).  The bf16 logits against the float32 ones are printed."""
    import torch
    from repro_torch.models import decode_step, forward, init_decode_state
    from repro_torch.serve.engine import _serving_params
    served = _serving_params(params, cfg)
    b = tokens.shape[0]
    out = {}
    with torch.no_grad():
        for name, p in (("masters", params), ("copy", served)):
            full, _ = forward(p, {"tokens": tokens}, cfg)
            state = init_decode_state(cfg, b, 4, device=tokens.device)
            steps = []
            for t in range(4):
                lg, state = decode_step(p, tokens[:, t], torch.full(
                    (b,), t, dtype=torch.int32, device=tokens.device), state,
                    cfg)
                steps.append(lg)
            out[name] = (full, torch.stack(steps, 1))
    same = all(torch.equal(a, c) for a, c in zip(out["masters"],
                                                 out["copy"]))
    bf = out["copy"][0].float().cpu()
    agree = float((bf.argmax(-1) == full32.argmax(-1)).float().mean())
    print(f"[{tag}] full-width {cfg.name} bfloat16: the serving copy's "
          f"forward and 4 decode steps equal the masters' bit for bit "
          f"{same}; against the float32 forward (printed): max |diff| "
          f"{_max_diff(bf, full32):.3e}, argmax agrees at {agree:.4f} of "
          f"the positions")
    check(same, f"{tag}: the serving copy's bf16 logits differ from the "
          f"masters'")


def engine_on_card(dev) -> None:
    """The ``Engine`` on the card against the same engine on the CPU: tiny
    deepseek-7b in float32, the same parameters (drawn on the CPU from the
    seed, then copied), 8 slots and a 128-slot cache over the serve_engine
    example's 16 requests; every request's output tokens equal.  This runs
    the engine's in-place token and position writes, the reuse of a slot
    by a later request and the long requests' wrap of the cache ring."""
    import torch
    from repro_torch import configs
    from repro_torch.examples.serve_engine import make_requests
    from repro_torch.models import init_lm
    from repro_torch.models.common import tree_map
    from repro_torch.serve.engine import Engine
    cfg = dataclasses.replace(configs.get_tiny(SERVE_ARCH),
                              compute_dtype=torch.float32)
    cpu_p = init_lm(torch.Generator().manual_seed(SEED), cfg, device="cpu")
    outs = {}
    for where, p in (("cpu", cpu_p),
                     ("card", tree_map(lambda x: x.to(dev), cpu_p))):
        engine = Engine(cfg, p, batch_slots=8, cache_len=128,
                        device="cpu" if where == "cpu" else dev)
        done = engine.run(make_requests(cfg.vocab_size))
        outs[where] = {r.rid: list(r.out) for r in done}
    same = sum(outs["card"].get(rid) == out
               for rid, out in outs["cpu"].items())
    print(f"[serve] tiny {SERVE_ARCH} float32 Engine (8 slots, 128-slot "
          f"cache, 16 requests), card against CPU: {same} of "
          f"{len(outs['cpu'])} requests' tokens equal, "
          f"{sum(map(len, outs['card'].values()))} tokens")
    check(len(outs["cpu"]) == 16 and same == 16,
          "the Engine's tokens on the card differ from the CPU's")


def full_width_bf16(served, cfg, tokens, full32, tag="serve",
                    hold=True) -> None:
    """The serving copy (bfloat16 matrices) in bfloat16 compute, forward
    and a teacher-forced decode step at every position of the float32
    check's tokens, held against the float32 forward logits at rtol/atol
    0.15, the reference's own bound for its bf16 paths
    (tests/test_models.py); ``hold`` False prints the gap (phase 9:
    :func:`serving_copy_on_card` holds the copy instead)."""
    import torch
    bf = forward_and_decode(served, cfg, tokens)
    for what, x in zip(("forward", "decode"), bf):
        x = x.float()
        agree = float((x.argmax(-1) == full32.argmax(-1)).float().mean())
        print(f"[{tag}] full-width {cfg.name} bfloat16 {what} (the serving "
              f"copy) against float32 forward: max |diff| "
              f"{_max_diff(x, full32):.3e} "
              f"({'rtol/atol 0.15' if hold else 'printed'}), argmax "
              f"agrees at {agree:.4f} of the positions")
        check(bool(torch.isfinite(x).all()),
              f"full-width bfloat16 {what} not finite")
        if hold:
            check(torch.allclose(x, full32, rtol=0.15, atol=0.15),
                  f"full-width bfloat16 {what} off float32 forward")


def decode_bytes(engine) -> int:
    """Bytes one decode step must move at least: every weight matrix the
    blocks and the unembedding read (the serving copy), the embedding rows
    it gathers (the whole table where the unembedding is tied to it), the
    vectors (norm scales, biases) and the whole decode state the step
    reads (K/V caches, recurrent states); outputs are noise beside
    them."""
    from repro_torch.models.common import tree_leaves
    p = engine.params
    n = sum(x.numel() * x.element_size() for k, v in p.items()
            if k != "embed" for x in tree_leaves(v))
    emb = p["embed"]
    rows = emb.shape[0] if engine.cfg.tie_embeddings else engine.slots
    n += rows * emb.shape[1] * emb.element_size()
    n += sum(x.numel() * x.element_size() for x in tree_leaves(engine.state))
    return n


def _timed_steps(engine):
    """Wrap ``engine._step``: per step, the host's issue time (the call,
    which returns before the device is done) and CUDA events around it."""
    import torch
    real = engine._step
    issue, events = [], []

    def step(*a, **k):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        e0.record()
        out = real(*a, **k)
        e1.record()
        issue.append(time.perf_counter() - t)
        events.append((e0, e1))
        return out
    engine._step = step
    return issue, events


def _timed_drains(sess):
    """Wrap the session tracer's ``sync`` (the drain loop's call): the host
    latency of every sync, and of those that drained and folded events
    (each of those launches the fold's prefix on the card)."""
    real = sess.tracer.sync
    lat, folded, hooks = [], [], []

    def sync(*a, **k):
        n = len(hooks)
        t = time.perf_counter()
        out = real(*a, **k)
        lat.append(time.perf_counter() - t)
        if len(hooks) > n:
            folded.append(lat[-1])
        return out
    sess.tracer.sync = sync
    sess.tracer.on_drain.append(hooks.append)
    return lat, folded


def serve_run(cfg, params, dev, with_session: bool, *, record=False,
              ops=None, tag="serve"):
    """One serve_engine flow at full width: an ``Engine`` of 8 slots and a
    128-slot cache over the example's 16 requests, after one warm-up step,
    with a GAPP session (n_min None, probe and drain every 2 ms, on the
    card) or without.
    Returns the numbers of the run, and with ``record`` its kernel calls
    held against their plain versions and its launches."""
    import torch
    from repro_torch.core import ProfileSession
    from repro_torch.examples.serve_engine import make_requests, serve, warm_up
    from repro_torch.serve.engine import Engine
    sess = None
    if with_session:
        sess = ProfileSession(n_min=None, dt=0.002, device=dev)
    engine = Engine(cfg, params, batch_slots=8, cache_len=128, gapp=sess,
                    device=dev)
    warm_up(engine)
    reqs = make_requests(cfg.vocab_size)
    issue, events = _timed_steps(engine)
    lat, folded = _timed_drains(sess) if sess is not None else ([], [])
    out = {"engine": engine}
    if record:
        ops.reset_launch_counts()
    torch.cuda.synchronize()
    with recording() if record else contextlib.nullcontext() as calls:
        finished, wall = serve(engine, reqs, sess)
        if sess is not None:
            rep = sess.result()
            wi = rep.what_if(path=1, shrink=0.0)
            out.update(rep=rep, what_if=wi)
        torch.cuda.synchronize()
    if record:
        out["launches"] = ops.launch_counts()
        hold_recorded(tag, calls, out["launches"])
    steps = len(issue)
    dev_ms = sum(a.elapsed_time(b) for a, b in events) / steps
    toks = sum(len(r.out) for r in finished)
    out.update(
        finished=finished, wall=wall, steps=steps, tokens=toks,
        ms_step=wall * 1e3 / steps, dev_ms=dev_ms,
        issue_ms=sum(issue) * 1e3 / steps, tok_s=toks / wall,
        drains=len(folded), syncs=len(lat),
        sync_ms=(sum(lat) * 1e3 / len(lat)) if lat else None,
        drain_ms=(sum(folded) * 1e3 / len(folded)) if folded else None)
    return out


def device_summary(prof, steps: int, wall: float) -> dict:
    """A ``torch.profiler`` run of ``steps`` steps that took ``wall``
    seconds, a step: the wall, the device's busy time (kernels and
    copies) and launches, those of the matrix products, and the six
    heaviest kernels (name, ms, launches)."""
    import torch
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    # cuBLAS's matrix-product kernels (nvjet_* on this toolkit)
    mm = [e for e in rows if any(w in e.key.lower() for w in (
        "nvjet", "gemm", "gemv", "xmma", "cutlass"))]
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:6]
    return {"wall_ms": wall * 1e3 / steps,
            "busy_ms": sum(e.self_device_time_total for e in rows) / 1e3
            / steps,
            "launches": sum(e.count for e in rows) / steps,
            "gemm_ms": sum(e.self_device_time_total for e in mm) / 1e3
            / steps,
            "gemm_launches": sum(e.count for e in mm) / steps,
            "top": [(e.key[:70], e.self_device_time_total / 1e3 / steps,
                     e.count // steps) for e in top]}


def decode_breakdown(cfg, params, dev, steps: int = 8,
                     host_profile: bool = False, tag="serve") -> dict:
    """Where a decode step's time goes, from ``torch.profiler`` over
    ``steps`` steps of an engine (no session) with every slot busy: the
    device's busy time a step (kernels and copies), the launches a step,
    the share of the matrix products, and the heaviest kernels; with
    ``host_profile`` also the host's time by function (cProfile)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.examples.serve_engine import make_requests
    from repro_torch.serve.engine import Engine, Request
    engine = Engine(cfg, params, batch_slots=8, cache_len=128, device=dev)
    for r in make_requests(cfg.vocab_size)[:8]:
        engine.submit(Request(r.rid, r.prompt, 10_000))
    engine.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    out = device_summary(prof, steps, wall)
    busy, launches = out["busy_ms"], out["launches"]
    gemm, gemm_n = out["gemm_ms"], out["gemm_launches"]
    print(f"[{tag}] decode step under torch.profiler ({steps} steps, 8 "
          f"busy slots): wall {out['wall_ms']:.3f} ms, device busy "
          f"{busy:.3f} ms ({100 * (1 - busy / out['wall_ms']):.1f}% idle), "
          f"{launches:.0f} kernels and copies a step; matrix products "
          f"{gemm:.3f} ms in {gemm_n:.0f} kernels, the rest "
          f"{busy - gemm:.3f} ms in {launches - gemm_n:.0f}")
    for name, ms, n in out["top"]:
        print(f"[{tag}]   {ms:.3f} ms a step, {n} a step: {name}")
    if not host_profile:
        return out
    # the host's side: the calls that take its time, under cProfile alone
    import cProfile
    import pstats
    prog = cProfile.Profile()
    prog.enable()
    for _ in range(steps):
        engine.step()
    torch.cuda.synchronize()
    prog.disable()
    st = pstats.Stats(prog)
    own = sorted(((v[2], v[1], f"{k[0].rsplit('/', 1)[-1]}:{k[1]}({k[2]})")
                  for k, v in st.stats.items()), reverse=True)[:8]
    print(f"[{tag}] decode step on the host (cProfile, {steps} steps): "
          + "; ".join(f"{name} {1e3 * tt / steps:.2f} ms, {n // steps} "
                      f"calls" for tt, n, name in own))
    return out


def serve_path(ops, dev, host_profile: bool = False) -> dict:
    """Phase 7: tiny archs and the tiny ``Engine`` card against CPU,
    deepseek-7b at its published width in float32 (decode against
    forward), then :func:`serve_flow` at that width.  Returns the recorded
    run's kernel launches."""
    import torch
    from repro_torch import configs
    from repro_torch.models import init_lm
    t_phase = time.perf_counter()
    tiny_archs_on_card(dev)
    engine_on_card(dev)

    cfg = configs.get_config(SERVE_ARCH)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    params = init_lm(torch.Generator(dev).manual_seed(SEED), cfg,
                     device=dev)
    torch.cuda.synchronize()
    print(f"[serve] {cfg.name} full width: {cfg.param_count():,} "
          f"parameters, float32 masters drawn on the card in "
          f"{time.perf_counter() - t:.2f} s, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    tokens, full32 = full_width_float32(params, cfg, dev)
    masters = [params]
    del params
    return serve_flow(ops, dev, cfg, masters, tokens, full32, t_phase,
                      "serve", 7, host_profile)


def serve_flow(ops, dev, cfg, masters: list, tokens, full32, t_phase,
               tag: str, phase: int, host_profile: bool = False,
               bf16_hold: bool = True) -> dict:
    """The serve_engine flow at full width in bfloat16 under a GAPP
    session (all requests finished, a long request ranked first, a finite
    what-if, every kernel call held), the serving copy's bfloat16 logits
    against the float32 ones (``tokens``, ``full32``), ``torch.profiler``
    over 8 steps, and the same flow without and with the session in
    turns, for the numbers.  ``masters`` holds the float32 masters alone,
    so that they are freed once the engine has made its serving copy.
    Returns the recorded run's kernel launches."""
    import torch
    # the serving copy (bfloat16 matrices) is made once; the masters go
    run = serve_run(cfg, masters.pop(), dev, True, record=True, ops=ops,
                    tag=tag)
    served = run["engine"].params
    torch.cuda.empty_cache()
    finished, rep, wi = run["finished"], run["rep"], run["what_if"]
    launches = run["launches"]
    print(f"[{tag}] peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
          f" GB; GAPP run: {len(finished)} requests, {run['tokens']} tokens "
          f"in {run['steps']} steps, {run['wall']:.3f} s, launches {launches}")
    check(len(finished) == 16 and all(len(r.out) == r.max_new
                                      for r in finished),
          f"{tag}: a request did not finish with max_new tokens")
    top = rep.path_str(rep.paths[0]) if rep.paths else "?"
    print(f"[{tag}] top critical path {top} {rep.paths[0].cmetric:.6f} s "
          f"CMetric; what-if path 1 removed: {wi.speedup:.4f}x "
          f"(saves {wi.saved_s * 1e3:.3f} ms)")
    check("req3" in top or "req7" in top, f"{tag}: top path {top}")
    check(math.isfinite(wi.speedup), f"{tag}: what-if speedup {wi.speedup}")
    check(launches["carry_cumsum"] >= 1, f"{tag} launched {launches}")

    nbytes = decode_bytes(run["engine"])
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"[{tag}] decode step byte bound: {nbytes / 1e9:.4f} GB "
          f"(bf16 weights + the embedding rows read + vectors + the decode "
          f"state), {bound:.4f} ms at {HBM_BYTES_PER_S / 1e12:.2f} TB/s")
    del run
    full_width_bf16(served, cfg, tokens, full32, tag=tag, hold=bf16_hold)
    brk = decode_breakdown(cfg, served, dev, host_profile=host_profile,
                           tag=tag)
    timed = {True: [], False: []}
    for mode in (False, True, False, True):
        r = serve_run(cfg, served, dev, mode)
        timed[mode].append(r)
        label = "with GAPP" if mode else "without GAPP"
        drains = (f"; session: {r['syncs']} syncs (mean "
                  f"{r['sync_ms']:.3f} ms), {r['drains']} of them drained "
                  f"events (mean {r['drain_ms']:.3f} ms)" if mode else "")
        print(f"[{tag}] {label}: {r['ms_step']:.3f} ms a step "
              f"({r['steps']} steps, {100 * bound / r['ms_step']:.1f}% of "
              f"the bound), {r['tok_s']:.1f} tokens/s; host issue (the "
              f"step's call) {r['issue_ms']:.3f} ms, CUDA events around "
              f"the step {r['dev_ms']:.3f} ms, wall - device busy "
              f"{r['ms_step'] - brk['busy_ms']:.3f} ms{drains}")
        check(len(r["finished"]) == 16, f"{tag}: timed run lost a request")
        del r["engine"]
    mean = {k: sum(r["ms_step"] for r in v) / len(v)
            for k, v in timed.items()}
    print(f"[{tag}] GAPP overhead: {mean[True]:.3f} / {mean[False]:.3f} ms "
          f"a step = {mean[True] / mean[False]:.4f}; phase {phase} "
          f"{time.perf_counter() - t_phase:.1f} s")
    return launches


# -- phase 8: the training path ----------------------------------------------

TRAIN_ARCH = "gemma3-1b"
TRAIN_BATCH, TRAIN_SEQ = 4, 1024      # 1,024 > the 512-token local window
TRAIN_STEPS = 8                       # a phase of the train_lm flow
BF16_OPS_PER_S = 989e12               # H100 SXM data sheet, dense bf16


def train_steps_tiny(cfg, params, dev, steps: int = 3):
    """``steps`` float32 ``make_train_step`` steps on ``dev`` from a copy
    of ``params`` over seeded batches (B = 4, S = 16): the losses and the
    final ``{"params", "opt"}`` tree on the host."""
    import torch
    from repro_torch.models.common import tree_map
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_step
    step = make_train_step(cfg, adamw.AdamWConfig(
        lr=3e-3, warmup_steps=1, total_steps=10, eps=1e-3))
    p = tree_map(lambda x: x.to(dev, copy=True), params)
    s = adamw.init(p)
    losses = []
    for i in range(steps):
        toks = np.random.default_rng(SEED + i).integers(
            0, cfg.vocab_size, (4, 16)).astype(np.int32)
        p, s, m, _ = step(p, s, {"tokens": torch.from_numpy(toks).to(dev)},
                          None)
        losses.append(float(m["loss"]))
    return losses, tree_map(lambda x: x.cpu(), {"params": p, "opt": s})


def train_tiny_on_card(dev, archs=SERVE_TINY_ARCHS, tag="train") -> None:
    """Tiny ``archs`` in float32, the same parameters (drawn on the
    CPU from the seed): three train steps (backward with remat, AdamW) on
    the card and on the CPU, each step's loss and the parameters and
    moments after the third held at rtol/atol 1e-4 (TF32 off; AdamW's eps
    1e-3, since with 1e-8 a parameter whose gradient is ~1e-8 moves by up
    to lr either way on the rounding of that gradient)."""
    import torch
    from repro_torch import configs
    from repro_torch.models import init_lm
    from repro_torch.models.common import tree_items
    check(not torch.backends.cuda.matmul.allow_tf32,
          "float32 matmuls would run in TF32")
    for arch in archs:
        cfg = dataclasses.replace(configs.get_tiny(arch),
                                  compute_dtype=torch.float32)
        cpu_p = init_lm(torch.Generator().manual_seed(SEED), cfg,
                        device="cpu")
        l_cpu, t_cpu = train_steps_tiny(cfg, cpu_p, "cpu")
        l_dev, t_dev = train_steps_tiny(cfg, cpu_p, dev)
        d_tree = max(_max_diff(a, b) for (_, a), (_, b) in zip(
            tree_items(t_dev), tree_items(t_cpu)))
        ok = all(torch.allclose(a, b, rtol=1e-4, atol=1e-4) for (_, a), (
            _, b) in zip(tree_items(t_dev), tree_items(t_cpu)))
        print(f"[{tag}] tiny {arch} float32, 3 steps card against CPU: "
              f"losses {', '.join(f'{x:.6f}' for x in l_dev)} (CPU "
              f"{', '.join(f'{x:.6f}' for x in l_cpu)}), params and moments "
              f"max |diff| {d_tree:.3e} (rtol/atol 1e-4)")
        check(np.allclose(l_dev, l_cpu, rtol=1e-4, atol=1e-4) and ok,
              f"tiny {arch}: training on the card off the CPU's")


def train_flops(cfg, tokens: int) -> tuple[float, float]:
    """(FLOPs of one training step, of which attention): 6 N tokens for
    the products with the weights (the tied embedding counted once, as the
    unembedding), plus the score and value products of every layer over
    the whole S x S square this implementation computes (a local layer
    masks it, it does not skip it), forward and backward (x3); remat's
    recompute not counted."""
    s = TRAIN_SEQ
    attn = 3 * 4 * (tokens // s) * cfg.num_heads * s * s * cfg.hd \
        * cfg.num_layers
    return 6.0 * cfg.param_count() * tokens + attn, float(attn)


def timed_step(step_fn, times: list):
    """``step_fn`` with its host time to the end of the step's device work
    (a read of the loss) appended to ``times``; the trainer's own read of
    the loss then finds it done."""
    def step(*a):
        t = time.perf_counter()
        out = step_fn(*a)
        float(out[2]["loss"])
        times.append(time.perf_counter() - t)
        return out
    return step


def _ckpt_timing(ckpt_lib):
    """Wrap ``checkpoint.save``: the host seconds of its synchronous
    snapshot (the call) and the wall-clock end of the call, to set
    against the written ``.complete``'s modification time."""
    real = ckpt_lib.save
    out = {}

    def save(directory, step, tree, *a, **k):
        t = time.perf_counter()
        thread = real(directory, step, tree, *a, **k)
        out.update(snapshot_s=time.perf_counter() - t, returned=time.time(),
                   dir=os.path.join(directory, f"step_{step:06d}"))
        return thread
    ckpt_lib.save = save
    return out, lambda: setattr(ckpt_lib, "save", real)


def train_breakdown(cfg, step_fn, dev, steps: int = 3) -> dict:
    """Where a training step's time goes, from ``torch.profiler`` over
    ``steps`` steps on a fresh state (after one step outside it): the
    device's busy time and kernels a step, the matrix products' share,
    the heaviest kernels, and the host's own time by operator."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import init_lm
    from repro_torch.optim import adamw
    params = init_lm(torch.Generator(dev).manual_seed(SEED), cfg, device=dev)
    opt = adamw.init(params)
    toks = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks).to(dev)}
    params, opt, m, _ = step_fn(params, opt, batch, None)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(steps):
            params, opt, m, _ = step_fn(params, opt, batch, None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    out = device_summary(prof, steps, wall)
    busy, launches = out["busy_ms"], out["launches"]
    gemm, gemm_n = out["gemm_ms"], out["gemm_launches"]
    print(f"[train] step under torch.profiler ({steps} steps): wall "
          f"{out['wall_ms']:.3f} ms, device busy {busy:.3f} ms "
          f"({100 * (1 - busy / out['wall_ms']):.1f}% idle), {launches:.0f} "
          f"kernels and copies a step; matrix products {gemm:.3f} ms in "
          f"{gemm_n:.0f}, the rest {busy - gemm:.3f} ms in "
          f"{launches - gemm_n:.0f}")
    for name, ms, n in out["top"]:
        print(f"[train]   device {ms:.3f} ms a step, {n} a step: {name}")
    host = [e for e in prof.key_averages() if e.self_cpu_time_total > 0]
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:6]:
        print(f"[train]   host {e.self_cpu_time_total / 1e3 / steps:.3f} ms "
              f"a step, {e.count // steps} calls a step: {e.key[:60]}")
    return out


def train_run(cfg, opt_cfg, step_fn, dev, with_session: bool,
              steps: int = 4) -> dict:
    """One healthy ``Trainer`` run of ``steps`` steps and no checkpoint,
    under a fused session on the card (probe every 2 ms) or none; every
    kernel call of a session held against its plain version."""
    import torch
    from repro_torch.core import ProfileSession
    from repro_torch.kernels import ops
    from repro_torch.train.trainer import Trainer, TrainerConfig
    times = []
    sess = ProfileSession(dt=0.002, device=dev) if with_session else None
    tcfg = TrainerConfig(steps=steps, batch_per_host=TRAIN_BATCH,
                         seq_len=TRAIN_SEQ, ckpt_every=0, log_every=10**6,
                         profile=with_session, seed=SEED)
    tr = Trainer(cfg, opt_cfg, tcfg, gapp=sess,
                 step_fn=timed_step(step_fn, times), device=dev)
    lat, folded = _timed_drains(sess) if sess is not None else ([], [])
    ops.reset_launch_counts()
    with recording() as calls:
        t = time.perf_counter()
        tr.run()
        wall = time.perf_counter() - t
        if sess is not None:
            sess.result()
        torch.cuda.synchronize()
    if sess is not None:
        hold_recorded("train timing", calls, ops.launch_counts())
    check(all(math.isfinite(h["loss"]) for h in tr.history),
          "train: a timed run's loss is not finite")
    return {"ms_step": 1e3 * float(np.median(times)),
            "mean_ms": 1e3 * float(np.mean(times)),
            "wall_ms": 1e3 * wall / steps, "syncs": len(lat),
            "sync_ms": 1e3 * sum(lat) / max(len(lat), 1),
            "drains": len(folded),
            "drain_ms": 1e3 * sum(folded) / max(len(folded), 1)}


def train_path(ops, dev, card: str) -> dict:
    """Phase 8: tiny archs' training card against CPU, then the train_lm
    flow at gemma3-1b's published width on the card under fused GAPP
    sessions: a healthy phase with one async checkpoint (restored bit for
    bit, then deleted) and a phase with the loader slowed to 1.5x the
    step, the slowdown ranked on ``data/generate``; then ``torch.profiler``
    over 3 steps and the flow without and with the session in turns.
    Every number printed is this card's (``card``: its name and power
    limit).  Returns the flow's kernel launches."""
    import shutil
    import tempfile
    import torch
    from repro_torch import configs
    from repro_torch.ckpt import checkpoint
    from repro_torch.examples.train_lm import (data_bound, loader_delay,
                                               train_phase)
    from repro_torch.models.common import tree_items
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_step
    from repro_torch.train.trainer import TrainerConfig
    import gc
    t_phase = time.perf_counter()
    t = time.perf_counter()
    gc.collect()
    print(f"[train] card: {card}; the process holds {len(gc.get_objects()):,}"
          f" tracked objects (a full collection {time.perf_counter() - t:.3f}"
          f" s) and threads {[th.name for th in threading.enumerate()]}")
    train_tiny_on_card(dev)
    print(f"[train] tiny archs {time.perf_counter() - t_phase:.1f} s")

    cfg = configs.get_config(TRAIN_ARCH)
    n = cfg.param_count()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops, attn = train_flops(cfg, tokens)
    bound = flops / BF16_OPS_PER_S * 1e3
    print(f"[train] {cfg.name} full width: {n:,} parameters ({cfg.num_layers}"
          f" layers, d_model {cfg.d_model}, vocab {cfg.vocab_size:,}), bf16 "
          f"compute over float32 masters, B = {TRAIN_BATCH}, S = "
          f"{TRAIN_SEQ}: {flops / 1e12:.3f} TFLOP a step (attention "
          f"{attn / 1e12:.3f}), compute bound {bound:.3f} ms at "
          f"{BF16_OPS_PER_S / 1e12:.0f} TFLOP/s bf16")
    check(n == 999_811_584, f"gemma3-1b has {n} parameters")
    opt_cfg = adamw.AdamWConfig(lr=3e-4, warmup_steps=2,
                                total_steps=2 * TRAIN_STEPS)
    step_fn = make_train_step(cfg, opt_cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ckpt_dir = tempfile.mkdtemp(prefix="gapp-train-ckpt-")
    times1, times2 = [], []
    timing, unwrap = _ckpt_timing(checkpoint)
    ops.reset_launch_counts()
    try:
        with recording() as calls:
            # ckpt_every past the run: only the final checkpoint, at step 8
            tcfg = TrainerConfig(steps=TRAIN_STEPS, batch_per_host=TRAIN_BATCH,
                                 seq_len=TRAIN_SEQ, ckpt_every=10**6,
                                 ckpt_dir=ckpt_dir, log_every=4, seed=SEED)
            t1, params, opt = train_phase(cfg, opt_cfg, tcfg,
                                          timed_step(step_fn, times1), dev)
            rep1 = t1.profile_report()
            launches1 = ops.launch_counts()
            unwrap()
            # the checkpoint of the state phase 1 ended with, restored
            # before phase 2 draws its own
            check(checkpoint.latest_step(ckpt_dir) == TRAIN_STEPS,
                  f"train: latest checkpoint "
                  f"{checkpoint.latest_step(ckpt_dir)}")
            nbytes = sum(os.path.getsize(os.path.join(timing["dir"], f))
                         for f in os.listdir(timing["dir"]))
            write_s = os.path.getmtime(os.path.join(
                timing["dir"], ".complete")) - timing["returned"]
            state = {"params": params, "opt": opt}
            t = time.perf_counter()
            back = checkpoint.restore(ckpt_dir, TRAIN_STEPS, state,
                                      device=dev)
            restore_s = time.perf_counter() - t
            same = all(torch.equal(a, b) for (_, a), (_, b) in zip(
                tree_items(back), tree_items(state)))
            del back, state, params, opt
            shutil.rmtree(ckpt_dir, ignore_errors=True)
            delay, step_s = loader_delay(t1)
            tcfg2 = dataclasses.replace(tcfg, ckpt_every=0,
                                        loader_delay_s=delay)
            t2, _, _ = train_phase(cfg, opt_cfg, tcfg2,
                                   timed_step(step_fn, times2), dev)
            rep2 = t2.profile_report()
            torch.cuda.synchronize()
        launches = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        hold_recorded("train", calls, launches)
        del calls
    finally:
        unwrap()
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    print(f"[train] checkpoint at step {TRAIN_STEPS}: {nbytes / 1e9:.3f} GB "
          f"(params, mu, nu), snapshot to the host {timing['snapshot_s']:.3f}"
          f" s, written in {write_s:.3f} s on the writer thread, restored in "
          f"{restore_s:.3f} s, bit-equal {same}")
    check(same, "train: the restored checkpoint differs from the state saved")

    hist = t1.history + t2.history
    l1 = [h["loss"] for h in t1.history]
    norms = [h["grad_norm"] for h in t1.history]
    print(f"[train] phase 1 (healthy): losses "
          f"{', '.join(f'{x:.4f}' for x in l1)}; grad norms "
          f"{', '.join(f'{x:.3f}' for x in norms)}")
    check(all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
              for h in hist), "train: a loss or grad norm is not finite")
    check(l1[-1] < l1[0], f"train: phase 1's loss did not drop: {l1}")
    check({"trainer", "data_loader", "ckpt_writer"} <= set(rep1.worker_names),
          f"train: workers {rep1.worker_names}")
    top1 = [rep1.path_str(p) for p in rep1.paths[:2]]
    top2 = [rep2.path_str(p) for p in rep2.paths[:2]]
    print(f"[train] phase 1 top paths {top1}; loader stall for phase 2 "
          f"{delay * 1e3:.1f} ms (1.5x the {step_s * 1e3:.1f} ms phase-1 "
          f"step by the trainer's CMetric); phase 2 top paths {top2}")
    check(data_bound(rep2), f"train: phase 2's top paths {top2}")
    check(launches["carry_cumsum"] >= 1 and launches["hist"] >= 1,
          f"train launched {launches}")
    med = 1e3 * float(np.median(times1))
    print(f"[train] phase 1: {med:.3f} ms a step (median of {len(times1)}; "
          f"first {times1[0] * 1e3:.3f} ms), {tokens / med * 1e3:.1f} tokens/s,"
          f" {flops / (med * 1e-3) / 1e12:.1f} TFLOP/s = "
          f"{100 * bound / med:.2f}% of {BF16_OPS_PER_S / 1e12:.0f} "
          f"TFLOP/s bf16; peak device memory {peak / 1e9:.2f} GB; launches "
          f"{launches} (phase 1 alone {launches1})")
    del t1, t2, rep1, rep2
    torch.cuda.empty_cache()
    print(f"[train] the flow at full width: phase 8 at "
          f"{time.perf_counter() - t_phase:.1f} s")

    brk = train_breakdown(cfg, step_fn, dev)
    timed = {True: [], False: []}
    for mode in (False, True, False, True):
        r = train_run(cfg, opt_cfg, step_fn, dev, mode)
        timed[mode].append(r)
        drains = (f"; session: {r['syncs']} syncs (mean {r['sync_ms']:.3f} "
                  f"ms), {r['drains']} of them drained events (mean "
                  f"{r['drain_ms']:.3f} ms)" if mode else "")
        print(f"[train] {'with' if mode else 'without'} GAPP: "
              f"{r['ms_step']:.3f} ms a step (median; mean {r['mean_ms']:.3f},"
              f" wall {r['wall_ms']:.3f} a step), "
              f"{tokens / r['ms_step'] * 1e3:.1f} tokens/s, "
              f"{100 * bound / r['ms_step']:.2f}% of the compute bound; "
              f"step - device busy {r['ms_step'] - brk['busy_ms']:.3f} ms"
              f"{drains}")
    mean = {k: sum(r["ms_step"] for r in v) / len(v) for k, v in timed.items()}
    print(f"[train] GAPP overhead: {mean[True]:.3f} / {mean[False]:.3f} ms a "
          f"step = {mean[True] / mean[False]:.4f}; phase 8 "
          f"{time.perf_counter() - t_phase:.1f} s")
    return launches


# -- phase 9: the recurrent archs ----------------------------------------------

RECURRENT_ARCHS = ("recurrentgemma-2b", "rwkv6-1.6b")
#: (B, T) of the full-width float32 forward against decode: recurrentgemma
#: inside its 2,048-token window; rwkv6 two whole chunks of 128
RECURRENT_FORWARD = {"rwkv6-1.6b": (1, 256), "recurrentgemma-2b": (2, 64)}


def profiled(fn, calls: int = 3) -> dict:
    """:func:`device_summary` of ``calls`` calls of ``fn`` under
    ``torch.profiler``, after one warm-up call: a call's wall, device busy
    time and launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    return device_summary(prof, calls, wall)


def recurrent_forward_work(params, cfg, tokens) -> dict:
    """Where the float32 forward's device time goes: the whole forward
    over ``tokens`` under ``torch.profiler``, and its recurrent pieces
    replayed alone on the inputs the forward handed them: the RG-LRU scan
    (``_rglru_scan``), or RWKV's time mix and its five projections (the
    chunked form, with its sub-chunk block loop, is the difference).
    These are the candidates for hand-written kernels; none is built."""
    import torch
    from repro_torch.models import forward
    from repro_torch.models import recurrent as rec
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    name = "rwkv_tmix" if "rwkv" in cfg.block_pattern else "_rglru_scan"
    real = getattr(rec, name)
    seen = []

    def spy(*a, **k):
        seen.append((a, k))
        return real(*a, **k)
    with torch.no_grad():
        setattr(rec, name, spy)
        try:
            forward(params, {"tokens": tokens}, cfg32)
        finally:
            setattr(rec, name, real)
        (args, kw), calls = seen[0], len(seen)
        del seen
        whole = profiled(lambda: forward(params, {"tokens": tokens}, cfg32),
                         1)
        piece = profiled(lambda: real(*args, **kw), 10)
        out = {"forward": whole, name: piece, "calls": calls}
        if name == "rwkv_tmix":
            p, x, c = args
            prev = torch.zeros_like(x[:, :1])
            out["projections"] = profiled(
                lambda: rec._rwkv_project(p, x, prev, c), 10)
    b, t_len = tokens.shape
    print(f"[recurrent] {cfg.name} float32 forward B={b} T={t_len} under "
          f"torch.profiler: wall {whole['wall_ms']:.3f} ms, device busy "
          f"{whole['busy_ms']:.3f} ms in {whole['launches']:.0f} kernels and "
          f"copies; matrix products {whole['gemm_ms']:.3f} ms in "
          f"{whole['gemm_launches']:.0f}")
    for what, r in out.items():
        if what in ("forward", "calls"):
            continue
        if not r["launches"]:
            print(f"[recurrent]   {what} alone: not measured (the profiler "
                  f"recorded no device activity)")
            continue
        print(f"[recurrent]   {what} alone, a call: device busy "
              f"{r['busy_ms']:.4f} ms in {r['launches']:.0f} launches (wall "
              f"{r['wall_ms']:.3f} ms); {calls} calls a forward: "
              f"{r['busy_ms'] * calls:.3f} ms, "
              f"{r['launches'] * calls:.0f} launches")
    if name == "rwkv_tmix" and out["projections"]["launches"]:
        tm, pr = out["rwkv_tmix"], out["projections"]
        print(f"[recurrent]   the chunked form (time mix less its "
              f"projections), a call: {tm['busy_ms'] - pr['busy_ms']:.4f} "
              f"ms in {tm['launches'] - pr['launches']:.0f} launches; "
              f"{calls} calls: {(tm['busy_ms'] - pr['busy_ms']) * calls:.3f}"
              f" ms, {(tm['launches'] - pr['launches']) * calls:.0f} launches")
    return out


def recurrent_path(ops, dev, card: str, host_profile: bool = False) -> dict:
    """Phase 9: the two recurrent archs.  Their tiny configs card against
    CPU (forward, 8 decode steps, 3 train steps); each at its published
    width in float32 on masters drawn on the card from the seed: decode
    against forward (held at 1e-3 for recurrentgemma-2b inside its window;
    for rwkv6-1.6b over two chunks printed, and each layer's chunked time
    mix held against its steps), the recurrent pieces' device work, and
    the bf16 serving copy held bit for bit against the masters; then
    :func:`serve_flow` serving recurrentgemma-2b under GAPP (the bf16
    logits against float32 printed there).  Returns the recorded run's
    kernel launches."""
    import torch
    from repro_torch import configs
    from repro_torch.models import init_lm
    t_phase = time.perf_counter()
    print(f"[recurrent] card: {card}")
    tiny_archs_on_card(dev, RECURRENT_ARCHS, tag="recurrent")
    train_tiny_on_card(dev, RECURRENT_ARCHS, tag="recurrent")
    print(f"[recurrent] tiny archs {time.perf_counter() - t_phase:.1f} s")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kept = None
    for arch in ("rwkv6-1.6b", "recurrentgemma-2b"):
        cfg = configs.get_config(arch)
        t = time.perf_counter()
        params = init_lm(torch.Generator(dev).manual_seed(SEED), cfg,
                         device=dev)
        torch.cuda.synchronize()
        print(f"[recurrent] {cfg.name} full width: {cfg.param_count():,} "
              f"parameters, float32 masters drawn on the card in "
              f"{time.perf_counter() - t:.2f} s, "
              f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
        rwkv = arch == "rwkv6-1.6b"
        tokens, full32 = full_width_float32(
            params, cfg, dev, *RECURRENT_FORWARD[arch], tag="recurrent",
            hold=not rwkv)
        if rwkv:
            rwkv_chunked_against_steps(params, cfg, tokens)
        recurrent_forward_work(params, cfg, tokens)
        serving_copy_on_card(params, cfg, tokens, full32)
        if arch == "recurrentgemma-2b":
            kept = (cfg, [params], tokens, full32)
        del params, tokens, full32
        torch.cuda.empty_cache()
        print(f"[recurrent] {cfg.name} checks done at "
              f"{time.perf_counter() - t_phase:.1f} s")
    cfg, masters, tokens, full32 = kept
    del kept
    return serve_flow(ops, dev, cfg, masters, tokens, full32, t_phase,
                      "recurrent", 9, host_profile, bf16_hold=False)


if __name__ == "__main__":
    sys.exit(main())
