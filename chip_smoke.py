#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's analysis, live, serving, training, recurrent-model, multi-rank, dry-run and model-family paths on one NVIDIA GPU.

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
   chain bound; decode_attn at the decode cells' shape against a float64
   oracle of its arithmetic and its plain version, timed beside
   ``scaled_dot_product_attention`` over the masked cache (``library``)
   and the masked whole-cache path it replaced (``composite``).
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

10. Multi-rank: the port's ``launch``, ``sharding``, ``decode_sharded``
   and ``gpipe`` over worlds of ranks started with ``run_ranks`` (one
   process a rank): NCCL at one rank, gloo at 2 and 4 ranks sharing the
   card (NCCL refuses two ranks on one device).  (a) Tiny, card against
   CPU at rtol/atol 1e-4: flash-decode at the reference test's shapes
   (B 3, L 64, H 8, KV 2, hd 16, valid lengths 10/40/63) and the
   reference's gpipe test (tanh layers 16 wide, 6 microbatches, as many
   stages as ranks) at each world size (the one-rank NCCL world against a
   one-rank gloo world on the CPU), and tiny deepseek-7b's sharded train
   step in float32 on a (1, 1) NCCL mesh.  (b) Flash-decode at
   deepseek-7b's decode width (32 heads, KV 32, hd 128, B 8) over the
   decode_32k cache of 32,768 slots, each rank holding L/W of it: float32
   held against the dense single-rank attention over the whole cache at
   rtol/atol 1e-4; bf16 timed (ms a call, the local attention, the three
   all-reduces) against the cache's byte bound.  (c) deepseek-7b's 30
   layers at full width as 2 gpipe stages of 15 in bf16, one gloo rank a
   stage sharing the card, 8 microbatches of 1 x 1,024 tokens; each rank
   under a ``ProfileSession`` (its stage worker tracing ``stage_step`` and
   ``bubble_compute``, folding with the card's fused kernels) streaming
   to an ``IngestServer`` in this process, whose fused session reports
   over the ``FleetSource``.  Held: the output bit for bit against the 30
   layers applied in order, a worker per stage, every kernel call of this
   process and of each rank (the ranks send theirs back).  Printed: ms for the run, each stage's
   busy time, the shift's route and ms, the CMetric share of
   ``bubble_compute`` beside the analytic 1/9.  (d) ``python -m
   repro_torch.launch.train``'s ``main`` on tiny deepseek-7b for 4 steps
   on the card.

11. Dry-run: ``repro_torch.launch.dryrun`` on fake ranks whose tensors
   model CUDA ones (shapes, no storage).  (a) gemma3-1b ``train_4k``,
   deepseek-7b ``decode_32k`` and ``prefill_32k``, grok-1-314b
   ``decode_32k`` and arctic-480b ``train_4k`` at full width on the
   16x16 mesh of a fake world of 256 ranks, and gemma3-1b ``train_4k`` on
   the 2x16x16 mesh of 512, through ``run_cell``: each ``ok``, its JSON
   keys the reference's, its per-chip argument bytes the sum of its
   leaves' shards by the physical and ZeRO-1 specs; its roofline row and
   trace seconds printed; the multi-pod cell's FLOPs a chip exactly half
   the single cell's, its peak and bytes a chip no higher; grok's
   collective bytes a chip below a tenth, and deepseek-7b
   ``prefill_32k``'s peak below a quarter, of the step that gathered the
   experts and the heads whole onto every rank; gemma3-1b ``train_4k``'s
   peak below 1/1.3 of the step that gathered the logits' vocab for the
   loss, and deepseek-7b ``decode_32k``'s collective bytes below a
   twentieth of the step that gathered decode's scores.  (b) Phase 8's step
   (gemma3-1b, B = 4, S = 1,024, bf16, remat) traced on a fake world of
   one rank, then run on the card: the traced FLOPs equal to
   ``FlopCounterMode`` on the real step and the argument bytes to the
   real tensors', exactly; printed, the traced peak over
   ``torch.cuda.max_memory_allocated()`` and the measured step against
   the roofline's ``t_bound`` (the H100 data sheet's rates).

12. Families: the archs' paths no other phase runs on the card.  (a)
   Tiny qwen1.5-4b (QKV bias), seamless-m4t-large-v2 (encoder, cross
   attention, decode over ``cross_memory``), internvl2-2b (the patch
   prefix, and the decode that skips it) and arctic-480b (MoE beside a
   dense residual) in float32, card against CPU at rtol/atol 1e-4: the
   forward, 8 teacher-forced decode steps, and three ``make_train_step``
   steps (the losses, and the parameters and moments after the third).
   (b) seamless-m4t-large-v2, internvl2-2b, recurrentgemma-2b (B 4, S
   1,024 each; the ``Trainer`` gives seamless 512 frames of 80 and
   internvl2 256 patches of 1,024) and rwkv6-1.6b (B 1, S 256) at their
   published widths: float32 masters drawn on the card from the seed, the
   float32 forward against 8 teacher-forced decode steps at rtol/atol
   1e-3 (rwkv6's printed, each layer's chunked time mix held against its
   steps, as in phase 9), then the ``train_lm`` flow's ``Trainer`` for 4
   steps in bf16 over float32 masters, remat on, under a fused GAPP
   session on the card.  Held: every loss and grad norm finite, the last
   loss below the first, ``trainer`` and ``data_loader`` workers in the
   report, a ``carry_cumsum`` and a ``tag_hist`` launch in each run.
   Printed: ms a step (median), tokens/s, the step's FLOPs
   (``FlopCounterMode``) against 989 TFLOP/s bf16, peak device memory.

Each path of phases 3-12 runs with every kernel's launch count set to 0
just before it and read just after, and must launch the kernels it goes
through.  Every kernel call such a path makes is recorded (its inputs and
outputs, cloned on the card) and held against the kernel's plain version
on the same inputs after the run, at the tolerances of phase 2: so the
kernels are also checked at the shapes the live and fleet paths hand them
(drain chunks of tens of events, a few hundred keys).  A decode_attn call
is held on the card as it returns (against the float64 oracle, its atol
1e-5 of the largest |v|, and the plain version), and only its errors are
kept; two launches a call must add up to the path's count.

The last three lines are the card's name and power limit, one JSON object
with a row per kernel (the other shapes it was timed at under ``shapes``;
``launches`` summed over the paths of phases 3-12, ``phase10_launches``
over phase 10's, ``phase11_launches`` over phase 11's,
``phase12_launches`` over phase 12's), and ``{"ok": true, "device":
{...}}``.

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
ATTN_SRC = "src/repro_torch/kernels/csrc/decode_attn.cu"


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


def attn_oracle(q, k, v, pos, window, softcap):
    """decode_attn's arithmetic in float64, eight slots at a time: q scaled
    in its dtype, the softmax over each slot's written interval, float64
    weights against v."""
    import torch
    from repro_torch.kernels import decode_attn as attn_k
    b, _, h, hd = q.shape
    kv = k.shape[2]
    lo, hi, flat = attn_k.written_interval(pos, k.shape[1], window)
    rows = torch.arange(k.shape[1], device=q.device)
    outs = []
    for i in range(0, b, 8):
        sl = slice(i, i + 8)
        n = q[sl].shape[0]
        qs = (q[sl] * (hd ** -0.5)).double().reshape(n, kv, h // kv, hd)
        s = torch.einsum("bkgd,bskd->bkgs", qs, k[sl].double())
        if softcap > 0:
            s = torch.tanh(s / softcap) * softcap
        s = torch.where(flat[sl, None, None, None], 0.0, s)
        keep = (rows >= lo[sl, None]) & (rows <= hi[sl, None])
        s = s.masked_fill(~keep[:, None, None, :], -math.inf)
        outs.append(torch.einsum("bkgs,bskd->bkgd", torch.softmax(s, -1),
                                 v[sl].double()).reshape(n, 1, h, hd))
    return torch.cat(outs)


def decode_attn_errors(a, out, atol):
    """A decode_attn call's output ``out`` (its arguments ``a`` by name)
    against the float64 oracle and against the plain version, on the card
    and with no host sync: float32 [max |out - oracle|, its largest share
    of the oracle's tolerance, max |out - plain|, its largest share of the
    plain version's].  Against the oracle: rtol 2^-8 in bfloat16 (the
    output's one rounding), 1e-5 in float32, and ``atol`` (the float32
    sums); against the plain version, which rounds the weights to the
    dtype before the product with v: rtol 2^-7 and 2^-9 of the largest
    |v|.  A share above 1, or NaN, fails.  ``atol`` may be a tensor on the
    card."""
    import torch
    from repro_torch.kernels import decode_attn as attn_k
    q, k, v, pos = a["q"], a["k"], a["v"], a["pos"]
    window, softcap = a["window"], a["softcap"]
    got = out.double()
    want = attn_oracle(q, k, v, pos, window, softcap)
    plain = attn_k.decode_attn_ref(q, k, v, pos, window, softcap).double()
    vmax = v.abs().max().double()
    rtol = 2.0 ** -8 if q.dtype == torch.bfloat16 else 1e-5
    e_o = (got - want).abs()
    e_p = (got - plain).abs()
    share_o = e_o / (atol + rtol * want.abs()).clamp(min=1e-30)
    share_p = e_p / (2.0 ** -9 * vmax + 2.0 ** -7 * plain.abs()).clamp(
        min=1e-30)
    return torch.stack([e_o.max(), share_o.max(), e_p.max(),
                        share_p.max()]).float()


def check_decode_attn(rows, dev) -> None:
    """decode_attn at the decode cells' shape (gappbench's
    ``ds7b8-decode-c4k-*``: 96 slots, a 4,096-row cache, 32 MHA heads of
    128, bfloat16), each slot's pos drawn from the cells' request starts
    (256-3,072), held by :func:`decode_attn_errors` at the CUDA tests'
    tolerance (the oracle's atol 1e-5), timed beside the plain version,
    ``scaled_dot_product_attention`` over the same validity mask
    (``library``) and the masked attention over the whole cache it
    replaced (``_sdpa_math``, ``composite``); the bound counts each slot's
    written K and V rows once, and ``whole_cache_bound_ms`` the whole
    cache."""
    import types

    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attn as attn_k
    from repro_torch.models import attention as attn_lib
    b, length, kv, h, hd = 96, 4096, 32, 32, 128
    gen = torch.Generator(dev).manual_seed(SEED)
    q = torch.randn((b, 1, h, hd), generator=gen, device=dev).bfloat16()
    k = torch.randn((b, length, kv, hd), generator=gen,
                    device=dev).bfloat16()
    v = torch.randn((b, length, kv, hd), generator=gen,
                    device=dev).bfloat16()
    pos = torch.from_numpy(np.random.default_rng(SEED + 2).integers(
        256, 3073, b).astype(np.int32)).to(dev)
    got = attn_k.decode_attn(q, k, v, pos)
    e_o, share_o, e_p, share_p = decode_attn_errors(
        {"q": q, "k": k, "v": v, "pos": pos, "window": None, "softcap": 0.0},
        got, 1e-5).tolist()
    check(share_o <= 1.0 and share_p <= 1.0,
          f"decode_attn: max |kernel - oracle| {e_o:.3e} ({share_o:.3f} of "
          f"its tolerance), max |kernel - plain| {e_p:.3e} ({share_p:.3f})")
    slots = torch.arange(length, device=dev)[None, :]
    mask = (slots <= pos[:, None].long())[:, None, None, None, :]
    cfg = types.SimpleNamespace(opt_level=0, logits_softcap=0.0)
    # the library's attention in (B, heads, rows, hd): views, no copies
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt,
                                              attn_mask=mask[:, 0])
    lib_err = float((library().transpose(1, 2).double()
                     - attn_oracle(q, k, v, pos, None, 0.0)).abs().max())
    row_bytes = 2 * kv * hd * k.element_size()
    rows_read = int((pos.long() + 1).sum())
    rows.add("decode_attn", "decode_attn.decode_attn", ATTN_SRC, "none",
             f"B={b} L={length} KV={kv} H={h} hd={hd} bf16, "
             f"{rows_read} written rows", e_p,
             time_ms(lambda: attn_k.decode_attn(q, k, v, pos)),
             time_ms(lambda: attn_k.decode_attn_ref(q, k, v, pos), 3),
             rows_read * row_bytes + 2 * q.numel() * q.element_size(),
             4.0 * rows_read * h * hd, time_ms(library, 3),
             time_ms(lambda: attn_lib._sdpa_math(q, k, v, mask, cfg), 3),
             graph_ms=graph_ms(lambda: attn_k.decode_attn(q, k, v, pos)),
             whole_cache_bound_ms=bound_ms(b * length * row_bytes, 0)[0],
             oracle_max_abs_err=e_o, library_max_abs_err=lib_err)
    del q, k, v, got, mask, qt, kt, vt


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
            "stream": ("stream_scan", "stream_scan"),
            "decode_attn": ("decode_attn", "decode_attn")}
#: Launches a wrapper call counts, where it is not one.
LAUNCHES_PER_CALL = {"decode_attn": 2}


def _on_card(x) -> bool:
    return x.is_cuda


def _clone(x):
    import torch
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, (tuple, list)):
        return type(x)(_clone(v) for v in x)
    return x


def _moved(x, dev):
    """``x`` (tensors in dicts, tuples and lists) with every tensor on
    ``dev``: a rank's recorded calls travel to the parent on the host."""
    import torch
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, dict):
        return {k: _moved(v, dev) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_moved(v, dev) for v in x)
    return x


@contextlib.contextmanager
def recording():
    """Keep every call a path makes to a kernel wrapper with tensors on the
    card: its arguments by name and its outputs, cloned on the card right
    after the call.  :func:`hold_recorded` then holds the path's own
    launches against the plain versions, so the checks launch nothing that
    the path's counts would see.  A decode_attn call is held on the card
    right after it instead (:func:`decode_attn_errors`, which launches no
    kernel of the port), and only its errors kept: a clone of every
    step's cache would not fit.  Its oracle's atol is 1e-5 of the largest
    |v| (at least 1e-5), since the float32 sums err with v's scale."""
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
                a = dict(bound.arguments)
                if _key == "decode_attn":
                    rec = decode_attn_errors(a, out, 1e-5 * a["v"].abs()
                                             .max().double().clamp(min=1.0))
                else:
                    rec = (_clone(a), _clone(out))
                with lock:
                    calls[_key].append(rec)
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
    import torch
    out = []
    for key, held in calls.items():
        per_call = LAUNCHES_PER_CALL.get(key, 1)
        check(per_call * len(held) == launches.get(key, 0), f"{label}: "
              f"{len(held)} {key} calls recorded ({per_call} launches a "
              f"call), {launches.get(key, 0)} launched")
        if key == "decode_attn":
            if held:
                e = torch.stack([x.cpu() for x in held]).double()
                e_o, share_o, e_p, share_p = e.max(0).values.tolist()
                check(bool((e[:, 1] <= 1.0).all() and (e[:, 3] <= 1.0).all()),
                      f"{label}: a decode_attn call: max |kernel - oracle| "
                      f"{e_o:.3e} ({share_o:.3f} of its tolerance), max "
                      f"|kernel - plain| {e_p:.3e} ({share_p:.3f})")
                out.append(f"decode_attn {len(held)} calls (max |kernel - "
                           f"oracle| {e_o:.3e}, {share_o:.3f} of its "
                           f"tolerance; max |kernel - plain| {e_p:.3e}, "
                           f"{share_p:.3f})")
            continue
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
    if importlib.util.find_spec("repro_torch.kernels.decode_attn"):
        check_decode_attn(rows, dev)
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
    t = time.perf_counter()
    multirank_tiny_and_flash(dev, smi)
    phase10 = {"multirank pipeline": pipeline_path(ops, dev, smi),
               "launch.train": launch_train_path(ops)}
    runs.update(phase10)
    print(f"[multirank] phase 10 {time.perf_counter() - t:.1f} s")
    runs["dryrun"] = dryrun_path(ops, dev, smi)
    runs["families"] = families_path(ops, dev, smi)
    for key, row in rows.rows.items():
        row["launches"] = sum(r[key] for r in runs.values())
        row["phase10_launches"] = sum(r[key] for r in phase10.values())
        row["phase11_launches"] = runs["dryrun"][key]
        row["phase12_launches"] = runs["families"][key]
    if args.profile:
        for label, chunk in (("whole-log", None), ("chunked", 1 << 20)):
            profile_main_path(label, lambda chunk=chunk: detect_offline(
                log, tags, stacks, n_min, samples=samples, backend="fused",
                chunk_events=chunk))
    print(f"[main] whole script {time.perf_counter() - t_script:.1f} s")

    print(smi)
    print(json.dumps({"kernels": [rows.rows[k] for k in (
        "fold", "carry_cumsum", "hist", "stream")] + [
            rows.rows[k] for k in ("decode_attn",) if k in rows.rows]}))
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


def forward_and_decode(params, cfg, tokens, frontend=None):
    """Forward logits over ``tokens`` (B, T) and the logits of T
    teacher-forced decode steps from a zeroed cache of T slots, stacked to
    (B, T, V), both on the host.  ``frontend`` is the frontend stub's
    input (:func:`frontend_input`): an encoder-decoder's frames, whose
    encoder output the decode steps attend to (``cross_memory``), or a
    VLM's patches, which only the forward sees (its decode skips the
    prefix, as the reference's does)."""
    import torch
    from repro_torch.models import (cross_memory, decode_step, forward,
                                    init_decode_state)
    b, t_len = tokens.shape
    dev = tokens.device
    batch, memory = {"tokens": tokens}, None
    if frontend is not None:
        batch["frontend"] = frontend
        if cfg.enc_layers:
            memory = cross_memory(params, cfg, frontend)
    full, _ = forward(params, batch, cfg)
    state = init_decode_state(cfg, b, t_len, device=dev)
    steps = []
    for t in range(t_len):
        lg, state = decode_step(params, tokens[:, t], torch.full(
            (b,), t, dtype=torch.int32, device=dev), state, cfg,
            memory=memory)
        steps.append(lg)
    return full.cpu(), torch.stack(steps, 1).cpu()


def frontend_input(cfg, b: int, rng, frames: int = 12, prefix=None):
    """The frontend stub's input for ``cfg``, drawn from ``rng``:
    ``frames`` audio frames for an encoder-decoder, ``prefix`` patches
    (the config's ``num_prefix`` when None) for a VLM, None for the
    others."""
    import torch
    if not cfg.frontend_dim:
        return None
    n = frames if cfg.enc_layers else (
        cfg.num_prefix if prefix is None else prefix)
    return torch.from_numpy(rng.standard_normal(
        (b, n, cfg.frontend_dim)).astype(np.float32))


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
        rng = np.random.default_rng(SEED)
        tokens = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (2, 8)).astype(np.int32))
        front = frontend_input(cfg, 2, rng)
        on_cpu = forward_and_decode(cpu_p, cfg, tokens, front)
        on_card = forward_and_decode(
            dev_p, cfg, tokens.to(dev),
            None if front is None else front.to(dev))
        diffs = [_max_diff(a, b) for a, b in zip(on_card, on_cpu)]
        print(f"[{tag}] tiny {arch} float32, card against CPU: forward max "
              f"|diff| {diffs[0]:.3e}, decode {diffs[1]:.3e} (rtol/atol "
              f"1e-4)")
        for what, a, b in zip(("forward", "decode"), on_card, on_cpu):
            check(torch.allclose(a, b, rtol=1e-4, atol=1e-4),
                  f"tiny {arch}: {what} on the card off the CPU's")


def full_width_float32(params, cfg, dev, batch=2, t_len=8,
                       tag="serve", hold=True, frontend=None) -> None:
    """A model at full width, computing in float32 on the masters
    themselves: ``batch`` sequences of ``t_len`` tokens from the seed,
    teacher-forced ``decode_step`` at every position against ``forward``,
    held at rtol/atol 1e-3 (the same float32 products, grouped by cuBLAS
    differently for the step's rows and the sequence's; a recurrent
    block's scan or chunked form against its step form; logits are
    ~N(0, 1)).  ``hold`` False prints the gap by position instead (see
    :func:`rwkv_chunked_against_steps`).  ``frontend`` goes to
    :func:`forward_and_decode`."""
    import torch
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    tokens = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (batch, t_len)).astype(np.int32)).to(dev)
    t = time.perf_counter()
    full, dec = forward_and_decode(
        params, cfg32, tokens,
        None if frontend is None else frontend.to(dev))
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
        rng = np.random.default_rng(SEED + i)
        batch = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (4, 16)).astype(np.int32))}
        front = frontend_input(cfg, 4, rng, frames=8)   # the Trainer's S/2
        if front is not None:
            batch["frontend"] = front
        p, s, m, _ = step(p, s, {k: v.to(dev) for k, v in batch.items()},
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


# -- phase 10: the multi-rank layer ------------------------------------------

#: the reference test's flash-decode shapes (tests/test_flash_decode.py)
MR_B, MR_L, MR_H, MR_KV, MR_HD, MR_LENGTHS = 3, 64, 8, 2, 16, (10, 40, 63)
#: deepseek-7b's decode attention over the decode_32k cache
FD_B, FD_L, FD_H, FD_KV, FD_HD = 8, 32768, 32, 32, 128
#: valid lengths of the full-width rows: whole, partial, one shard, and a
#: row whose later shards are fully masked at 2 and 4 ranks
FD_LENGTHS = (32767, 30000, 20000, 16383, 9000, 8191, 5000, 100)
FD_BLOCK = 1024                 # cache positions drawn per generator seed
FD_CALLS = 10                   # timed calls, after two warm-up calls
PP_STAGES, PP_MICRO, PP_TOKENS = 2, 8, 1024


def mr_tiny_inputs() -> dict:
    """Phase 10 (a)'s inputs, numpy from the seed: flash-decode's q, k, v
    and valid at the reference test's shapes, and the reference's gpipe
    test (4 tanh layers 16 wide, 6 microbatches of 8)."""
    rng = np.random.default_rng(SEED + 10)
    f32 = np.float32
    return {
        "q": rng.standard_normal((MR_B, 1, MR_H, MR_HD)).astype(f32),
        "k": rng.standard_normal((MR_B, MR_L, MR_KV, MR_HD)).astype(f32),
        "v": rng.standard_normal((MR_B, MR_L, MR_KV, MR_HD)).astype(f32),
        "valid": np.arange(MR_L)[None, :] <= np.asarray(MR_LENGTHS)[:, None],
        "w": (rng.standard_normal((4, 16, 16)) * 0.5).astype(f32),
        "x": rng.standard_normal((6, 8, 16)).astype(f32)}


def _tanh_stage(p, a):
    import torch
    return torch.tanh(a @ p["w"])


def mr_tiny(inputs: dict, dev: str) -> dict:
    """flash_decode over the world as the ``model`` axis (each rank builds
    its own slice of k, v and valid) and gpipe over it as the ``stage``
    axis (as many stages as ranks, the first of the 4 layers; each rank
    holds its own), with every tensor on ``dev``; numpy outputs."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.common import ModelConfig
    from repro_torch.pipeline import gpipe
    from repro_torch.serve.decode_sharded import make_flash_decode
    w, r = dist.get_world_size(), dist.get_rank()
    x = {k: torch.from_numpy(v).to(dev) for k, v in inputs.items()}
    mesh = make_mesh((w,), ("model",), device=dev)
    n = MR_L // w

    def local(t):
        return DTensor.from_local(t[:, r * n:(r + 1) * n].contiguous(), mesh,
                                  [Shard(1)], run_check=False)
    f = make_flash_decode(mesh, ModelConfig(num_heads=MR_H,
                                            num_kv_heads=MR_KV,
                                            head_dim=MR_HD))
    fd = f(x["q"], local(x["k"]), local(x["v"]), local(x["valid"]))
    smesh = make_mesh((w,), ("stage",), device=dev)
    stacked = {"w": DTensor.from_local(x["w"][r:r + 1].contiguous(), smesh,
                                       [Shard(0)], run_check=False)}
    gp = gpipe(_tanh_stage, smesh, n_stages=w, n_micro=6)(stacked, x["x"])
    return {"flash_decode": fd.to_local().cpu().numpy(),
            "gpipe": gp.to_local().cpu().numpy()}


def mr_sharded_step(dev: str) -> list:
    """Two train steps of tiny deepseek-7b in float32 on a (1, 1) mesh of
    this one-rank world: parameters ``distribute_tensor``'d by
    ``param_shardings``, the batch ``Shard(0)`` over ``data``, under
    ``use_mesh`` with the train rules; the two losses."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch import configs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.rules import rules_for
    from repro_torch.models import init_lm
    from repro_torch.optim import adamw
    from repro_torch.sharding import api as shapi
    from repro_torch.sharding import params as shparams
    from repro_torch.train.step import make_train_step
    cfg = dataclasses.replace(configs.get_tiny("deepseek-7b"),
                              compute_dtype=torch.float32)
    mesh = make_mesh((1, 1), ("data", "model"), device=dev)
    rules = rules_for("deepseek-7b", "train")
    # drawn on the CPU, then placed on the mesh's device
    params = shparams.distribute_params(
        init_lm(torch.Generator().manual_seed(SEED), cfg, device="cpu"),
        mesh, rules)
    tokens = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (8, 16)).astype(np.int32)).to(dev)
    batch = {"tokens": DTensor.from_local(tokens, mesh, [Replicate()] * 2,
                                          run_check=False)
             .redistribute(mesh, [Shard(0), Replicate()])}
    step = make_train_step(cfg, adamw.AdamWConfig(lr=1e-3))
    opt = adamw.init(params)
    losses, err = [], None
    with shapi.use_mesh(mesh, rules):
        for _ in range(2):
            params, opt, metrics, err = step(params, opt, batch, err)
            losses.append(float(metrics["loss"].full_tensor()))
    return losses


def fd_cache(lo: int, hi: int, dev):
    """Positions [lo, hi) of the full-width float32 cache (k, v), drawn
    in blocks of ``FD_BLOCK`` positions, each from its own seed, so that a
    rank's slice equals that part of the whole."""
    import torch
    ks, vs = [], []
    for j in range(lo // FD_BLOCK, hi // FD_BLOCK):
        g = torch.Generator(dev).manual_seed(SEED * 7919 + j)
        shape = (FD_B, FD_BLOCK, FD_KV, FD_HD)
        ks.append(torch.randn(shape, generator=g, device=dev))
        vs.append(torch.randn(shape, generator=g, device=dev))
    return torch.cat(ks, dim=1), torch.cat(vs, dim=1)


def fd_query(dev):
    """The full-width float32 query and the (B, L) validity mask."""
    import torch
    g = torch.Generator(dev).manual_seed(SEED * 7919 - 1)
    q = torch.randn((FD_B, 1, FD_H, FD_HD), generator=g, device=dev)
    valid = torch.arange(FD_L, device=dev)[None, :] <= torch.tensor(
        FD_LENGTHS, device=dev)[:, None]
    return q, valid


def fd_dense(dev) -> np.ndarray:
    """Dense single-rank float32 attention of :func:`fd_query`'s query
    over the whole :func:`fd_cache` (8.59 GB)."""
    import torch
    q, valid = fd_query(dev)
    k, v = fd_cache(0, FD_L, dev)
    qg = q.reshape(FD_B, FD_KV, FD_H // FD_KV, FD_HD) * FD_HD ** -0.5
    s = torch.einsum("bkgh,bskh->bkgs", qg, k)
    s = torch.where(valid[:, None, None, :], s, -torch.inf)
    out = torch.einsum("bkgs,bskh->bkgh", torch.softmax(s, dim=-1), v)
    return out.reshape(FD_B, 1, FD_H, FD_HD).cpu().numpy()


class _TimedAllReduce:
    """Stands in for the flash-decode combine's all-reduce
    (``models.attention._all_reduce``): each is timed on the host between
    two synchronisations."""

    def __init__(self, all_reduce):
        self.all_reduce, self.seconds = all_reduce, 0.0

    def __call__(self, t, op, group):
        import torch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.all_reduce(t, op, group)
        torch.cuda.synchronize()
        self.seconds += time.perf_counter() - t0
        return out


def mr_full() -> dict:
    """Phase 10 (b) on this rank: flash-decode at deepseek-7b's decode
    width over this rank's L/W slice of the 32,768-slot cache, in float32
    (the output, for the dense check) and in bf16 (timed: a call, then the
    same calls with each all-reduce timed alone)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import attention
    from repro_torch.models.common import ModelConfig
    from repro_torch.serve import decode_sharded
    w, r = dist.get_world_size(), dist.get_rank()
    torch.cuda.reset_peak_memory_stats()
    n = FD_L // w
    q, valid = fd_query("cuda")
    k, v = fd_cache(r * n, (r + 1) * n, "cuda")
    mesh = make_mesh((w,), ("model",), device="cuda")
    f = decode_sharded.make_flash_decode(mesh, ModelConfig(
        num_heads=FD_H, num_kv_heads=FD_KV, head_dim=FD_HD))

    def local(t):
        return DTensor.from_local(t, mesh, [Shard(1)], run_check=False)
    dvalid = local(valid[:, r * n:(r + 1) * n].contiguous())
    out32 = f(q, local(k), local(v), dvalid).to_local().cpu().numpy()
    kb, vb, qb = local(k.bfloat16()), local(v.bfloat16()), q.bfloat16()
    del k, v

    def timed() -> float:
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(FD_CALLS):
            f(qb, kb, vb, dvalid)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / FD_CALLS * 1e3
    for _ in range(2):
        f(qb, kb, vb, dvalid)
    ms = timed()
    shim = _TimedAllReduce(attention._all_reduce)
    attention._all_reduce = shim
    try:
        split_ms = timed()
    finally:
        attention._all_reduce = shim.all_reduce
    allreduce_ms = shim.seconds / FD_CALLS * 1e3
    return {"out32": out32, "ms": ms, "split_ms": split_ms,
            "allreduce_ms": allreduce_ms,
            "local_ms": split_ms - allreduce_ms,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def rank_multirank(inputs: dict, full: bool) -> dict:
    """One rank of a phase-10 world: (a) on the card, and on the CPU too
    where the backend carries CPU tensors (gloo), the tiny sharded step
    on the card in the one-rank NCCL world; (b) when ``full``."""
    import torch
    import torch.distributed as dist
    torch.set_num_threads(2)
    check(not torch.backends.cuda.matmul.allow_tf32,
          "float32 matmuls would run in TF32")
    backend = dist.get_backend()
    out = {"backend": backend, "card": mr_tiny(inputs, "cuda")}
    if backend == "gloo":
        out["cpu"] = mr_tiny(inputs, "cpu")
    if backend == "nccl":
        out["step"] = mr_sharded_step("cuda")
    if full:
        out["full"] = mr_full()
    return out


def rank_cpu_reference(inputs: dict) -> dict:
    """The one-rank gloo world on the CPU: (a)'s calls, which the one-rank
    NCCL world on the card is held against."""
    import torch
    torch.set_num_threads(4)
    return {"cpu": mr_tiny(inputs, "cpu"), "step": mr_sharded_step("cpu")}


def multirank_tiny_and_flash(dev, card: str) -> None:
    """Phase 10 (a) and (b): worlds of 1 (NCCL), 2 and 4 (gloo, the ranks
    sharing the card) ranks; each rank's card results held against the
    same calls on the CPU, and the full-width float32 flash-decode against
    the dense attention over the whole cache, at rtol/atol 1e-4."""
    import torch
    from repro_torch.launch.mesh import run_ranks
    t_phase = time.perf_counter()
    inputs = mr_tiny_inputs()
    dense = fd_dense(dev)
    torch.cuda.empty_cache()
    t = time.perf_counter()
    cpu1 = run_ranks(rank_cpu_reference, 1, backend="gloo", args=(inputs,),
                     timeout=300)[0]
    print(f"[multirank] CPU reference world (1 rank, gloo): "
          f"{time.perf_counter() - t:.1f} s")
    kv_bytes = 2 * FD_B * FD_L * FD_KV * FD_HD * 2
    bound = kv_bytes / HBM_BYTES_PER_S * 1e3
    for w, backend in ((1, "nccl"), (2, "gloo"), (4, "gloo")):
        t = time.perf_counter()
        ranks = run_ranks(rank_multirank, w, backend=backend,
                          args=(inputs, True), timeout=600)
        secs = time.perf_counter() - t
        for i, res in enumerate(ranks):
            check(res["backend"] == backend, f"world {w}: rank {i} on "
                  f"{res['backend']}, not {backend}")
            ref = cpu1["cpu"] if backend == "nccl" else res["cpu"]
            for what in ("flash_decode", "gpipe"):
                diff = float(np.max(np.abs(res["card"][what] - ref[what])))
                check(np.allclose(res["card"][what], ref[what], rtol=1e-4,
                                  atol=1e-4), f"world {w} rank {i}: {what} "
                      f"on the card off the CPU's by {diff:.3e}")
                if i == 0:
                    print(f"[multirank] (a) world {w} ({backend}): {what} "
                          f"card against CPU max |diff| {diff:.3e} "
                          f"(rtol/atol 1e-4)")
            full = res["full"]
            diff = float(np.max(np.abs(full["out32"] - dense)))
            check(np.allclose(full["out32"], dense, rtol=1e-4, atol=1e-4),
                  f"world {w} rank {i}: full-width flash-decode off the "
                  f"dense attention by {diff:.3e}")
            check(np.array_equal(full["out32"], ranks[0]["full"]["out32"]),
                  f"world {w}: rank {i}'s output differs from rank 0's")
        if backend == "nccl":
            step, ref = ranks[0]["step"], cpu1["step"]
            check(np.allclose(step, ref, rtol=1e-4, atol=1e-4)
                  and step[1] < step[0], f"sharded step on the card "
                  f"{step}, on the CPU {ref}")
            print(f"[multirank] (a) tiny deepseek-7b sharded train step on "
                  f"a (1, 1) NCCL mesh, float32: losses {step} on the card, "
                  f"{ref} on the CPU (rtol/atol 1e-4)")
        fulls = [r["full"] for r in ranks]
        print(f"[multirank] (b) flash-decode B={FD_B} H={FD_H} KV={FD_KV} "
              f"hd={FD_HD} L={FD_L}, world {w} ({backend}, "
              f"{FD_L // w} slots a rank): float32 against the dense "
              f"attention max |diff| {diff:.3e} (rtol/atol 1e-4); bf16 "
              f"{max(x['ms'] for x in fulls):.4f} ms a call (slowest "
              f"rank), local attention "
              f"{max(x['local_ms'] for x in fulls):.4f} ms, the three "
              f"all-reduces {max(x['allreduce_ms'] for x in fulls):.4f} ms;"
              f" the cache's byte bound {kv_bytes / 1e9:.3f} GB at "
              f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s = {bound:.4f} ms "
              f"({100 * bound / max(x['ms'] for x in fulls):.1f}% of "
              f"bound); peak device memory a rank "
              f"{max(x['peak_gb'] for x in fulls):.2f} GB; world "
              f"{secs:.1f} s")
    print(f"[multirank] (a)+(b) {time.perf_counter() - t_phase:.1f} s; "
          f"card {card}")


def pp_cfg():
    """deepseek-7b at its published width, bf16 parameters and compute."""
    import torch
    from repro_torch import configs
    return dataclasses.replace(configs.get_config("deepseek-7b"),
                               compute_dtype=torch.bfloat16,
                               param_dtype=torch.bfloat16)


def pp_layer(cfg, layer: int, dev):
    """Layer ``layer``'s parameters, drawn on ``dev`` from its own seed."""
    import torch
    from repro_torch.models import blocks
    return blocks.init_block(torch.Generator(dev).manual_seed(
        SEED * 31 + layer), cfg, "dense", device=dev)


def pp_input(cfg, dev):
    import torch
    g = torch.Generator(dev).manual_seed(SEED + 5)
    return torch.randn((PP_MICRO, 1, PP_TOKENS, cfg.d_model), generator=g,
                       device=dev).to(torch.bfloat16)


def pp_apply(layers, a, cfg):
    """``layers`` (block parameter dicts) applied to ``a`` in order."""
    import torch
    from repro_torch.models import blocks
    positions = torch.arange(a.shape[1], device=a.device)[None].expand(
        a.shape[0], a.shape[1])
    for p in layers:
        a, _ = blocks.apply_block(p, a, positions, cfg, "dense")
    return a


def rank_pipeline(addr) -> dict:
    """Phase 10 (c) on this rank: stage ``rank`` of deepseek-7b's 30
    layers through ``gpipe`` on the card, once to warm up, then under a
    ``ProfileSession`` whose stage worker traces active steps as
    ``stage_step`` and masked ones as ``bubble_compute`` and streams to
    the parent's ``IngestServer``.  The session folds on the card with the
    default fused backend, as ``examples/fleet_profile.py``'s remote
    sessions do; its kernel calls are counted from 0 and recorded, and
    go back to the parent (on the host) to be held there."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard
    from repro_torch.core import ProfileSession
    from repro_torch.fleet import attach_remote
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.common import tree_map
    # the module (the package's ``gpipe`` is the function)
    gpipe_mod = importlib.import_module("repro_torch.pipeline.gpipe")
    r = dist.get_rank()
    torch.cuda.reset_peak_memory_stats()
    cfg = pp_cfg()
    per = cfg.num_layers // PP_STAGES
    mesh = make_mesh((PP_STAGES,), ("stage",), device="cuda")
    layers = [pp_layer(cfg, layer, "cuda")
              for layer in range(r * per, (r + 1) * per)]
    # each leaf gains the stacked stage dimension, of which this rank
    # holds its own row
    stacked = tree_map(lambda t: DTensor.from_local(
        t.unsqueeze(0), mesh, [Shard(0)], run_check=False), layers)
    x = pp_input(cfg, "cuda")
    warm = gpipe_mod.gpipe(lambda p, a: pp_apply(p, a, cfg), mesh,
                           PP_STAGES, PP_MICRO)(stacked, x).to_local()

    steps, busy, shifts = [], [0.0], [0.0, 0]
    real_shift = gpipe_mod._shift

    def stage_fn(p, a):
        t = len(steps)
        tag = "stage_step" if 0 <= t - r < PP_MICRO else "bubble_compute"
        steps.append(tag)
        t0 = time.perf_counter()
        sess.begin(wid, tag)
        out = pp_apply(p, a, cfg)
        torch.cuda.synchronize()
        sess.end(wid)
        busy[0] += time.perf_counter() - t0
        return out

    def shift(*a):
        t0 = time.perf_counter()
        out = real_shift(*a)
        torch.cuda.synchronize()
        shifts[0] += time.perf_counter() - t0
        shifts[1] += 1
        return out

    fn = gpipe_mod.gpipe(stage_fn, mesh, PP_STAGES, PP_MICRO)
    ops.reset_launch_counts()
    with recording() as calls:
        # the fleet's n_min: a session interns a slice's call path only
        # where it finds the slice critical itself
        sess = ProfileSession(n_min=PP_STAGES + 1.0, dt=0.002,
                              device="cuda")
        wid = sess.register_worker(f"stage{r}", "stage")
        sink = attach_remote(sess, addr, host_id=f"rank{r}",
                             clock_offset_ns=0)
        gpipe_mod._shift = shift
        try:
            with sess.running():
                dist.barrier()
                t0 = time.perf_counter()
                y = fn(stacked, x).to_local()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            gpipe_mod._shift = real_shift
        sess.result()
        sink.close()
    return {"y": y.cpu() if r == 0 else None,
            "calls": _moved(calls, "cpu"), "launches": ops.launch_counts(),
            "session": (sess.device.type, sess.fold_backend),
            "warm_equal": bool(torch.equal(y, warm)), "wall_ms": wall * 1e3,
            "busy_ms": busy[0] * 1e3, "shift_ms": shifts[0] * 1e3,
            "shifts": shifts[1], "steps": steps,
            "route": gpipe_mod.shift_route(mesh.get_group("stage"),
                                           y.device),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def pipeline_path(ops, dev, card: str) -> dict:
    """Phase 10 (c): the full-width 2-stage pipeline, one gloo rank a
    stage sharing the card, under a fused GAPP fleet session in this
    process over an ``IngestServer`` the ranks' sessions stream to; then a
    fused session over the ingest's journal with samples every 1 ms for
    the report's (path, tag) tables.  Held: the output against the 30
    layers applied in order to each microbatch on the card (bit for bit),
    a worker per stage, every kernel call against its plain version, this
    process's and each rank's.  Returns the run's kernel launches, the
    ranks' included."""
    import torch
    from repro_torch.core import ProfileSession
    from repro_torch.fleet import FleetSource, IngestServer
    from repro_torch.launch.mesh import run_ranks
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    # more workers than stages may be critical: every slice is, so the
    # paths' CMetric splits the whole run by tag
    n_min = PP_STAGES + 1.0
    with recording() as calls, \
            tempfile.TemporaryDirectory(prefix="gapp-smoke-pp-") as d:
        fleet_dir = os.path.join(d, "fleet")
        server = IngestServer(device=dev, fleet_dir=fleet_dir)
        server.start()
        try:
            fleet = ProfileSession(server.source, n_min=n_min)
            fleet.start()
            ranks = run_ranks(rank_pipeline, PP_STAGES, backend="gloo",
                              args=(server.address,), timeout=600)
            check(server.wait_idle(60), f"ingest not idle: "
                  f"{server.stats()}")
            live = fleet.result()
        finally:
            server.close()
        # the fleet's stream again from its journal, sampled every 1 ms
        # (remote sessions ship no samples): the report's (path, tag)
        # tables
        rep = ProfileSession(FleetSource.from_fleet_dir(fleet_dir, device=dev),
                             n_min=n_min, sample_dt_ns=1_000_000).result()
    launches = ops.launch_counts()
    hold_recorded("multirank pipeline", calls, launches)
    check(fleet.device.type == "cuda" and fleet.fold_backend == "fused",
          f"pipeline fleet session on {fleet.device} / "
          f"{fleet.fold_backend}")
    check(launches["carry_cumsum"] >= 1 and launches["hist"] >= 1,
          f"pipeline launched {launches}")
    for i, res in enumerate(ranks):
        check(res["session"] == ("cuda", "fused"), f"stage {i}'s session "
              f"on {res['session']}")
        hold_recorded(f"multirank pipeline rank {i}",
                      _moved(res["calls"], dev), res["launches"])
        check(res["launches"]["carry_cumsum"] >= 1, f"stage {i}'s session "
              f"launched {res['launches']}")
    rank_launches = [r["launches"] for r in ranks]
    launches = {k: v + sum(r[k] for r in rank_launches)
                for k, v in launches.items()}
    names = sorted(rep.worker_names)
    for r in (live, rep):
        check(sorted(r.worker_names) == ["rank0/stage0", "rank1/stage1"]
              and sorted(r.hosts) == ["rank0", "rank1"]
              and r.total_slices == live.total_slices,
              f"pipeline report: workers {r.worker_names}, hosts "
              f"{r.hosts}, {r.total_slices} slices")
    cm = {}
    for p in rep.paths:
        cm[rep.path_str(p)] = cm.get(rep.path_str(p), 0.0) + p.cmetric
    bubble = cm.get("bubble_compute", 0.0) / max(
        cm.get("bubble_compute", 0.0) + cm.get("stage_step", 0.0), 1e-30)
    for i, res in enumerate(ranks):
        check(res["warm_equal"], f"stage {i}: the profiled run differs "
              f"from the warm-up")
        want = ["bubble_compute"] * i + ["stage_step"] * PP_MICRO + \
            ["bubble_compute"] * (PP_STAGES - 1 - i)
        check(res["steps"] == want, f"stage {i} traced {res['steps']}")

    # the 30 layers in order on each microbatch, in this process
    cfg = pp_cfg()
    layers = [pp_layer(cfg, layer, dev) for layer in range(cfg.num_layers)]
    x = pp_input(cfg, dev)
    y = ranks[0]["y"].to(dev)
    with torch.no_grad():
        seq = torch.stack([pp_apply(layers, x[m], cfg)
                           for m in range(PP_MICRO)])
    diff = float((seq.float() - y.float()).abs().max())
    check(torch.equal(seq, y), f"pipeline output off the sequential "
          f"layers by {diff:.3e}")
    del layers, x, y, seq
    torch.cuda.empty_cache()
    r0 = ranks[0]
    busy = ", ".join(f"{r['busy_ms']:.1f}" for r in ranks)
    shift = ", ".join(f"{r['shift_ms']:.1f}" for r in ranks)
    print(f"[multirank] (c) deepseek-7b 30 layers as {PP_STAGES} stages of "
          f"{cfg.num_layers // PP_STAGES}, bf16, {PP_MICRO} microbatches "
          f"of 1 x {PP_TOKENS} tokens, one gloo rank a stage sharing the "
          f"card: {max(r['wall_ms'] for r in ranks):.1f} ms for the run; "
          f"stage busy {busy} ms; shift route {r0['route']}, {shift} ms "
          f"over "
          f"{r0['shifts']} shifts a stage; output bit-equal to the "
          f"sequential layers; peak device memory a rank "
          f"{max(r['peak_gb'] for r in ranks):.2f} GB")
    print(f"[multirank] (c) GAPP fleet report: workers {names}, hosts "
          f"{rep.hosts}, {rep.total_slices} slices; CMetric by tag "
          f"{ {k: round(v, 6) for k, v in cm.items()} } s; bubble_compute "
          f"share of the CMetric {bubble:.4f} against the analytic "
          f"(n_stages-1)/(n_micro+n_stages-1) = "
          f"{(PP_STAGES - 1) / (PP_MICRO + PP_STAGES - 1):.4f}; launches "
          f"{launches} (the ranks' sessions {rank_launches}); "
          f"{time.perf_counter() - t_phase:.1f} s; card {card}")
    return launches


def launch_train_path(ops) -> dict:
    """Phase 10 (d): ``python -m repro_torch.launch.train``'s ``main`` on
    tiny deepseek-7b for 4 steps on the card (its checkpoints in a
    temporary directory); the GAPP profile printed, every kernel call
    held.  Returns the run's kernel launches."""
    import io
    from repro_torch.launch import train as launch_train
    ops.reset_launch_counts()
    t = time.perf_counter()
    out = io.StringIO()
    with recording() as calls, \
            tempfile.TemporaryDirectory(prefix="gapp-smoke-launch-") as d:
        saved, tempfile.tempdir = tempfile.tempdir, d
        try:
            with contextlib.redirect_stdout(out):
                rc = launch_train.main(["--arch", "deepseek-7b", "--steps",
                                        "4"])
        finally:
            tempfile.tempdir = saved
    launches = ops.launch_counts()
    hold_recorded("launch.train", calls, launches)
    text = out.getvalue()
    check(rc == 0 and "GAPP bottleneck profile" in text
          and "train/step" in text, f"launch.train: rc {rc}, {text[-500:]}")
    check(launches["carry_cumsum"] >= 1 and launches["hist"] >= 1,
          f"launch.train launched {launches}")
    top = [ln for ln in text.splitlines() if ln.startswith("#1")]
    print(f"[multirank] (d) launch.train --arch deepseek-7b --steps 4 on "
          f"the card: {time.perf_counter() - t:.1f} s, profile top "
          f"{top[0].strip() if top else '?'}, launches {launches}")
    return launches


# The reference's dry-run JSON schema (src/repro/launch/dryrun.py's
# CellResult, its memory_analysis fields and Roofline.to_dict), copied:
# this script imports nothing of the JAX package.
CELL_KEYS = ["arch", "shape", "mesh", "ok", "seconds", "error", "memory",
             "roofline"]
MEMORY_KEYS = ["argument_size", "output_size", "temp_size",
               "generated_code_size", "per_chip_total"]
ROOFLINE_KEYS = ["arch", "shape", "mesh", "flops_per_chip", "bytes_per_chip",
                 "coll_bytes_per_chip", "coll_breakdown", "t_compute",
                 "t_memory", "t_collective", "model_flops", "peak_mem_bytes",
                 "n_chips", "bottleneck", "useful_ratio", "roofline_fraction",
                 "t_bound"]
DRYRUN_CELLS = (("gemma3-1b", "train_4k", "single"),
                ("deepseek-7b", "decode_32k", "single"),
                ("gemma3-1b", "train_4k", "multi"),
                ("grok-1-314b", "decode_32k", "single"),
                ("arctic-480b", "train_4k", "single"),
                ("deepseek-7b", "prefill_32k", "single"))
# the sharded step's placements against what the step cost when it
# gathered onto every rank (torch 2.11's trace of those cells): attention
# over heads and the experts at their rule placements (grok's collective
# bytes a chip below a tenth, deepseek's prefill peak below a quarter),
# the loss vocab-parallel (gemma3-1b's train peak below 1/1.3) and
# decode's flash-decode combine (deepseek's decode collective bytes below
# a twentieth)
DRYRUN_GATHERED = {
    ("grok-1-314b", "decode_32k"): ("coll_bytes_per_chip", 6.191e11, 10,
                                    "gathered heads and experts whole"),
    ("deepseek-7b", "prefill_32k"): ("peak_mem_bytes", 646.70 * 2**30, 4,
                                     "gathered heads and experts whole"),
    ("gemma3-1b", "train_4k"): ("peak_mem_bytes", 197.71 * 2**30, 1.3,
                                "gathered the logits' vocab"),
    ("deepseek-7b", "decode_32k"): ("coll_bytes_per_chip", 9.601e8, 20,
                                    "gathered decode's scores")}
# the production meshes' axis sizes (launch.mesh.make_production_mesh)
MESH_SIZES = {"single": {"data": 16, "model": 16},
              "multi": {"pod": 2, "data": 16, "model": 16}}


def shard_bytes(struct, spec, sizes: dict) -> int:
    """One rank's bytes of a leaf placed by ``spec`` on a mesh of axis
    ``sizes``: its elements over the product of the axes that shard it."""
    count = 1
    for entry in spec:
        for a in (() if entry is None else entry if isinstance(entry, tuple)
                  else (entry,)):
            count *= sizes[a]
    return struct.numel() * struct.element_size() // count


def expected_argument_bytes(arch: str, shape_name: str, sizes: dict) -> int:
    """A cell's per-chip argument bytes on a mesh of axis ``sizes``,
    summed over its leaves' shards from the specs alone (the tracer not
    involved): the physical specs of the parameters, and ZeRO-1's of both
    moments plus the int32 step (train), the batch (train and prefill),
    or the decode state's, tokens' and positions' (decode)."""
    import torch
    from repro_torch import configs
    from repro_torch.launch import dryrun, specs
    from repro_torch.models.common import tree_leaves
    from repro_torch.sharding import params as shparams
    cfg, shape = configs.get_config(arch), configs.SHAPES[shape_name]
    rules = dryrun.rules_for(arch, shape.kind)
    p_struct = dryrun._param_structs(cfg)
    p_specs = shparams.physical_specs(p_struct, sizes, rules)

    def total(structs, shardings) -> int:
        return sum(shard_bytes(s, sp, sizes) for s, sp in zip(
            tree_leaves(structs), _spec_leaves(shardings)))
    n = total(p_struct, p_specs)
    if shape.kind == "train":
        o_specs = dryrun.zero1(p_specs, p_struct, sizes, rules)
        f32 = [torch.empty(s.shape, dtype=torch.float32, device="meta")
               for s in tree_leaves(p_struct)]
        n += 2 * total(f32, o_specs) + 4          # mu, nu, the step
    if shape.kind in ("train", "prefill"):
        b = specs.train_like_specs(cfg, shape)
        n += total(list(b.values()), list(specs.train_like_shardings(
            cfg, b, sizes, rules).values()))
    else:
        tok, pos, state, memory = specs.decode_state_specs(cfg, shape)
        tok_sh, pos_sh, st_sh, _ = specs.decode_shardings(cfg, shape, sizes,
                                                          rules)
        check(memory is None, f"{arch} decodes with an encoder memory")
        n += total([tok, pos], [tok_sh, pos_sh]) + total(state, st_sh)
    return n


def _spec_leaves(tree) -> list:
    """The PartitionSpecs of a tree of dicts and lists, in leaf order (a
    PartitionSpec is a tuple, and a leaf here)."""
    from repro_torch.sharding.api import PartitionSpec
    if isinstance(tree, PartitionSpec):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _spec_leaves(v)]
    return [x for v in tree for x in _spec_leaves(v)]


def dryrun_path(ops, dev, card: str) -> dict:
    """Phase 11: the dry-run on fake ranks modelling CUDA tensors.  (a)
    Five full-width cells on the 16x16 mesh of a fake world of 256 ranks
    and gemma3-1b ``train_4k`` on the 2x16x16 mesh of 512, through
    ``dryrun.run_cell``: each ``ok``, its row and trace seconds printed,
    its JSON keys the reference's, its per-chip argument bytes the sum of
    its leaves' shards; the multi-pod cell's FLOPs a chip exactly half the
    single cell's (its 256 sequences over 32 ranks, not 16) and its peak
    and bytes a chip no higher; grok-1-314b ``decode_32k``'s collective
    bytes and deepseek-7b ``prefill_32k``'s peak a chip below a tenth and
    a quarter of the step that gathered the experts and the heads whole,
    gemma3-1b ``train_4k``'s peak below 1/1.3 of the step that gathered
    the logits' vocab and deepseek-7b ``decode_32k``'s collective bytes
    below a twentieth of the step that gathered decode's scores
    (``DRYRUN_GATHERED``), arctic-480b ``train_4k`` traced.  (b) Phase
    8's step (gemma3-1b at full width, B = 4, S = 1,024, bf16, remat)
    traced on a fake world of one rank, then run on the card: the traced
    FLOPs equal to ``FlopCounterMode`` on the real step and the argument
    bytes to the real tensors', exactly; the traced peak against
    ``torch.cuda.max_memory_allocated()`` and the measured step against
    the roofline's ``t_bound`` printed.  Every number printed is this
    card's (``card``: its name and power limit); the roofline's seconds
    are the H100 data sheet's rates, modelled.  Returns the phase's kernel
    launches (none: the dry-run runs no kernel of the port)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch import configs
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import roofline
    from repro_torch.models import init_lm
    from repro_torch.models.common import tree_leaves
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_step
    t_phase = time.perf_counter()
    ops.reset_launch_counts()
    fields = {f.name for f in dataclasses.fields(roofline.Roofline)}
    rows = {}
    for arch, shape_name, mesh_name in DRYRUN_CELLS:
        # as ``python -m repro_torch.launch.dryrun`` traces the cell
        method = "extrapolate" if mesh_name == "single" \
            and arch in dryrun.EXTRAPOLATED else "direct"
        r = dryrun.run_cell(arch, shape_name, mesh_name, method=method,
                            device=dev)
        check(r.ok, f"dry-run {arch} {shape_name} {mesh_name}: {r.error}")
        rows[arch, shape_name, mesh_name] = r
        row = dataclasses.asdict(r)
        check(list(row) == CELL_KEYS and list(r.memory) == MEMORY_KEYS
              and list(r.roofline) == ROOFLINE_KEYS,
              f"dry-run {arch} {shape_name} keys {list(row)}, "
              f"{list(r.memory)}, {list(r.roofline)}")
        sizes = MESH_SIZES[mesh_name]
        want = expected_argument_bytes(arch, shape_name, sizes)
        check(r.memory["argument_size"] == want,
              f"dry-run {arch} {shape_name} {mesh_name}: argument bytes "
              f"{r.memory['argument_size']} != {want} from the specs")
        rf = roofline.Roofline(**{k: v for k, v in r.roofline.items()
                                  if k in fields})
        for line in roofline.render_table([rf]).splitlines():
            print(f"[dryrun] {line}")
        print(f"[dryrun] {arch} {shape_name} {mesh_name} "
              f"({'x'.join(map(str, sizes.values()))} fake ranks, "
              f"cuda): traced in {r.seconds:.1f} s; argument "
              f"{r.memory['argument_size']:,} B, temp "
              f"{r.memory['temp_size']:,} B, per chip "
              f"{r.memory['per_chip_total'] / 2**30:.2f} GiB; t_bound "
              f"{rf.t_bound * 1e3:.3f} ms ({rf.bottleneck}); collectives "
              f"{ {k: f'{v:.4g}' for k, v in rf.coll_breakdown.items()} }")
    for (arch, shape_name), (key, gathered, factor, what) in \
            DRYRUN_GATHERED.items():
        got = rows[arch, shape_name, "single"].roofline[key]
        check(got * factor < gathered,
              f"dry-run {arch} {shape_name}: {key} {got:.6e} is not below "
              f"1/{factor} of the gathered step's {gathered:.6e}")
        print(f"[dryrun] {arch} {shape_name}: {key} {got:.6e}, "
              f"{gathered / got:.2f}x below the step that {what} "
              f"({gathered:.6e}) ({card})")
    one, pod = (rows["gemma3-1b", "train_4k", m].roofline
                for m in ("single", "multi"))
    check(pod["flops_per_chip"] * 2 == one["flops_per_chip"],
          f"dry-run gemma3-1b train_4k: multi FLOPs a chip "
          f"{pod['flops_per_chip']:.6e} are not half the single cell's "
          f"{one['flops_per_chip']:.6e}")
    for key in ("peak_mem_bytes", "bytes_per_chip"):
        check(pod[key] <= one[key],
              f"dry-run gemma3-1b train_4k: multi {key} {pod[key]:.6e} > "
              f"single {one[key]:.6e}")
    print(f"[dryrun] gemma3-1b train_4k multi over single: FLOPs a chip "
          f"{pod['flops_per_chip'] / one['flops_per_chip']:.4f}, bytes "
          f"{pod['bytes_per_chip'] / one['bytes_per_chip']:.4f}, peak "
          f"{pod['peak_mem_bytes'] / one['peak_mem_bytes']:.4f}, "
          f"collective bytes "
          f"{pod['coll_bytes_per_chip'] / one['coll_bytes_per_chip']:.4f}")

    # (b) the cost model against the card
    cfg = configs.get_config(TRAIN_ARCH)
    shape = ShapeSpec(f"train_{TRAIN_SEQ}", TRAIN_SEQ, TRAIN_BATCH, "train")
    t = time.perf_counter()
    with mesh_lib.fake_world(1):
        mesh = mesh_lib.make_mesh((1, 1), ("data", "model"), device=dev)
        trace, memory, rf = dryrun.lower_cell(
            TRAIN_ARCH, shape.name, "single", cfg=cfg, shape=shape,
            mesh=mesh, device=dev, return_artifacts=True)
    t_trace = time.perf_counter() - t
    torch.cuda.empty_cache()
    params = init_lm(torch.Generator(dev).manual_seed(SEED), cfg, device=dev)
    opt = adamw.init(params)
    batch = {"tokens": torch.randint(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ), dtype=torch.int32,
        device=dev, generator=torch.Generator(dev).manual_seed(SEED + 1))}
    args = tree_leaves(params) + tree_leaves(opt) + list(batch.values())
    arg_bytes = sum(x.nbytes for x in args)
    step = make_train_step(cfg, adamw.AdamWConfig())
    counter = FlopCounterMode(display=False)
    with counter:
        out = step(params, opt, batch, None)
    torch.cuda.synchronize()
    real_flops = counter.get_total_flops()
    del out
    check(trace.flops == real_flops,
          f"traced FLOPs {trace.flops:.6e} != FlopCounterMode on the real "
          f"step {real_flops:.6e}")
    check(trace.argument_bytes == arg_bytes,
          f"traced argument bytes {trace.argument_bytes:,} != the real "
          f"tensors' {arg_bytes:,}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    times = []
    for _ in range(4):
        t = time.perf_counter()
        out = step(params, opt, batch, None)
        float(out[2]["loss"])
        times.append(time.perf_counter() - t)
        del out
    peak = torch.cuda.max_memory_allocated()
    ms = float(np.median(times)) * 1e3
    print(f"[dryrun] (b) {cfg.name} B = {TRAIN_BATCH}, S = {TRAIN_SEQ}, "
          f"bf16, remat {cfg.remat}, one fake rank traced in {t_trace:.1f} s "
          f"({trace.ops:,} local ops): FLOPs {trace.flops:.6e} == "
          f"FlopCounterMode on the card's step; argument bytes "
          f"{arg_bytes:,} == the real tensors'; bytes {trace.bytes:.6e}")
    print(f"[dryrun] (b) on {card}: traced peak {rf.peak_mem_bytes:,.0f} B "
          f"/ max_memory_allocated {peak:,} B (arguments {base:,} B "
          f"allocated before the steps) = {rf.peak_mem_bytes / peak:.4f}")
    print(f"[dryrun] (b) on {card}: step {ms:.3f} ms (median of "
          f"{[round(x * 1e3, 3) for x in times]}) against t_bound "
          f"{rf.t_bound * 1e3:.3f} ms ({rf.bottleneck}; t_compute "
          f"{rf.t_compute * 1e3:.3f}, t_memory {rf.t_memory * 1e3:.3f}): "
          f"measured roofline fraction {rf.t_bound * 1e3 / ms:.4f}")
    del params, opt, batch, args
    torch.cuda.empty_cache()
    launches = ops.launch_counts()
    print(f"[dryrun] phase 11 {time.perf_counter() - t_phase:.1f} s, "
          f"launches {launches}")
    return launches


# -- phase 12: the families no other phase runs on the card ------------------

#: QKV bias; encoder, cross attention and ``cross_memory``; the patch
#: prefix and the decode that skips it; MoE beside a dense residual
FAMILY_TINY_ARCHS = ("qwen1.5-4b", "seamless-m4t-large-v2", "internvl2-2b",
                     "arctic-480b")
#: (B, S) of the full-width ``Trainer`` runs; rwkv6-1.6b at two chunks
#: (its forward alone makes ~11,400 launches)
FAMILY_TRAIN = {"seamless-m4t-large-v2": (4, 1024),
                "internvl2-2b": (4, 1024),
                "recurrentgemma-2b": (4, 1024),
                "rwkv6-1.6b": (1, 256)}
FAMILY_STEPS = 4


def family_check(params, cfg, dev) -> None:
    """The full-width float32 forward against 8 teacher-forced decode
    steps (:func:`full_width_float32`), at 1e-3: seamless-m4t decodes over
    the ``cross_memory`` of 12 frames; internvl2's decode, which skips the
    patch prefix, against the forward of the same text with an empty
    prefix; rwkv6's gap printed by position, and each layer's chunked time
    mix held against its steps instead, as phase 9 does."""
    rng = np.random.default_rng(SEED + 2)
    front = frontend_input(cfg, 2, rng, prefix=0)
    rwkv = "rwkv" in cfg.block_pattern
    tokens, _ = full_width_float32(params, cfg, dev, tag="families",
                                   hold=not rwkv, frontend=front)
    if rwkv:
        rwkv_chunked_against_steps(params, cfg, tokens, tag="families")


def step_flops(cfg, step_fn, params, opt, b: int, s: int, dev) -> int:
    """FLOPs of one training step as it runs (``FlopCounterMode``: the
    products with the weights and the attention products, remat's
    recompute included) on ``params`` and ``opt`` (updated in place) and
    a ``SyntheticLM`` batch of the ``Trainer``'s shapes."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.data.pipeline import SyntheticLM
    front = None
    if cfg.enc_layers:
        front = (s // 2, cfg.frontend_dim)
    elif cfg.frontend_dim:
        front = (cfg.num_prefix, cfg.frontend_dim)
    batch = SyntheticLM(cfg.vocab_size, s, b, SEED,
                        frontend_shape=front).next_batch()
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    counter = FlopCounterMode(display=False)
    with counter:
        out = step_fn(params, opt, batch, None)
    float(out[2]["loss"])
    return counter.get_total_flops()


def family_train(ops, dev, arch: str, card: str) -> dict:
    """One arch at its published width: float32 masters drawn on the card
    from the seed and :func:`family_check`; then the ``train_lm`` flow's
    ``Trainer`` for ``FAMILY_STEPS`` steps in bf16 over float32 masters
    (drawn again from the seed), remat as the config sets it, under a
    fused GAPP session on the card, every kernel call held.  Held: every
    loss and grad norm finite, the last loss below the first, a
    ``trainer`` and a ``data_loader`` worker in the report, a
    ``carry_cumsum`` and a ``tag_hist`` launch.  Printed beside ``card``:
    ms a step, tokens/s, the step's FLOPs against 989 TFLOP/s bf16, peak
    device memory.  Returns the run's kernel launches."""
    import torch
    from repro_torch import configs
    from repro_torch.examples.train_lm import train_phase
    from repro_torch.models import init_lm
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_step
    from repro_torch.train.trainer import TrainerConfig
    t_arch = time.perf_counter()
    cfg = configs.get_config(arch)
    b, s = FAMILY_TRAIN[arch]
    params = init_lm(torch.Generator(dev).manual_seed(SEED), cfg, device=dev)
    torch.cuda.synchronize()
    print(f"[families] {cfg.name} full width: {cfg.param_count():,} "
          f"parameters ({cfg.num_layers} layers"
          f"{f', {cfg.enc_layers} encoder layers' if cfg.enc_layers else ''}"
          f", d_model {cfg.d_model}, vocab {cfg.vocab_size:,}), float32 "
          f"masters drawn on the card, {torch.cuda.memory_allocated() / 1e9:.2f}"
          f" GB")
    family_check(params, cfg, dev)
    del params
    torch.cuda.empty_cache()

    # the train_lm example's schedule: 4 steps of its 20-step warmup
    opt_cfg = adamw.AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=300)
    step_fn = make_train_step(cfg, opt_cfg)
    tcfg = TrainerConfig(steps=FAMILY_STEPS, batch_per_host=b, seq_len=s,
                         ckpt_every=0, log_every=10**6, seed=SEED)
    times = []
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with recording() as calls:
        tr, params, opt = train_phase(cfg, opt_cfg, tcfg,
                                      timed_step(step_fn, times), dev)
        rep = tr.profile_report()
        torch.cuda.synchronize()
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    hold_recorded(f"families {arch}", calls, launches)
    flops = step_flops(cfg, step_fn, params, opt, b, s, dev)
    bound = flops / BF16_OPS_PER_S * 1e3
    del calls, params, opt
    losses = [h["loss"] for h in tr.history]
    norms = [h["grad_norm"] for h in tr.history]
    front = (f", {s // 2} frames of {cfg.frontend_dim}" if cfg.enc_layers
             else f", {cfg.num_prefix} patches of {cfg.frontend_dim}"
             if cfg.frontend_dim else "")
    print(f"[families] {cfg.name} Trainer, B = {b}, S = {s}{front}, bf16, "
          f"remat {cfg.remat}: losses {', '.join(f'{x:.4f}' for x in losses)}"
          f"; grad norms {', '.join(f'{x:.3f}' for x in norms)}; workers "
          f"{rep.worker_names}; launches {launches}")
    check(all(math.isfinite(x) for x in losses + norms),
          f"families {arch}: a loss or grad norm is not finite")
    check(losses[-1] < losses[0], f"families {arch}: loss did not drop: "
          f"{losses}")
    check({"trainer", "data_loader"} <= set(rep.worker_names),
          f"families {arch}: workers {rep.worker_names}")
    check(launches["carry_cumsum"] >= 1 and launches["hist"] >= 1,
          f"families {arch} launched {launches}")
    med = 1e3 * float(np.median(times))
    print(f"[families] {cfg.name} on {card}: {med:.3f} ms a step (median "
          f"of {len(times)}; {', '.join(f'{x * 1e3:.1f}' for x in times)}),"
          f" {b * s / med * 1e3:.1f} tokens/s; {flops / 1e12:.3f} TFLOP a "
          f"step (FlopCounterMode, remat's recompute included), compute "
          f"bound {bound:.3f} ms at {BF16_OPS_PER_S / 1e12:.0f} TFLOP/s "
          f"bf16 = {100 * bound / med:.2f}% of the step; peak device memory "
          f"{peak / 1e9:.2f} GB; {time.perf_counter() - t_arch:.1f} s")
    del tr, rep
    torch.cuda.empty_cache()
    return launches


def families_path(ops, dev, card: str) -> dict:
    """Phase 12: the families no other phase runs on the card.  Tiny
    qwen1.5-4b, seamless-m4t-large-v2, internvl2-2b and arctic-480b card
    against CPU (forward, 8 decode steps, 3 train steps; float32, 1e-4);
    then seamless-m4t-large-v2, internvl2-2b, recurrentgemma-2b and
    rwkv6-1.6b at their published widths (:func:`family_train`).  Returns
    the phase's kernel launches, summed over the four runs."""
    import torch
    t_phase = time.perf_counter()
    print(f"[families] card: {card}")
    tiny_archs_on_card(dev, FAMILY_TINY_ARCHS, tag="families")
    train_tiny_on_card(dev, FAMILY_TINY_ARCHS, tag="families")
    print(f"[families] tiny archs {time.perf_counter() - t_phase:.1f} s")
    torch.cuda.empty_cache()
    total: dict = {}
    for arch in FAMILY_TRAIN:
        for key, n in family_train(ops, dev, arch, card).items():
            total[key] = total.get(key, 0) + n
    print(f"[families] phase 12 {time.perf_counter() - t_phase:.1f} s, "
          f"launches {total}")
    return total


if __name__ == "__main__":
    sys.exit(main())
