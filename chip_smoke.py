#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's offline analysis path on one NVIDIA GPU.

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
   with skewed tags (90% in 64 bins), weighted.
3. The main path: ``detect_offline`` with the fused backend, whole-log and
   with ``chunk_events=1<<20``, checked against the float64 ``numpy``
   chunked fold (per-worker CMetric, slice counts, critical-set flips, the
   top-ranked path), with every kernel's launch count read around it.
   tag_hist is then timed on the keys the detector handed it (no weights).

The last three lines are the card's name and power limit, one JSON object
with a row per kernel (the other shapes it was timed at under ``shapes``),
and ``{"ok": true, "device": {...}}``.

``--profile`` adds one more run of each main-path mode under ``cProfile``
and ``torch.profiler``: the host functions that take the time, and the
device's busy time and idle share over the run.
``--kernels-only --src DIR`` times the kernels of the ``repro_torch`` under
``DIR`` (another checkout's) at the same shapes, phases 2 and the key
histogram only, to set two versions side by side in one run.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet: HBM3 rate, and float32 rate outside the
# tensor cores.  Both assume the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

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
            nbytes, nops, library_ms, composite_ms, **extra):
        b_ms, b_by = bound_ms(nbytes, nops)
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


def check_fold(rows, dt, deltas, log, e):
    """The fold kernel against its plain version and a float64 prefix."""
    import torch
    from repro_torch.kernels import cmetric_fold as fold_k
    from repro_torch.kernels import ref
    n_k, g_k, tot_k, idle_k, cnt_k = fold_k.fold(dt, deltas)
    n_p, g_p, tot_p, idle_p, cnt_p = ref.fold_ref(dt, deltas)
    torch.cuda.synchronize()
    check(torch.equal(n_k, n_p), "fold: n differs from the plain version")
    c64 = torch.where(n_k > 0, dt.double() / n_k.clamp(min=1).double(),
                      torch.zeros_like(dt, dtype=torch.float64))
    incl64 = torch.cumsum(c64, 0)
    g64 = incl64 - c64
    scale = float(g64.abs().max())
    err_k = float((g_k.double() - g64).abs().max())
    err_p = float((g_p.double() - g64).abs().max())
    diff = float((g_k - g_p).abs().max())
    tol = 1e-5 * scale
    print(f"[kernel] fold gcm vs float64 prefix: kernel {err_k:.3e}, plain "
          f"{err_p:.3e}, bound 1e-5*max|gcm| = {tol:.3e}")
    check(err_k <= max(tol, err_p), "fold: gcm misses the float64 bound")
    check(diff <= tol + err_p, "fold: gcm disagrees with the plain version")
    idle64 = float(torch.where((n_k <= 0) & (dt > 0), dt.double(),
                               torch.zeros_like(c64)).sum())
    check(abs(float(tot_k) - float(incl64[-1])) <= 1e-5 * float(incl64[-1]),
          "fold: total_cm")
    check(abs(float(idle_k) - idle64) <= 1e-5 * max(idle64, 1e-9),
          "fold: idle")
    check(float(cnt_k) == float(cnt_p) == float(log.deltas.sum()),
          "fold: final count")
    contrib = torch.where(n_k > 0, dt / n_k.clamp(min=1).float(),
                          torch.zeros_like(dt))

    def kernel():
        return fold_k.fold(dt, deltas)

    def library():
        return (torch.cumsum(deltas, 0, dtype=torch.int32),
                torch.cumsum(contrib, 0))

    rows.add("fold", "cmetric_fold.fold", FOLD_SRC,
             "src/repro/kernels/cmetric_fold.py:52", f"E={e}", diff,
             time_ms(kernel), time_ms(lambda: ref.fold_ref(dt, deltas)),
             16.0 * e, 4.0 * e, time_ms(library), None,
             graph_ms=graph_ms(kernel), library_graph_ms=graph_ms(library))
    return n_k


def check_carry_cumsum(rows, contrib, idle_c, carry, shape, repeats):
    """carry_cumsum against its plain version and a float64 prefix, timed
    beside ``torch.cumsum`` alone and the like-for-like composite (cumsum,
    carry add, idle sum)."""
    import torch
    from repro_torch.kernels import cmetric_fold as fold_k
    from repro_torch.kernels import ref
    e = contrib.shape[0]
    c_vals = tuple(float(c) for c in carry)
    gk, ek, ik = fold_k.carry_cumsum(contrib, idle_c, carry)
    gp, _, ip = ref.carry_cumsum_ref(contrib, idle_c, c_vals)
    torch.cuda.synchronize()
    g64 = float(np.float32(c_vals[0])) + torch.cumsum(contrib.double(), 0)
    i64 = float(np.float32(c_vals[1])) + float(idle_c.double().sum())
    scale = float(g64.abs().max())
    err_k = float((gk.double() - g64).abs().max())
    err_p = float((gp.double() - g64).abs().max())
    diff = float((gk - gp).abs().max())
    tol = 1e-5 * scale
    print(f"[kernel] carry_cumsum {shape} g vs float64 prefix: kernel "
          f"{err_k:.3e}, plain {err_p:.3e}, bound 1e-5*max|g| = {tol:.3e}")
    check(err_k <= max(tol, err_p), f"carry_cumsum {shape}: g misses the "
          "bound")
    check(diff <= tol + err_p, f"carry_cumsum {shape}: g disagrees with plain")
    check(abs(float(ek) - float(gk[-1])) <= 1e-6 * scale,
          f"carry_cumsum {shape}: gcm_end is not g[-1]")
    check(abs(float(ik) - i64) <= 1e-5 * max(abs(i64), 1e-9),
          f"carry_cumsum {shape}: idle_end vs float64")
    check(abs(float(ik) - float(ip)) <= 1e-5 * max(abs(i64), 1e-9),
          f"carry_cumsum {shape}: idle_end vs plain")
    g0 = torch.as_tensor(c_vals[0], dtype=torch.float32, device=contrib.device)
    i0 = torch.as_tensor(c_vals[1], dtype=torch.float32, device=contrib.device)

    def composite():
        g = g0 + torch.cumsum(contrib, 0)
        return g, g[-1], i0 + torch.sum(idle_c)

    def kernel():
        return fold_k.carry_cumsum(contrib, idle_c, carry)

    rows.add("carry_cumsum", "cmetric_fold.carry_cumsum", FOLD_SRC,
             "src/repro/kernels/cmetric_fold.py:146", shape, diff,
             time_ms(kernel, repeats),
             time_ms(lambda: ref.carry_cumsum_ref(contrib, idle_c, c_vals),
                     repeats),
             12.0 * e, 2.0 * e,
             time_ms(lambda: torch.cumsum(contrib, 0), repeats),
             time_ms(composite, repeats), graph_ms=graph_ms(kernel, repeats),
             library_graph_ms=graph_ms(lambda: torch.cumsum(contrib, 0),
                                       repeats))


def check_hist(rows, tg, wt, k, shape, repeats, key="hist"):
    """tag_hist against its plain version, timed beside
    ``torch.bincount`` (with the weights when there are any) and the
    like-for-like composite: the tag filter, the counts and the weighted
    sums (or the counts as f32)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import tag_hist as hist_k
    s = tg.shape[0]
    ck, wk = hist_k.hist(tg, wt, num_bins=k)
    # where the bins live (a checkout older than ``bins_path`` has one place)
    path = (hist_k.bins_path(k, wt is not None)
            if hasattr(hist_k, "bins_path") else None)
    cp, wp = ref.hist_ref(tg, wt, k)
    torch.cuda.synchronize()
    check(torch.equal(ck, cp), f"tag_hist {shape}: counts differ")
    check(torch.allclose(wk, wp, rtol=1e-4, atol=1e-6),
          f"tag_hist {shape}: weighted sums differ beyond rtol 1e-4")
    if wt is None:
        check(torch.equal(wk, ck.float()), f"tag_hist {shape}: wsum is not "
              "counts as f32")
    err = float((wk - wp).abs().max())
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
    from repro_torch.kernels import tag_hist as hist_k

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
    torch.cuda.empty_cache()

    # -- phase 3: the main path -----------------------------------------------
    # The keys the detector hands tag_hist are recorded on the way, for the
    # histogram's main-path row below.
    recorded = []
    real_hist = hist_k.hist

    def recording_hist(tags_, weights=None, **kw):
        if not recorded:
            recorded.append((tags_.clone(), weights, kw["num_bins"]))
        return real_hist(tags_, weights, **kw)

    hist_k.hist = recording_hist
    if args.kernels_only:
        detect_offline(log, tags, stacks, n_min, samples=samples,
                       backend="fused")
    else:
        t = time.perf_counter()
        ref_rep = detect_offline(log, tags, stacks, n_min, samples=samples,
                                 backend="numpy", chunk_events=1 << 20)
        print(f"[main] numpy chunked oracle: {time.perf_counter() - t:.2f} s")
        launches = main_path(log, tags, stacks, n_min, samples, ref_rep, e,
                             detect_offline, export, ops)
    hist_k.hist = real_hist
    keys, weights, k = recorded[0]
    check(weights is None, "the detector weighed its key histogram")
    check_hist(rows, keys, None, k,
               f"S={keys.shape[0]} K={k} main-path keys, no weights", 200)

    if args.kernels_only:
        print(json.dumps({"kernels": list(rows.rows.values())}))
        return 0
    for key, row in rows.rows.items():
        row["launches"] = launches[key]
    if args.profile:
        for label, chunk in (("whole-log", None), ("chunked", 1 << 20)):
            profile_main_path(label, lambda chunk=chunk: detect_offline(
                log, tags, stacks, n_min, samples=samples, backend="fused",
                chunk_events=chunk))
    print(f"[main] whole script {time.perf_counter() - t_script:.1f} s")

    print(smi)
    print(json.dumps({"kernels": [rows.rows["fold"], rows.rows["carry_cumsum"],
                                  rows.rows["hist"]]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


def main_path(log, tags, stacks, n_min, samples, ref_rep, e, detect_offline,
              export, ops) -> dict:
    """``detect_offline`` fused, whole-log and chunked, each checked against
    the float64 oracle ``ref_rep``; returns each kernel's launches over the
    two runs, counted from 0 just before each run and read just after."""
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
        attached = sum(sum(p.tag_counts.values()) for p in rep.paths)
        print(f"[main] fused {label}: {secs:.3f} s, {e / secs:.4g} events/s, "
              f"{rep.total_slices} slices, {rep.total_critical} critical, "
              f"{attached} samples attached in the top paths, "
              f"launches {launches}")
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
        print(f"[main] fused {label} vs float64 oracle: per-worker max rel "
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
        print(f"[main] fused {label} top path: {rep.path_str(rep.paths[0])} "
              f"{rep.paths[0].cmetric:.6f} s CMetric "
              f"(oracle {ref_rep.paths[0].cmetric:.6f} s)")
    whole, chunked = runs["whole-log"], runs["chunked"]
    check(whole["fold"] >= 1 and whole["hist"] >= 1,
          f"whole-log run launched {whole}")
    check(chunked["carry_cumsum"] >= 1 and chunked["hist"] >= 1,
          f"chunked run launched {chunked}")
    return {key: whole[key] + chunked[key] for key in whole}


if __name__ == "__main__":
    sys.exit(main())
