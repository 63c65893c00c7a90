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
2. Each CUDA kernel against its plain PyTorch version, on the card, at the
   main path's sizes (E = S = 2^24), with CUDA-event times beside the
   kernel's byte bound, the plain version's time and, where one PyTorch
   call computes the same function, that call's time.
3. The main path: ``detect_offline`` with the fused backend, whole-log and
   with ``chunk_events=1<<20``, checked against the float64 ``numpy``
   chunked fold (per-worker CMetric, slice counts, critical-set flips, the
   top-ranked path), with every kernel's launch count read around it.

The last three lines are the card's name and power limit, one JSON object
with a row per kernel, and ``{"ok": true, "device": {...}}``.

``--profile`` adds one more run of each main-path mode under ``cProfile``
and ``torch.profiler``: the host functions that take the time, and the
device's busy time and idle share over the run.
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
sys.path.insert(0, os.path.join(ROOT, "src"))

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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile one run of each main-path mode")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch import convert
    from repro_torch.core import detect_offline, export
    from repro_torch.kernels import build, ops, ref
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
          f"CUDA {torch.version.cuda}")

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

    def time_ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(REPEATS):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / REPEATS

    def bound_ms(nbytes: float, nops: float) -> tuple[float, str]:
        tb, to = nbytes / HBM_BYTES_PER_S, nops / FP32_OPS_PER_S
        return (max(tb, to) * 1e3, "bytes" if tb >= to else "operations")

    rows = {}

    def report(key, name, source, replaces, err, ms, plain_ms, nbytes, nops,
               library_ms, shape):
        b_ms, b_by = bound_ms(nbytes, nops)
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": 0, "max_abs_err": err,
               "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
               "bound_by": b_by, "library_ms": library_ms}
        print(f"[kernel] {name} {shape}: {ms:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by}, {100 * b_ms / ms:.1f}% of bound), plain "
              f"{plain_ms:.4f} ms, library "
              f"{'-' if library_ms is None else f'{library_ms:.4f} ms'}, "
              f"max_abs_err {err:.3e}")
        if key is not None:
            rows[key] = row

    # -- phase 2: kernels against their plain versions -----------------------
    t32 = torch.from_numpy(log.slice_seconds().astype(np.float32)).to(dev)
    dt = torch.empty_like(t32)
    dt[:-1] = t32[1:] - t32[:-1]
    dt[-1] = 0.0
    deltas = torch.from_numpy(log.deltas.astype(np.int32)).to(dev)

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
    report("fold", "cmetric_fold.fold",
           "src/repro_torch/kernels/csrc/cmetric_fold.cu",
           "src/repro/kernels/cmetric_fold.py:52", diff,
           time_ms(lambda: fold_k.fold(dt, deltas)),
           time_ms(lambda: ref.fold_ref(dt, deltas)),
           16.0 * e, 4.0 * e, None, f"E={e}")

    # the chunked fold's inputs: per-event contributions (host side in the
    # pipeline, float64, then cast) and a nonzero carry
    nb = (n_k - deltas).double()
    dt_prev = torch.cat([dt.new_zeros(1), dt[:-1]]).double()
    contrib = torch.where(nb > 0, dt_prev / nb.clamp(min=1),
                          torch.zeros_like(nb)).float()
    idle_c = torch.where(nb > 0, torch.zeros_like(nb), dt_prev).float()
    carry = (0.125, 0.0625)
    gk, _, ik = fold_k.carry_cumsum(contrib, idle_c, carry)
    gp, _, ip = ref.carry_cumsum_ref(contrib, idle_c, carry)
    torch.cuda.synchronize()
    g64 = float(np.float32(carry[0])) + torch.cumsum(contrib.double(), 0)
    i64 = float(np.float32(carry[1])) + float(idle_c.double().sum())
    scale = float(g64.abs().max())
    err_k = float((gk.double() - g64).abs().max())
    err_p = float((gp.double() - g64).abs().max())
    diff = float((gk - gp).abs().max())
    tol = 1e-5 * scale
    print(f"[kernel] carry_cumsum g vs float64 prefix: kernel {err_k:.3e}, "
          f"plain {err_p:.3e}, bound 1e-5*max|g| = {tol:.3e}")
    check(err_k <= max(tol, err_p), "carry_cumsum: g misses the bound")
    check(diff <= tol + err_p, "carry_cumsum: g disagrees with plain")
    check(abs(float(ik) - i64) <= 1e-5 * max(abs(i64), 1e-9),
          "carry_cumsum: idle_end vs float64")
    check(abs(float(ik) - float(ip)) <= 1e-5 * max(abs(i64), 1e-9),
          "carry_cumsum: idle_end vs plain")
    report("carry_cumsum", "cmetric_fold.carry_cumsum",
           "src/repro_torch/kernels/csrc/cmetric_fold.cu",
           "src/repro/kernels/cmetric_fold.py:146", diff,
           time_ms(lambda: fold_k.carry_cumsum(contrib, idle_c, carry)),
           time_ms(lambda: ref.carry_cumsum_ref(contrib, idle_c, carry)),
           12.0 * e, 2.0 * e, time_ms(lambda: torch.cumsum(contrib, 0)),
           f"E={e}")
    del nb, dt_prev, contrib, idle_c, gk, gp, g64, c64, incl64

    rng = np.random.default_rng(SEED + 1)
    s = 1 << 24
    for k in (3300, 1 << 20):
        tg = torch.from_numpy(rng.integers(-8, k + 8, s).astype(np.int32))
        wt = torch.from_numpy(rng.random(s, dtype=np.float32))
        tg, wt = tg.to(dev), wt.to(dev)
        ck, wk = hist_k.hist(tg, wt, num_bins=k)
        cp, wp = ref.hist_ref(tg, wt, k)
        torch.cuda.synchronize()
        check(torch.equal(ck, cp), f"tag_hist K={k}: counts differ")
        check(torch.allclose(wk, wp, rtol=1e-4, atol=1e-6),
              f"tag_hist K={k}: weighted sums differ beyond rtol 1e-4")
        err = float((wk - wp).abs().max())
        keep = (tg >= 0) & (tg < k)
        tv, wv = tg[keep], wt[keep]
        report("hist" if k == 3300 else None, "tag_hist.hist",
               "src/repro_torch/kernels/csrc/tag_hist.cu",
               "src/repro/kernels/tag_hist.py:22", err,
               time_ms(lambda tg=tg, wt=wt, k=k: hist_k.hist(tg, wt,
                                                             num_bins=k)),
               time_ms(lambda tg=tg, wt=wt, k=k: ref.hist_ref(tg, wt, k)),
               8.0 * s + 8.0 * k, 2.0 * s,
               time_ms(lambda tv=tv, wv=wv, k=k: torch.bincount(
                   tv, weights=wv, minlength=k)),
               f"S={s} K={k}")
    del tg, wt, tv, wv, ck, cp, wk, wp, t32, dt, deltas, n_k, n_p, g_k, g_p
    torch.cuda.empty_cache()

    # -- phase 3: the main path -----------------------------------------------
    t = time.perf_counter()
    ref_rep = detect_offline(log, tags, stacks, n_min, samples=samples,
                             backend="numpy", chunk_events=1 << 20)
    print(f"[main] numpy chunked oracle: {time.perf_counter() - t:.2f} s")
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
        runs[label] = (rep, launches)
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
    whole, chunked = runs["whole-log"][1], runs["chunked"][1]
    launches = {"fold": whole["fold"] + chunked["fold"],
                "carry_cumsum": whole["carry_cumsum"]
                + chunked["carry_cumsum"],
                "hist": whole["hist"] + chunked["hist"]}
    check(whole["fold"] >= 1 and whole["hist"] >= 1,
          f"whole-log run launched {whole}")
    check(chunked["carry_cumsum"] >= 1 and chunked["hist"] >= 1,
          f"chunked run launched {chunked}")
    for key, row in rows.items():
        row["launches"] = launches[key]
    if args.profile:
        for label, chunk in (("whole-log", None), ("chunked", 1 << 20)):
            profile_main_path(label, lambda chunk=chunk: detect_offline(
                log, tags, stacks, n_min, samples=samples, backend="fused",
                chunk_events=chunk))
    print(f"[main] whole script {time.perf_counter() - t_script:.1f} s")

    print(smi)
    print(json.dumps({"kernels": [rows["fold"], rows["carry_cumsum"],
                                  rows["hist"]]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
