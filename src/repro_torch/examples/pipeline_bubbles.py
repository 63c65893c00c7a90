"""Pipeline-parallel bubbles through the profiler's lens.

The GPipe schedule's warm-up/drain slots are reduced-parallelism intervals.
Ingesting the schedule's per-stage busy intervals, the CMetric splits
cleanly: with few microbatches the bubble fraction is large and stage
criticality is heavily skewed toward the pipeline ends; scaling microbatches
flattens it.  The same numbers fall out of the profiler as from the
analytic bubble formula (n_stages-1)/(n_micro+n_stages-1).

Every session folds on the card with the fused backend unless
``--device cpu`` asks for the kernels' plain PyTorch versions on the CPU;
``fold_backend="numpy"`` gives the float64 oracle (the JAX package's
default).

Run:  PYTHONPATH=src python -m repro_torch.examples.pipeline_bubbles [--device cpu]
"""
import argparse

from repro_torch.core import ProfileSession, imbalance_stats
from repro_torch.pipeline.gpipe import schedule_intervals


def profile_schedule(n_stages: int, n_micro: int,
                     serial_update_ns: int = 0, *, device=None,
                     fold_backend: str = "fused"):
    g = ProfileSession(n_min=None, fold_backend=fold_backend, device=device)
    wids = [g.register_worker(f"stage{s}", "stage") for s in range(n_stages)]
    events = []
    for s, t0, t1 in schedule_intervals(n_stages, n_micro, t_stage=1e-3):
        # integer ns (float accumulation would mis-order end/start ties)
        events.append((round(t0 * 1e9), s, +1))
        events.append((round(t1 * 1e9), s, -1))
    for t, s, d in sorted(events):
        g.ingest(t, wids[s], d, "stage_step")
    if serial_update_ns:
        # injected bottleneck with ground truth by construction: a serial
        # optimizer step on stage0 after the pipeline drains — removing
        # it is worth exactly serial_update_ns of wall clock
        t_end = max(t for t, _, _ in events)
        g.ingest(t_end, wids[0], +1, "optimizer/serial_update")
        g.ingest(t_end + int(serial_update_ns), wids[0], -1)
    pw = g.tracer.per_worker_cm()
    span = (n_stages + n_micro - 1) * 1e-3
    busy = n_stages * n_micro * 1e-3
    bubble = 1 - busy / (span * n_stages)
    return pw, bubble, g


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where every session folds (cuda or cpu)")
    args = ap.parse_args(argv)
    dev = args.device
    n_stages = 8
    print(f"{'n_micro':>8s} {'bubble%':>8s} {'cm_cv':>8s} "
          f"{'cm(stage0)':>11s} {'cm(mid)':>9s}")
    for n_micro in (2, 4, 8, 16, 32, 64):
        pw, bubble, _ = profile_schedule(n_stages, n_micro, device=dev)
        stats = imbalance_stats(pw)
        print(f"{n_micro:8d} {bubble * 100:8.1f} {stats['cv']:8.3f} "
              f"{pw[0] * 1e3:11.3f} {pw[n_stages // 2] * 1e3:9.3f}")
    print("\n=> bubbles shrink as microbatches grow; the CMetric CV tracks "
          "the bubble fraction, and the profiler needs no schedule "
          "knowledge to see it.")
    # the profiler's idle+criticality accounting matches the analytic bubble
    pw, bubble, g = profile_schedule(8, 8, device=dev)
    total = g.tracer.per_worker_cm().sum() + g.tracer.idle_time
    span = (8 + 8 - 1) * 1e-3
    assert abs(total - span) < 1e-6
    print(f"   (conservation check: Σcm+idle = {total * 1e3:.3f} ms "
          f"= schedule span {span * 1e3:.3f} ms)")
    # causal what-if: inject a 2 ms serial optimizer step and ask what
    # fixing it is worth — the true gain is its duration, by construction
    serial_ns = 2_000_000
    _, _, g = profile_schedule(8, 8, serial_update_ns=serial_ns, device=dev)
    rep = g.result()
    wi = rep.what_if("optimizer/serial_update", shrink=0.0)
    truth_s = rep.total_time - serial_ns / 1e9
    print(f"\nwhat-if: remove the {serial_ns / 1e6:.2f} ms serial "
          f"optimizer step -> projected {wi.speedup:.3f}x "
          f"({rep.total_time * 1e3:.2f} -> {wi.projected_total_s * 1e3:.2f} "
          f"ms); ground truth {truth_s * 1e3:.2f} ms")
    assert abs(wi.projected_total_s - truth_s) < 1e-9, (
        wi.projected_total_s, truth_s)


if __name__ == "__main__":
    main()
