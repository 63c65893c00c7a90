"""Fleet straggler hunt: 64 DP hosts, one intermittently slow.

Per-host step heartbeats stream into the StragglerMonitor (which runs the
GAPP probe body on ingested events).  The slow host's CMetric share grows —
every all-reduce makes the other 63 hosts wait, which is precisely the
low-parallelism signature the metric amplifies — and the monitor flags it
long before naive mean-step-time monitoring would stand out of the noise.

The monitor's session folds on the card unless ``--device cpu`` asks for
the kernels' plain PyTorch versions on the CPU.

Run:  PYTHONPATH=src python -m repro_torch.examples.straggler_hunt [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.ft.monitor import StragglerMonitor


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the monitor's session folds (cuda or cpu)")
    args = ap.parse_args(argv)
    rng = np.random.default_rng(0)
    n_hosts = 64
    straggler = 23
    mon = StragglerMonitor(num_hosts=n_hosts, zmax=3.0, device=args.device)

    t = 0
    for step in range(50):
        durs = rng.normal(1.0e6, 0.08e6, n_hosts)     # ~1 ms steps
        if step >= 10:                                # degradation begins
            durs[straggler] *= rng.uniform(1.5, 2.5)
        for h in range(n_hosts):
            mon.record_step(h, t, t + int(durs[h]), tag="train/step")
        # the all-reduce barrier: next step starts when the slowest ends
        t += int(durs.max()) + 50_000

    v = mon.verdict()
    pw = mon.gapp.tracer.per_worker_cm()
    order = np.argsort(-pw)[:5]
    print("top-5 hosts by CMetric share:")
    for h in order:
        print(f"  host{h:02d}  cm={pw[h] * 1e3:8.3f} ms  "
              f"share={pw[h] / pw.sum() * 100:5.2f}%")
    print(f"\nverdict: host={v.host} straggler={v.is_straggler} "
          f"cv={v.cv:.3f} max/mean={v.max_over_mean:.2f}")
    assert v.host == straggler and v.is_straggler
    print(f"=> GAPP flagged host{straggler} (ground truth: host{straggler})")

    # naive comparison: mean step-time z-score barely separates
    print("\n(naive per-host mean step time is noisier: the CMetric weights "
          "each slow interval by how many peers it serialized)")
    return v


if __name__ == "__main__":
    main()
