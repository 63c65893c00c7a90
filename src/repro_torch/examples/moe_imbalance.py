"""MoE expert imbalance as a serialization bottleneck.

Experts are logical workers.  We run the *real* tiny-arctic router on a
skewed token distribution, convert each expert's per-layer load into busy
spans (service time ∝ tokens processed, experts process in parallel, the
all-to-all completes when the slowest expert finishes), and profile.  The
hot expert's CMetric share exposes the imbalance; with the router's
aux-loss-balanced load the profile flattens and step time drops.

The router runs, and the sessions fold, on the card unless ``--device
cpu`` asks for the CPU.  Its parameters and inputs are drawn from
``torch.Generator``s, so the loads are not the JAX example's.

Run:  PYTHONPATH=src python -m repro_torch.examples.moe_imbalance [--device cpu]
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch import configs
from repro_torch import device as device_lib
from repro_torch.core import ProfileSession, imbalance_stats
from repro_torch.models import moe as moe_lib


def expert_loads(skew: float, seed: int = 0, device=None):
    """Run the tiny-arctic router on inputs biased toward one direction."""
    dev = device_lib.resolve(device)
    cfg = configs.get_tiny("arctic-480b")
    cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    p = moe_lib.init_moe(torch.Generator(dev).manual_seed(1), cfg,
                         device=dev)
    x = torch.randn((4, 64, cfg.d_model), device=dev,
                    generator=torch.Generator(dev).manual_seed(seed)) \
        .to(cfg.compute_dtype)
    if skew > 0:
        bias = torch.randn((cfg.d_model,), device=dev,
                           generator=torch.Generator(dev).manual_seed(9))
        x = x + skew * bias          # pushes the router toward few experts
    _, aux = moe_lib.moe_ffn(p, x, cfg)
    return aux["expert_load"].cpu().numpy().astype(np.int64), cfg.num_experts


def profile_loads(loads: np.ndarray, steps: int = 20,
                  ns_per_token: int = 2000, device=None):
    g = ProfileSession(n_min=None, device=device)
    wids = [g.register_worker(f"expert{e}", "expert")
            for e in range(len(loads))]
    t = 0
    for _ in range(steps):
        for e in range(len(loads)):
            if loads[e] > 0:
                # per-expert tags: the profile (and the what-if engine)
                # can name exactly which expert serializes the all-to-all
                g.ingest(t, wids[e], +1, f"moe/expert{e}")
        dur = loads * ns_per_token
        for e in np.argsort(dur):
            if loads[e] > 0:
                g.ingest(t + int(dur[e]), wids[int(e)], -1)
        t += int(dur.max()) + 10_000     # all-to-all barrier
    return g, t


def what_if_accuracy(device=None) -> dict:
    """The what-if projection against its constructible ground truth:
    drop the hot expert's work, project the gain, then *measure* it by
    re-profiling with that expert's load zeroed."""
    loads, _ = expert_loads(2.5, device=device)
    g, _ = profile_loads(loads, device=device)
    rep = g.result()
    hot = int(np.argmax(rep.per_worker))
    wi = rep.what_if(f"moe/expert{hot}", shrink=0.0)
    fixed = loads.copy()
    fixed[hot] = 0
    g2, _ = profile_loads(fixed, device=device)
    actual = rep.total_time / g2.result().total_time
    return {"hot": hot, "projected": wi.speedup, "actual": actual,
            "rel_err": abs(wi.speedup - actual) / actual,
            "matched_slices": wi.matched_slices}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the router runs and the sessions fold "
                    "(cuda or cpu)")
    args = ap.parse_args(argv)
    dev = device_lib.resolve(args.device)
    for name, skew in (("balanced", 0.0), ("skewed", 2.5)):
        loads, ne = expert_loads(skew, device=dev)
        g, span = profile_loads(loads, device=dev)
        pw = g.tracer.per_worker_cm()
        stats = imbalance_stats(pw)
        hot = int(np.argmax(pw))
        print(f"{name:9s} loads[min/max]={loads.min()}/{loads.max()} "
              f"cm_cv={stats['cv']:.2f} hot=expert{hot} "
              f"hot_share={pw[hot] / max(pw.sum(), 1e-12) * 100:.1f}% "
              f"step_span={span / 20 / 1e6:.2f} ms")
    print("\n=> the hot expert serializes every all-to-all; its CMetric "
          "share is the profiler's native view of router imbalance.")

    acc = what_if_accuracy(dev)
    print(f"\nwhat-if: drop expert{acc['hot']} -> projected "
          f"{acc['projected']:.3f}x end-to-end; measured without it "
          f"{acc['actual']:.3f}x (error {acc['rel_err'] * 100:.1f}%)")


if __name__ == "__main__":
    main()
