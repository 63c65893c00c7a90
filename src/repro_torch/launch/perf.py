"""§Perf iteration: run one hillclimb variant of a cell and diff it
against the recorded baseline.

  PYTHONPATH=src python -m repro_torch.launch.perf --arch gemma3-1b \\
      --shape train_4k --name chunked_local --local-impl chunked

Writes experiments/perf/<arch>_<shape>/<name>.json and prints the
before/after roofline terms (baseline read from experiments/dryrun/).
The cell is traced on fake ranks (:mod:`repro_torch.launch.dryrun`).
"""
import argparse
import dataclasses
import json
import os
import sys


def main(argv=None) -> int:
    from repro_torch.launch.dryrun import parse_rules, run_cell

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--name", required=True)
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--method", default="direct",
                    choices=["direct", "extrapolate"])
    ap.add_argument("--local-impl", default="mask")
    ap.add_argument("--opt-level", type=int, default=0)
    ap.add_argument("--attn-qchunk", type=int, default=0)
    ap.add_argument("--scan-layers", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--rules", default="")
    ap.add_argument("--baseline", default=None,
                    help="compare against this perf JSON instead of the "
                         "dryrun baseline")
    ap.add_argument("--device", default=None,
                    help="the device the fake ranks model (default: the "
                         "port's, CUDA)")
    args = ap.parse_args(argv)

    extra = parse_rules(args.rules)
    r = run_cell(args.arch, args.shape, args.mesh, method=args.method,
                 scan_layers=args.scan_layers, opt_level=args.opt_level,
                 attn_qchunk=args.attn_qchunk, local_impl=args.local_impl,
                 remat=not args.no_remat, extra_rules=extra,
                 device=args.device)
    outdir = f"experiments/perf/{args.arch}_{args.shape}"
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, args.name + ".json"), "w") as f:
        json.dump(dataclasses.asdict(r), f, indent=2)
    if not r.ok:
        print(r.error)
        return 1

    base_path = args.baseline or (
        f"experiments/dryrun/{args.arch}_{args.shape}_{args.mesh}.json")
    base = None
    if os.path.exists(base_path):
        with open(base_path) as f:
            base = json.load(f)

    def fmt(d):
        rf = d["roofline"]
        return (f"mem/chip {d['memory']['per_chip_total'] / 2**30:8.2f} GiB | "
                f"t_comp {rf['t_compute']:.3e} t_mem {rf['t_memory']:.3e} "
                f"t_coll {rf['t_collective']:.3e} | bound {rf['bottleneck']:>10s} "
                f"| useful {rf['useful_ratio']:.3f} roof "
                f"{rf['roofline_fraction']:.4f}")

    print(f"=== {args.arch} {args.shape} {args.mesh} :: {args.name} "
          f"({r.seconds:.0f}s compile) ===")
    if base and base.get("ok"):
        print("before:", fmt(base))
    print("after :", fmt(dataclasses.asdict(r)))
    if base and base.get("ok"):
        b, a = base["roofline"], r.roofline
        for k in ("t_compute", "t_memory", "t_collective"):
            if b[k] > 0:
                print(f"  {k}: {b[k]:.3e} -> {a[k]:.3e}  "
                      f"({b[k] / max(a[k], 1e-30):.2f}x)")
        print(f"  roofline_fraction: {b['roofline_fraction']:.4f} -> "
              f"{a['roofline_fraction']:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
