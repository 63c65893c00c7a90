"""Regenerate the EXPERIMENTS.md roofline table from dry-run artifacts
(the rows :mod:`repro_torch.launch.dryrun` writes; the reference's table,
byte for byte).

Usage: PYTHONPATH=src python -m repro_torch.launch.tabulate [dir] [--md]
"""
from __future__ import annotations

import glob
import json
import sys

from repro_torch import configs


def load(directory: str = "experiments/dryrun"):
    rows = []
    for f in sorted(glob.glob(f"{directory}/*.json")):
        rows.append(json.load(open(f)))
    return rows


def render(rows, md: bool = False) -> str:
    out = []
    hdr = ["arch", "shape", "mesh", "GiB/chip", "t_comp(s)", "t_mem(s)",
           "t_coll(s)", "bound", "useful", "roofline", "note"]
    if md:
        out.append("| " + " | ".join(hdr) + " |")
        out.append("|" + "---|" * len(hdr))
    else:
        out.append(f"{'arch':22s} {'shape':12s} {'mesh':7s} {'GiB/chip':>9s} "
                   f"{'t_comp':>9s} {'t_mem':>9s} {'t_coll':>9s} "
                   f"{'bound':>10s} {'useful':>7s} {'roofline':>8s}  note")
    for arch in configs.ARCHS:
        for shape in configs.SHAPES:
            skip = shape == "long_500k" and arch not in configs.SUBQUADRATIC
            for mesh in ("single", "multi"):
                key = (arch, shape, mesh)
                r = next((x for x in rows if (x["arch"], x["shape"],
                                              x["mesh"]) == key), None)
                if skip:
                    if mesh == "single":
                        cells = [arch, shape, "-", "-", "-", "-", "-", "-",
                                 "-", "-",
                                 "skipped: full-attention arch (DESIGN §4)"]
                        out.append("| " + " | ".join(cells) + " |" if md
                                   else f"{arch:22s} {shape:12s} "
                                   f"{'skipped (full-attention arch)'}")
                    continue
                if r is None:
                    continue
                if not r["ok"]:
                    line = [arch, shape, mesh, "-", "-", "-", "-", "FAIL",
                            "-", "-", r["error"].splitlines()[0][:60]]
                else:
                    rf = r["roofline"]
                    gib = r["memory"]["per_chip_total"] / 2**30
                    if mesh == "multi":
                        # the reference's layout: its scan build counted
                        # a loop body once, so it shows memory only (the
                        # port's trace runs every layer; the row's JSON
                        # holds its full terms)
                        line = [arch, shape, mesh, f"{gib:.2f}", "—", "—",
                                "—", "—", "—", "—",
                                "shardability proof (scan build)"]
                    else:
                        note = ("two-point depth extrapolation"
                                if rf["mesh"].endswith("*") else "")
                        line = [arch, shape, mesh, f"{gib:.2f}",
                                f"{rf['t_compute']:.3e}",
                                f"{rf['t_memory']:.3e}",
                                f"{rf['t_collective']:.3e}",
                                rf["bottleneck"],
                                f"{rf['useful_ratio']:.3f}",
                                f"{rf['roofline_fraction']:.4f}", note]
                if md:
                    out.append("| " + " | ".join(line) + " |")
                else:
                    out.append(f"{line[0]:22s} {line[1]:12s} {line[2]:7s} "
                               f"{line[3]:>9s} {line[4]:>9s} {line[5]:>9s} "
                               f"{line[6]:>9s} {line[7]:>10s} {line[8]:>7s} "
                               f"{line[9]:>8s}  {line[10]}")
    return "\n".join(out)


def write_experiments(path: str = "EXPERIMENTS.md",
                      directory: str = "experiments/dryrun") -> None:
    """Replace the <!-- ROOFLINE_TABLE --> block in EXPERIMENTS.md."""
    table = render(load(directory), md=True)
    text = open(path).read()
    start = text.index("<!-- ROOFLINE_TABLE -->")
    end = text.index("<!-- /ROOFLINE_TABLE -->")
    new = (text[:start] + "<!-- ROOFLINE_TABLE -->\n" + table + "\n"
           + text[end:])
    open(path, "w").write(new)


if __name__ == "__main__":
    d = sys.argv[1] if len(sys.argv) > 1 and not sys.argv[1].startswith("--") \
        else "experiments/dryrun"
    if "--write-experiments" in sys.argv:
        write_experiments(directory=d)
        print("EXPERIMENTS.md updated")
    else:
        print(render(load(d), md="--md" in sys.argv))
