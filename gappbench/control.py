"""The readings that the limits of a cell's check are set from, over many
seeds in one process: each seed is one run of the cell (``run_cell``, its
window at the cell's own load), whose check reads the program and, put in
its place, the control and the faults the cell can have, each held to the
cell's limits by the harness's own comparison.

    python3 gappbench/control.py --workload <cell> --seeds 12 \
        --seconds 10 [--out control-<cell>.jsonl] [--device cpu]

The control is the reference in the precision below the configuration's:
every product's operands rounded to float8 (e4m3); in decode its reading
is the float32 reference's gap to the token the control puts first at
each position of the same prompts and served tokens (routed as the
program routed, where the family routes tokens to experts); GAPP's
control folds the session's log in float16.  The faults: half the batch
left out (the mean over the rest; training with two rows or more); in
decode where the family routes tokens to experts, each token's last
choice in every expert layer moved to the expert the reference ranks
last (``decode.wrong_route``); and, where a GAPP session is attached, a
critical slice left out of its report and its report's tags permuted.  A
training state left unchanged reads 1 by the change's measure and needs
no run.

On the card it reads the cell at its own size; ``--device cpu`` reads
the tiny test-only cells on the CPU, and the tests call
:func:`controls_for` and ``run_cell`` there.
"""
import argparse
import json
import pathlib
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
sys.path[:] = [p for p in sys.path if pathlib.Path(p or ".").resolve() != HERE]
for p in (HERE.parent / "src", HERE.parent):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from gappbench import cell as cell_lib  # noqa: E402


def controls_for(cell) -> tuple:
    """The controls and faults that ``cell`` can have."""
    out = ["control"]
    mix = cell.traffic
    if mix["entry"] == "train" and mix["batch"] >= 2:
        out.append("half_batch")
    if mix["entry"] == "decode" and cell_lib.route_layers(cell.shape):
        out.append("wrong_route")
    if mix.get("gapp"):
        out += ["drop_critical", "permute_tags"]
    return tuple(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=2_000_000_011)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    import torch
    from gappbench import run
    cell = cell_lib.load(args.workload)
    if args.device == "cpu":
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda", 0)
    else:
        print("control: no CUDA card", file=sys.stderr)
        return 2
    controls = controls_for(cell)
    out = open(args.out, "a") if args.out else None
    try:
        for i in range(args.seeds):
            seed = args.first_seed + 7919 * i
            t = time.perf_counter()
            result, lines, _ = run.run_cell(cell, seed, args.seconds, False,
                                            device, t, controls=controls)
            info = next(x for x in lines if x.startswith("check info "))
            row = dict(result["controls"], workload=args.workload, seed=seed,
                       correct=result["correct"],
                       info=json.loads(info[len("check info "):]),
                       seconds=time.perf_counter() - t)
            del result
            run._free(device)
            if cell.traffic["entry"] == "train":
                row["state_unchanged"] = {"readings": {"update_gap": 1.0}}
            line = json.dumps(row)
            print(line, flush=True)
            if out is not None:
                out.write(line + "\n")
                out.flush()
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
