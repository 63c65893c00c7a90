"""Run one cell traced, as ``run.py --trace 1`` does, and read the
program's own spans from the window too: device and host time by span
and GAPP's drains on the trace's clock (``spantrace.py``).

    python3 gappbench/spanrun.py --workload <cell> --seed <n> \
        --seconds <s> [--record <file>]

The line it prints is ``run.py``'s traced line, whose metrics also hold
the cell's end-to-end metrics (as the traced window read them) and every
metric of :data:`SPAN_METRICS` that finds something to read.  Without a
CUDA card it prints no result and exits with 2.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import functools  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:] = [p for p in sys.path if pathlib.Path(p or ".").resolve() != HERE]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

SPAN_METRICS = ("decode_attn_ms", "decode_submit_ms",
                "gapp_drain_device_ms.decode", "gapp_drain_idle.decode",
                "train_attn_ms", "train_adamw_ms",
                "gapp_drain_device_ms.train")


def run_traced(cell, seed: int, seconds: float, device, t_start: float,
               controls=()) -> tuple[dict, list[str], dict]:
    """``run.run_cell`` traced, with ``spantrace.Tracing`` in
    ``devtrace.Tracing``'s place and the session's drain record kept for
    it; the result's metrics gain the end-to-end and span metrics."""
    from gappbench import devtrace, gapp_check, run, spantrace
    drains: dict = {}
    real_tracing, real_capture = devtrace.Tracing, gapp_check.capture

    def capture(session):
        record = getattr(session.tracer, "drain_record", None)
        drains["record"] = record() if record is not None else None
        return real_capture(session)
    devtrace.Tracing = functools.partial(spantrace.Tracing, drains=drains)
    gapp_check.capture = capture
    try:
        result, lines, rec = run.run_cell(cell, seed, seconds, True, device,
                                          t_start, controls=controls)
    finally:
        devtrace.Tracing, gapp_check.capture = real_tracing, real_capture
    e2e = cell.end_to_end if cell.end_to_end is not None \
        else run.all_metrics("end_to_end")
    result["metrics"].update(run.read_metrics(list(e2e) + list(SPAN_METRICS),
                                              rec))
    return result, lines, rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--record", default=None,
                    help="also write the run's record to this JSON file")
    args = ap.parse_args(argv)
    from gappbench import cell as cell_lib
    from gappbench import run
    cell = cell_lib.load(args.workload)
    import torch
    if not torch.cuda.is_available():
        print(f"gappbench: {args.workload} needs a CUDA card",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    result, lines, rec = run_traced(cell, args.seed, args.seconds, device,
                                    T_START)
    if args.record:
        run.save_record(rec, args.record)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
