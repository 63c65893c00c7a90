"""Run one cell once: set up, warm up, measure for ``--seconds``, check the
timed path against the plain reference, print one JSON line.

    python3 gappbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

With ``--trace 0`` the line's metrics are the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics (the window under
``torch.profiler``).  Without a CUDA card, or with fewer cards than the
cell asks for, it prints no result and exits with 2.  It exits with 3 and
prints no result if, once the window has closed, the process holds the
JAX package or JAX itself.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
# run as a script, the harness's own folder heads sys.path; its modules
# are imported as the package's, never by their bare names
sys.path[:] = [p for p in sys.path if pathlib.Path(p or ".").resolve() != HERE]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def forbidden_modules(names=None) -> list[str]:
    """Top-level names among ``names`` (``sys.modules`` when None) that the
    benchmark must not hold, compared whole (``repro_torch`` is not
    ``repro``)."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & FORBIDDEN)


def _reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"gappbench: no reader for metric {name}")
    spec = importlib.util.spec_from_file_location(
        "gappbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_metrics(names: list[str], record: dict) -> dict:
    """Each metric's reader over the record; a reader that finds nothing
    to read returns None and the metric is left out."""
    out = {}
    for name in names:
        mod = _reader(name)
        value = mod.read(record)
        if value is not None:
            out[name] = {"value": value, "unit": mod.UNIT}
    return out


def all_metrics(kind: str) -> list[str]:
    return sorted(p.stem for p in (HERE / "metrics").glob("*.py")
                  if not p.stem.startswith("_")
                  and _reader(p.stem).KIND == kind)


def _free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        import torch
        torch.cuda.empty_cache()


def check_decode(cell, seed, device, closed, keep, controls) -> tuple:
    """``logit_gap``; where the family routes tokens to experts,
    ``logit_gap_routed`` and ``route_gap`` instead, the reference routed as
    the program did (``decode.reference_gaps``)."""
    from gappbench import decode
    bank, offsets = keep
    modes = ("program",) + tuple(m for m in ("control", "wrong_route")
                                 if m in controls)
    g = decode.reference_gaps(cell, seed, device, closed, bank, offsets,
                              modes)
    if "route" not in g:
        return ({m: {"logit_gap": g["gap"][m]} for m in modes},
                {"tokens_checked": g["tokens"]})
    return ({m: {"logit_gap_routed": g["gap"][m],
                 "route_gap": g["route"][m]} for m in modes},
            {"tokens_checked": g["tokens"], "routes_differing": g["moved"]})


def check_train(cell, seed, device, closed, controls) -> tuple:
    from gappbench import train
    from gappbench.reference import model as ref
    refr = train.reference(cell, seed, device, closed["batches"])
    nums = {"program": train.gaps(closed, refr)}
    if "control" in controls:
        low = train.reference(cell, seed, device, closed["batches"],
                              mm=ref.fp8_mm)
        nums["control"] = train.gaps(low, refr)
    if "half_batch" in controls:
        half = train.reference(cell, seed, device, closed["batches"],
                               keep_rows=slice(0, cell.traffic["batch"] // 2))
        nums["half_batch"] = train.gaps(half, refr)
    return nums, {"losses": closed["losses"], "ref_losses": refr["losses"]}


def check_gapp(cap, controls) -> dict:
    import numpy as np
    from gappbench import gapp_check
    nums = {"program": gapp_check.readings(cap)}
    if "control" in controls:
        nums["control"] = gapp_check.readings(cap, dtype=np.float16)
    for name, fault in gapp_check.FAULTS.items():
        if name in controls:
            nums[name] = gapp_check.readings(fault(cap))
    return nums


def judge(limits: dict, nums: dict) -> tuple[dict, list[str]]:
    """Each compared number beside its limit, and why the run is not
    correct (empty when it is)."""
    checks, why = {}, []
    for name, limit in limits.items():
        value = nums[name]
        checks[name] = {"value": value if math.isfinite(value)
                        else repr(value), "limit": limit}
        if limit is None or not math.isfinite(value) or value > limit:
            why.append(f"{name} {value} over its limit {limit}")
    return checks, why


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, controls=()) -> tuple[dict, list[str], dict]:
    """One run; returns the result's object, the lines for standard error
    (the compared numbers beside their limits last) and the record the
    readers read.  Each of ``controls`` (``control``, ``half_batch``,
    ``wrong_route``, ``drop_critical``, ``permute_tags``; see
    ``control.py``) is put in the program's place after the window and
    held to the same limits: the result then also gives, under
    ``controls``, each one's readings and whether it came out correct."""
    import torch
    from gappbench import decode, train
    from gappbench import devtrace as trace_lib
    tracing = trace_lib.Tracing(trace, device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    entry = cell.traffic["entry"]
    marks = {}
    if entry == "decode":
        with decode.route_tap(cell) as tap:
            live = decode.setup(cell, seed, device, tap)
            marks["setup"] = time.perf_counter()
            tracing.open()
            rec = decode.window(live, seconds, tracing.mark)
            tracing.close()
            keep = (live.bank, live.offsets)
            closed = decode.close(live)
    elif entry == "train":
        def setup_done():
            marks["setup"] = time.perf_counter()
            tracing.open()
        live = train.setup(cell, seed, device, setup_done)
        rec = train.run(live, seconds, tracing.mark)
        tracing.close()
        closed = train.close(live)
    else:
        raise SystemExit(f"gappbench: unknown entry {entry}")
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    del live
    _free(device)
    summary = tracing.summary()
    tracing = None
    rec.update(setup_s=marks["setup"] - t_start, shape=cell.shape,
               traffic=cell.traffic, trace=summary)
    lines = []
    gcap = closed.pop("gapp")
    if entry == "decode":
        nums, info = check_decode(cell, seed, device, closed, keep, controls)
        del keep
    else:
        nums, info = check_train(cell, seed, device, closed, controls)
    why = []
    if gcap is not None:
        cap, missing = gcap
        rec["gapp_capture"] = {k: v.tolist() if hasattr(v, "tolist") else v
                               for k, v in cap.items() if k != "stats"}
        gnums = check_gapp(cap, controls)
        # a control or fault of one layer leaves the other's numbers as
        # the program has them
        for mode in set(nums) | set(gnums):
            nums[mode] = {**nums.get(mode, nums["program"]),
                          **gnums.get(mode, gnums["program"])}
        lines.append("gapp session stats " + json.dumps(cap["stats"],
                                                        default=str))
        if missing:
            why.append(missing)
    lines.append("check info " + json.dumps(info))
    checks, over = judge(cell.limits, nums["program"])
    why += over
    lines.append("not compared " + json.dumps(
        {k: v for k, v in nums["program"].items() if k not in checks}))
    if rec["failed"]:
        why.append(f"{rec['failed']} of {rec['attempted']} failed")
    if trace:
        names = cell.per_layer if cell.per_layer is not None \
            else all_metrics("per_layer")
    else:
        names = cell.end_to_end if cell.end_to_end is not None \
            else all_metrics("end_to_end")
    dev_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                "kind": torch.cuda.get_device_name(device)
                if device.type == "cuda" else "cpu",
                "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": not why, "attempted": rec["attempted"],
              "failed": rec["failed"], "metrics": read_metrics(names, rec),
              "device": dev_info}
    if summary is not None:
        dev_info.update(busy_s=summary["busy_s"],
                        window_s=summary["window_s"])
        result["breakdown"] = trace_lib.breakdown(summary)
    if controls:
        result["controls"] = {
            mode: {"readings": n, "correct": not judge(cell.limits, n)[1]}
            for mode, n in nums.items()}
    result["checks"] = checks
    for w in why:
        lines.append("not correct: " + w)
    for name, c in checks.items():
        lines.append(f"check {name} {c['value']!r} limit {c['limit']!r}")
    return result, lines, rec


def save_record(rec: dict, path: str) -> None:
    import dataclasses
    out = dict(rec, shape=dataclasses.asdict(rec["shape"]))
    pathlib.Path(path).parent.mkdir(parents=True, exist_ok=True)
    pathlib.Path(path).write_text(json.dumps(out))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--record", default=None,
                    help="also write the run's record (what the readers "
                    "read) to this JSON file")
    args = ap.parse_args(argv)
    from gappbench import cell as cell_lib
    cell = cell_lib.load(args.workload)
    import torch
    need = cell.traffic.get("chips", 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"gappbench: {args.workload} needs {need} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    result, lines, rec = run_cell(cell, args.seed, args.seconds,
                                  bool(args.trace), device, T_START)
    if args.record:
        save_record(rec, args.record)
    bad = forbidden_modules()
    if bad:
        print(f"gappbench: the process holds {bad} after the window",
              file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
