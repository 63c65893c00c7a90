"""The span reduction (``spantrace.py``) on small event lists and on
profiles of the port on the CPU, the tiny cells run through ``spanrun``,
and the readers of the accepted metrics pinned to their values on the
committed records."""
import json
import pathlib
import sys
import time

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from gappbench import cell as cell_lib  # noqa: E402
from gappbench import run, spanrun, spantrace  # noqa: E402
from gappbench.spantrace import Dev, Op  # noqa: E402

DATA = pathlib.Path(__file__).with_name("data")
SEED = 2**31 + 104_729
MS = 1_000_000


def _reduce(ops, dev, window=(0, 100 * MS), drains=()):
    return spantrace.reduce(ops, dev, window, drains)


def test_a_device_event_goes_to_the_innermost_span_of_its_launch():
    ops = [Op("train/step.issue", 1, 0, 50 * MS, corr=1),
           Op("model/attention", 1, 10 * MS, 20 * MS, corr=2),
           Op("aten::mm", 1, 12 * MS, 13 * MS, corr=3),
           Op("aten::mul", 1, 30 * MS, 31 * MS, corr=4),
           Op("aten::add", 1, 60 * MS, 61 * MS, corr=5)]
    dev = [Dev(14 * MS, 16 * MS, link=3), Dev(32 * MS, 35 * MS, link=4),
           Dev(62 * MS, 63 * MS, link=5), Dev(70 * MS, 71 * MS, link=0)]
    r = _reduce(ops, dev)
    assert r["device_s"] == pytest.approx({
        "model/attention": 2e-3, "train/step.issue": 3e-3,
        spantrace.NONE: 2e-3})
    assert r["host_s"]["model/attention"] == pytest.approx(10e-3)
    assert r["count"]["model/attention"] == 1
    assert r["count"]["optim/adamw"] == 0


def test_a_backward_kernel_goes_to_its_forward_ops_span_on_another_thread():
    ops = [Op("model/attention", 1, 0, 10 * MS, corr=1),
           Op("aten::mm", 1, 1 * MS, 2 * MS, corr=2, seq=7),
           Op("aten::softmax", 1, 3 * MS, 4 * MS, corr=3, seq=8),
           Op("aten::mm", 1, 20 * MS, 21 * MS, corr=4, seq=9),
           # the backward thread: one node per forward op, and remat's
           # recompute inside one of them, which re-enters the span
           Op("autograd::engine::evaluate_function: MmBackward0", 2,
              30 * MS, 40 * MS, corr=10, seq=9, fwd=1),
           Op("model/attention", 2, 31 * MS, 33 * MS, corr=11),
           Op("aten::mm", 2, 31 * MS, 32 * MS, corr=12, seq=0),
           Op("aten::layer_norm", 2, 33 * MS, 34 * MS, corr=16, seq=1),
           Op("aten::mm", 2, 35 * MS, 36 * MS, corr=13),
           Op("autograd::engine::evaluate_function: MmBackward0", 2,
              50 * MS, 60 * MS, corr=14, seq=7, fwd=1),
           Op("aten::mm", 2, 51 * MS, 52 * MS, corr=15)]
    dev = [Dev(32 * MS, 33 * MS, link=12),     # recompute, in its span
           Dev(34 * MS, 35 * MS, link=16),     # recompute, outside it
           Dev(36 * MS, 37 * MS, link=13),     # backward of seq 9
           Dev(52 * MS, 54 * MS, link=15)]     # backward of seq 7
    r = _reduce(ops, dev)
    assert r["device_s"] == pytest.approx({
        "model/attention": 3e-3, spantrace.NONE: 2e-3})


def test_overlapping_device_events_are_credited_once():
    ops = [Op("model/attention", 1, 0, 10 * MS, corr=1),
           Op("aten::mm", 1, 1 * MS, 2 * MS, corr=2),
           Op("optim/adamw", 1, 20 * MS, 30 * MS, corr=3),
           Op("aten::add", 1, 21 * MS, 22 * MS, corr=4),
           # a runtime call whose id is the same number as a torch op's
           Op("cudaLaunchKernel", 1, 21 * MS, 22 * MS, corr=2)]
    dev = [Dev(40 * MS, 50 * MS, link=2), Dev(45 * MS, 60 * MS, link=4),
           Dev(46 * MS, 48 * MS, link=4), Dev(95 * MS, 120 * MS, link=4)]
    r = _reduce(ops, dev)
    assert r["device_s"] == pytest.approx({"model/attention": 10e-3,
                                           "optim/adamw": 15e-3})
    assert sum(r["device_s"].values()) == pytest.approx(r["busy_s"])
    assert r["busy_s"] == pytest.approx(25e-3)


def test_idle_is_counted_only_while_a_drain_is_open():
    dev = [Dev(10 * MS, 20 * MS), Dev(40 * MS, 90 * MS)]
    drains = [(-5 * MS, None, None, 5 * MS, 3),          # from before
              (15 * MS, 16 * MS, 18 * MS, 30 * MS, 2),
              (25 * MS, 26 * MS, 27 * MS, 45 * MS, 4),   # overlaps the last
              (95 * MS, 96 * MS, 97 * MS, 130 * MS, 1),
              (150 * MS, 151 * MS, 152 * MS, 160 * MS, 1)]  # after
    r = _reduce([], dev, drains=drains)
    # idle: [0, 10), [20, 40), [90, 100); open: [0, 5), [15, 45), [95, 100)
    assert r["drain_idle_s"] == pytest.approx((5 + 20 + 5) * 1e-3)
    assert len(r["drains"]) == 4
    assert r["drains"][1] == pytest.approx([15e-3, 16e-3, 18e-3, 30e-3, 2])
    assert r["drains"][0][1] is None


def _train_profile():
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import configs
    from repro_torch.models import init_lm
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_step
    cfg = configs.get_tiny("deepseek-7b")
    gen = torch.Generator().manual_seed(0)
    params = init_lm(gen, cfg, device="cpu")
    opt = adamw.init(params)
    step = make_train_step(cfg, adamw.AdamWConfig())
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 16))}
    step(params, opt, batch, None)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("gappbench/window"):
            step(params, opt, batch, None)
    return cfg, prof


def test_a_cpu_train_step_credits_backward_ops_to_attention():
    cfg, prof = _train_profile()
    ops, dev = spantrace.events(prof)
    assert dev == []
    owner = spantrace.owner_of(ops)
    attn = [i for i, o in enumerate(ops) if o.name == "model/attention"]
    # the forward and remat's recompute, one span a layer each
    assert len(attn) == 2 * cfg.num_layers
    assert sum(o.name == "optim/adamw" for o in ops) == 1
    backward = [i for i, o in enumerate(ops)
                if o.seq >= 0 and o.fwd != 0 and "Backward" in o.name]
    assert backward
    credited = {owner(i) for i in backward}
    assert "model/attention" in credited and None in credited
    # every op inside a span is its span's, unless it is backward work
    for i in attn:
        a = ops[i]
        inside = [j for j, o in enumerate(ops) if o.tid == a.tid
                  and a.start <= o.start and o.end <= a.end
                  and o.name not in spantrace.SPANS]
        assert inside and all(owner(j) == "model/attention" for j in inside)
    r = spantrace.reduce_profile(prof)
    assert r["count"]["model/attention"] == 2 * cfg.num_layers
    assert r["busy_s"] == 0 and r["device_s"] == {}


def _traced(name: str, seconds: float):
    return spanrun.run_traced(cell_lib.load(name), SEED, seconds,
                              torch.device("cpu"), time.perf_counter())


def _close(a: float, b: float) -> bool:
    """Within 10% or 0.5 ms."""
    return abs(a - b) <= max(0.1 * abs(b), 0.5e-3)


def test_tiny_decode_cell_reports_its_host_spans():
    result, lines, rec = _traced("tiny-decode-gapp", 2.0)
    assert result["correct"], lines
    sp = rec["trace"]["spans"]
    assert "decode_submit_ms" in result["metrics"]
    assert {"decode_tokens_per_s", "decode_itl_p95_ms", "setup_s",
            "decode_issue_ms"} <= set(result["metrics"])
    # no device on the CPU: no device metric
    for name in ("decode_attn_ms", "gapp_drain_device_ms.decode",
                 "gapp_drain_idle.decode"):
        assert name not in result["metrics"]
    # the program's spans agree with the harness's wrappers
    n = sp["count"]["serve/step.issue"]
    assert n == len(rec["issue_s"])
    assert _close(sp["host_s"]["serve/step.issue"] / n,
                  sum(rec["issue_s"]) / n)
    assert sp["count"]["model/attention"] == n * rec["shape"].layers
    drains = sp["drains"]
    assert drains and rec["drain_s"]
    assert _close(sum(d[3] - d[0] for d in drains) / len(drains),
                  sum(rec["drain_s"]) / len(rec["drain_s"]))
    for b, db, de, e, events in drains:
        assert b <= db <= de <= e and events > 0
    assert abs(sp["clock_drift_ns"]) < 1e6


def test_tiny_train_cell_reports_its_host_spans():
    # long enough that the session's drains fold events inside the window
    result, lines, rec = _traced("tiny-train-gapp", 3.0)
    assert result["correct"], lines
    sp = rec["trace"]["spans"]
    assert {"train_tokens_per_s", "train_issue_ms",
            "loader_wait_ms"} <= set(result["metrics"])
    assert "train_attn_ms" not in result["metrics"]
    # the window opens inside the first timed call of the step function,
    # so its span misses that call; the call that closes the window is
    # cut short before the step, inside its span
    n = sp["count"]["train/step.issue"]
    assert n == len(rec["issue_s"]) == rec["steps"]
    assert _close(sp["host_s"]["train/step.issue"] / (n - 1),
                  sum(rec["issue_s"][1:]) / (n - 1))
    # the first call's AdamW runs after the window opened
    assert sp["count"]["optim/adamw"] == rec["steps"]
    assert sp["count"]["train/loader_wait"] == len(rec["loader_wait_s"])
    # the span encloses the wrapper, and reads more by the call between
    # them and by the interpreter lock, when the loader's or the drain's
    # thread takes it there (a few ms on a loaded CPU): the span holds the
    # loader's get and not the step (hundreds of ms here)
    extra = sp["host_s"]["train/loader_wait"] - sum(rec["loader_wait_s"])
    assert -1e-4 <= extra <= 0.01 * len(rec["loader_wait_s"])
    drains = sp["drains"]
    assert drains and rec["drain_s"]
    assert _close(sum(d[3] - d[0] for d in drains) / len(drains),
                  sum(rec["drain_s"]) / len(rec["drain_s"]))


def _record(name: str) -> dict:
    rec = json.loads((DATA / name).read_text())
    rec["shape"] = cell_lib.Shape(**rec["shape"])
    return rec


ACCEPTED = {
    "decode-traced.rec.json": {
        "decode_issue_ms": 37.194445236717065,
        "gapp_drain_ms.decode": 16.74467132038091,
        "decode_mfu": 3.415610456464482,
        "decode_gemm_roofline": 4.522035445202966,
        "device_idle.decode": 3.816383044542049},
    "train-traced.rec.json": {
        "train_issue_ms": 1508.2245827241675,
        "loader_wait_ms": 0.0874847586178005,
        "gapp_drain_ms.train": 25.704959676904064,
        "train_mfu": 7.124165811406205,
        "train_gemm_roofline": 15.263165356876105,
        "device_idle.train": 2.4362612664354133},
}


@pytest.mark.parametrize("name", sorted(ACCEPTED))
def test_the_accepted_readers_read_what_they_read_before(name):
    rec = _record(name)
    want = ACCEPTED[name]
    got = {m: run._reader(m).read(rec) for m in want}
    assert got == pytest.approx(want, rel=1e-12)
    others = sorted({m for v in ACCEPTED.values() for m in v} - set(want))
    assert all(run._reader(m).read(rec) is None for m in others)
    # a record without the program's spans gives none of their metrics
    assert all(run._reader(m).read(rec) is None
               for m in spanrun.SPAN_METRICS)


# record: (the benchmark's cell whose listed metrics it must give, the
# span metrics it reads); the first is a GAPP decode run's record, held to
# the decode cell's list
SPAN_RECORDS = {
    "decode-spans.rec.json": ("ds7b8-decode-c4k-nogapp", {
        "decode_attn_ms", "decode_submit_ms", "gapp_drain_device_ms.decode",
        "gapp_drain_idle.decode"}),
    "decode-nogapp-spans.rec.json": ("ds7b8-decode-c4k-nogapp", {
        "decode_attn_ms", "decode_submit_ms"}),
    "train-spans.rec.json": ("ivl2-train-s4k-gapp", {
        "train_attn_ms", "train_adamw_ms", "gapp_drain_device_ms.train"}),
    "train-ds7b8-spans.rec.json": ("ds7b8-train-s4k-gapp", {
        "train_attn_ms", "train_adamw_ms", "gapp_drain_device_ms.train"}),
}


@pytest.mark.parametrize("name", sorted(SPAN_RECORDS))
def test_the_span_readers_on_traced_h100_records(name):
    """Records of ``spanrun.py`` on an H100 (700 W): each cell reads its
    span metrics and no other, the spans' device seconds add up to the
    busy time, and the drains' device segments lie inside the drains."""
    cell, wanted = SPAN_RECORDS[name]
    rec = _record(name)
    sp, tr = rec["trace"]["spans"], rec["trace"]
    got = run.read_metrics(list(spanrun.SPAN_METRICS), rec)
    assert set(got) == wanted
    c = cell_lib.load(cell)
    assert set(run.read_metrics(c.per_layer, rec)) == set(c.per_layer)
    assert sum(sp["device_s"].values()) == pytest.approx(tr["busy_s"],
                                                        rel=1e-9)
    assert sp["busy_s"] == pytest.approx(tr["busy_s"], rel=1e-9)
    steps = len(rec["step_s"]) if rec["entry"] == "decode" \
        else rec["steps"]
    attn = sp["device_s"]["model/attention"] / steps * 1e3
    key = "decode_attn_ms" if rec["entry"] == "decode" else "train_attn_ms"
    assert got[key]["value"] == pytest.approx(attn, rel=1e-12)
    assert 0 < attn < 1e3 * tr["busy_s"] / steps
    if rec["entry"] == "train":
        assert 0 < got["train_adamw_ms"]["value"] < attn
        assert sp["count"]["optim/adamw"] == steps
    for b, db, de, e, n in sp["drains"]:
        assert b <= db <= de <= e and n > 0
    drain = f"gapp_drain_device_ms.{rec['entry']}"
    if drain in got:
        assert got[drain]["value"] <= run._reader(
            f"gapp_drain_ms.{rec['entry']}").read(rec)
    if "gapp_drain_idle.decode" in got:
        assert got["gapp_drain_idle.decode"]["value"] <= run._reader(
            "device_idle.decode").read(rec)


def test_both_decode_cells_spend_the_same_on_attention():
    a, b = (run._reader("decode_attn_ms").read(_record(n)) for n in
            ("decode-spans.rec.json", "decode-nogapp-spans.rec.json"))
    assert abs(a - b) <= 0.02 * b
