"""The port's spans (``repro_torch.spans``): a no-op without a profiler,
a profiler range with one, the clock map from GAPP's clock onto the
trace's, the drains the tracer records, the spans the engine, the
trainer, the blocks and AdamW enter, and the chrome export on the trace's
clock."""
import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch import configs, spans
from repro_torch.core import ProfileSession
from repro_torch.core import tracer as tracer_lib
from repro_torch.core.timeline import to_chrome_trace


def _names(prof) -> list[str]:
    return [e.name() for e in prof.profiler.kineto_results.events()]


def test_span_is_one_shared_noop_without_a_profiler():
    a, b = spans.span("serve/submit"), spans.span("model/attention")
    assert a is b
    with a:
        torch.ones(3) + 1
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(3) + 1
    assert "serve/submit" not in _names(prof)


def test_span_is_a_profiler_range_under_a_profiler():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("model/attention"):
            torch.ones(3) + 1
    ev = {e.name(): e for e in prof.profiler.kineto_results.events()}
    s, add = ev["model/attention"], ev["aten::add"]
    assert s.start_ns() <= add.start_ns() and add.end_ns() <= s.end_ns()
    # not a user annotation, so the profiler mirrors nothing of it onto
    # the device's timeline
    if hasattr(s, "is_user_annotation"):
        assert not s.is_user_annotation()


def test_clock_map_interpolates_between_its_anchors():
    m = spans.ClockMap((1_000, 5_000_000), (2_001_000, 7_000_100))
    assert m(1_000) == 5_000_000 and m(2_001_000) == 7_000_100
    assert m(1_001_000) == 6_000_050
    assert m.drift_ns == 100
    got = m(np.array([1_000, 1_001_000], np.int64))
    assert got.dtype == np.int64 and got.tolist() == [5_000_000, 6_000_050]
    p, w = spans.anchor()
    assert abs(w - time.time_ns()) < 50_000_000
    assert abs(p - time.perf_counter_ns()) < 50_000_000


def test_a_gapp_clock_interval_around_a_range_holds_it_on_the_trace_clock():
    """Read ``perf_counter_ns`` before and after each of a few ranges: on
    the trace's clock the pair encloses the range, within 100 us."""
    brackets = []
    start = spans.anchor()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(5):
            p0 = time.perf_counter_ns()
            with record_function(f"probe/{i}"):
                torch.ones(64) + 1
            brackets.append((f"probe/{i}", p0, time.perf_counter_ns()))
            time.sleep(0.002)
    m = spans.ClockMap(start, spans.anchor())
    ev = {e.name(): e for e in prof.profiler.kineto_results.events()}
    for name, p0, p1 in brackets:
        e = ev[name]
        assert m(p0) <= e.start_ns() + 100_000
        assert m(p1) >= e.end_ns() - 100_000


def test_on_device_marks_the_current_segment_only():
    with spans.on_device():
        pass
    ticks = iter(range(10, 100, 10))
    seg = spans.DeviceSegment(lambda: next(ticks))
    with seg:
        with spans.on_device():
            pass
        with spans.on_device():
            pass
    with spans.on_device():
        pass
    assert (seg.begin, seg.end) == (10, 40)


def _session(**kw) -> ProfileSession:
    return ProfileSession(device="cpu", dt=0.002, **kw)


def test_the_tracer_records_each_drain_that_folds():
    s = _session()
    w = [s.register_worker(f"w{i}") for i in range(3)]
    for _ in range(5):
        for wid in w:
            s.begin(wid, "work")
        s.tracer.sync()
        for wid in w:
            s.end(wid)
        s.tracer.sync()
    s.tracer.sync()                  # nothing pending: not recorded
    rec = s.tracer.drain_record()
    assert len(rec) == 10
    for b, db, de, e, n in rec:
        assert b <= db <= de <= e and n == 3
    assert sum(r[4] for r in rec) == s.stats()["events_folded"]
    s.close()
    with_numpy = ProfileSession(device="cpu", fold_backend="numpy")
    wid = with_numpy.register_worker("w")
    with_numpy.begin(wid, "x")
    with_numpy.tracer.sync()
    (_, db, de, _, n), = with_numpy.tracer.drain_record()
    assert db is None and de is None and n == 1
    with_numpy.close()


def test_the_drain_record_keeps_the_newest(monkeypatch):
    monkeypatch.setattr(tracer_lib, "DRAIN_RECORD", 3)
    t = tracer_lib.Tracer(device="cpu", fold_backend="fused")
    wid = t.register_worker("w")
    for _ in range(3):
        t.begin(wid, "a")
        t.sync()
        t.end(wid)
        t.sync()
    rec = t.drain_record()
    assert len(rec) == 3
    assert [r[0] for r in rec] == sorted(r[0] for r in rec)
    assert rec[-1][0] >= max(r[3] for r in rec[:-1])


def _span_counts(fn) -> dict:
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    names = _names(prof)
    return {n: names.count(n) for n in
            ("serve/submit", "serve/step.issue", "model/attention",
             "train/loader_wait", "train/step.issue", "optim/adamw")}


def test_the_engine_enters_its_spans():
    from repro_torch.models import init_lm
    from repro_torch.serve.engine import Engine, Request
    cfg = configs.get_tiny("deepseek-7b")
    params = init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    eng = Engine(cfg, params, batch_slots=2, cache_len=16, device="cpu")
    reqs = [Request(i, np.array([1, 2, 3]), max_new=2) for i in range(3)]
    c = _span_counts(lambda: eng.run(reqs))
    # two requests, two steps; the third, turned away twice, two steps
    assert c["serve/step.issue"] == 4
    assert c["serve/submit"] == 5
    assert c["model/attention"] == 4 * cfg.num_layers


@pytest.mark.parametrize("arch", ["deepseek-7b", "seamless-m4t-large-v2",
                                  "recurrentgemma-2b"])
def test_each_attention_call_is_one_span(arch):
    from repro_torch.models import forward, init_lm
    cfg = configs.get_tiny(arch)
    params = init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, 8))}
    if cfg.enc_layers:
        batch["frontend"] = torch.randn(1, 4, cfg.frontend_dim)
    with torch.no_grad():
        c = _span_counts(lambda: forward(params, batch, cfg))
    kinds = list(cfg.block_pattern) * (
        cfg.num_layers // len(cfg.block_pattern))
    attn = sum(k in ("dense", "moe", "local", "encoder") for k in kinds) \
        + 2 * sum(k == "cross" for k in kinds) + cfg.enc_layers
    assert c["model/attention"] == attn > 0


def test_the_trainer_enters_its_spans(tmp_path):
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = configs.get_tiny("deepseek-7b")
    tcfg = TrainerConfig(steps=2, ckpt_every=0, batch_per_host=2,
                         seq_len=16, log_every=100, profile=False,
                         ckpt_dir=str(tmp_path))
    tr = Trainer(cfg, adamw.AdamWConfig(), tcfg, device="cpu")
    c = _span_counts(tr.run)
    assert c["train/loader_wait"] == c["train/step.issue"] == 2
    assert c["optim/adamw"] == 2
    # the forward and remat's recompute
    assert c["model/attention"] == 2 * 2 * cfg.num_layers


def test_chrome_export_on_the_trace_clock_lies_beside_a_torch_trace(
        tmp_path):
    s = _session()
    wid = s.register_worker("w")
    start = spans.anchor()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        time.sleep(0.002)
        s.begin(wid, "work")
        with record_function("probe/work"):
            time.sleep(0.005)
        s.end(wid)
        time.sleep(0.002)
    m = spans.ClockMap(start, spans.anchor())
    s.close()
    path = tmp_path / "torch.json"
    prof.export_chrome_trace(str(path))
    torch_trace = json.loads(path.read_text())
    base = int(torch_trace.get("baseTimeNanoseconds", 0))
    rng = next(e for e in torch_trace["traceEvents"]
               if e.get("name") == "probe/work")
    log = s.freeze()
    plain = to_chrome_trace(log, tag_names=list(s.tracer.tags.names))
    assert plain == to_chrome_trace(log, tag_names=list(s.tracer.tags.names),
                                    clock=None)
    ours = json.loads(to_chrome_trace(
        log, tag_names=list(s.tracer.tags.names),
        clock=lambda t: m(t) - base))
    work = next(e for e in ours["traceEvents"] if e.get("name") == "work")
    assert work["ts"] <= rng["ts"] + 100
    assert work["ts"] + work["dur"] >= rng["ts"] + rng["dur"] - 100
    assert work["dur"] == pytest.approx(rng["dur"], abs=1_000)
    # the exporter passes the keyword on
    rep = s.result()
    via = json.loads(s.export("chrome", clock=lambda t: m(t) - base))
    assert via["traceEvents"] == json.loads(to_chrome_trace(
        log, tag_names=rep.tag_names, worker_names=rep.worker_names,
        critical=rep.critical_table, worker_hosts=rep.worker_hosts,
        clock=lambda t: m(t) - base))["traceEvents"]
