"""The port's waker analysis, report classification and Chrome-trace
export against the JAX package's.

The cases of ``tests/test_wakers.py`` and ``tests/test_timeline.py`` run
through ``repro_torch.core`` on the same fake-clock captures as the
reference's, and each output is compared with the reference's own:
``waker_edges``, ``critical_wakers``, ``classify_tag`` and
``classify_report`` equal, and ``to_chrome_trace``/``dump_chrome_trace``
JSON byte-equal.  The tracers fold with their default ``numpy`` backend,
on the host.
"""
import dataclasses
import json

import pytest

import repro.core as J
import repro_torch.core as T
from tests.test_tracer import FakeClock


def _lock_trace(pkg):
    """w0 holds a 'lock': w1/w2 activate just after w0 deactivates."""
    clk = FakeClock()
    tr = pkg.Tracer(n_min=2.5, clock=clk)
    w = [tr.register_worker(f"w{i}") for i in range(3)]
    for _ in range(6):
        tr.begin(w[0], "hold_lock")
        clk.advance(3_000_000)
        tr.end(w[0])
        clk.advance(1_000)                  # wake-up latency < eps
        tr.begin(w[1], "critical_section")
        tr.begin(w[2], "critical_section")
        clk.advance(1_000_000)
        tr.end(w[1])
        tr.end(w[2])
        clk.advance(500_000)
    return tr


def _bottleneck_trace(pkg):
    """``tests/test_detector.py``'s trace: w0/w1 parallel bursts, w2 long
    serial sections under two call paths."""
    clk = FakeClock()
    tr = pkg.Tracer(n_min=1.9, clock=clk)
    w = [tr.register_worker(f"w{i}") for i in range(3)]
    for rep in range(8):
        tr.begin(w[0], "par")
        tr.begin(w[1], "par")
        clk.advance(2_000_000)
        tr.end(w[0])
        tr.end(w[1])
        tr.begin(w[2], "io_phase")
        tr.push(w[2], "flush" if rep % 2 else "compress")
        clk.advance(5_000_000)
        tr.pop(w[2])
        tr.end(w[2])
    return tr


def test_waker_edges_found():
    edges = T.waker_edges(_lock_trace(T).freeze(), eps_ns=10_000)
    pairs = {(e.waker, e.woken): e.count for e in edges}
    assert pairs.get((0, 1)) == 6
    assert pairs.get((0, 2)) == 6
    assert (1, 0) not in pairs and (2, 0) not in pairs
    ref = J.waker_edges(_lock_trace(J).freeze(), eps_ns=10_000)
    assert [dataclasses.astuple(e) for e in edges] == \
        [dataclasses.astuple(e) for e in ref]


def test_critical_waker_ranking():
    ranked = T.critical_wakers(_lock_trace(T).freeze())
    assert ranked and ranked[0][0] == 0
    assert ranked[0][1] > 0
    assert ranked == J.critical_wakers(_lock_trace(J).freeze())


def test_classification():
    cases = {"train/wait_data": "data", "ckpt/save": "checkpoint",
             "moe/all_to_all": "collective", "decode/req3": "serve",
             "train/step": "compute", "mystery": "other"}
    for tag, kind in cases.items():
        assert T.classify_tag(tag) == J.classify_tag(tag) == kind
    rep = T.detect(_lock_trace(T), None)
    classes = T.classify_report(rep)
    assert sum(classes.values()) == pytest.approx(
        sum(p.cmetric for p in rep.paths))
    assert classes == J.classify_report(J.detect(_lock_trace(J), None))


def test_chrome_trace_roundtrip(tmp_path):
    paths = {}
    for name, pkg in (("ref", J), ("port", T)):
        paths[name] = str(tmp_path / f"{name}.json")
        pkg.dump_chrome_trace(_bottleneck_trace(pkg), paths[name])
    with open(paths["port"], "rb") as f:
        raw = f.read()
    with open(paths["ref"], "rb") as f:
        assert raw == f.read()
    evs = json.loads(raw)["traceEvents"]
    spans = [e for e in evs if e.get("ph") == "X" and e["pid"] == 0]
    crits = [e for e in evs if e.get("ph") == "X" and e["pid"] == 1]
    names = [e for e in evs if e.get("ph") == "M"]
    assert len(spans) == 24              # every completed slice
    assert len(crits) == 8               # the critical overlay
    assert any(n["args"]["name"] == "w2" for n in names
               if n["name"] == "thread_name")
    assert all(e["dur"] >= 0 for e in spans)
    top = max(crits, key=lambda e: e["args"]["cmetric_ms"])
    assert abs(top["args"]["cmetric_ms"] - 5.0) < 1e-6


def _chrome(pkg, tr):
    return pkg.to_chrome_trace(tr.freeze(), tag_names=list(tr.tags.names),
                               worker_names=tr.worker_names(),
                               critical=tr.critical)


def test_chrome_trace_invariant_to_drain_schedule():
    """The exported trace of the sharded tracer is the same whenever the
    drains happen mid-capture, and the reference's."""
    def drive(pkg, sync_every):
        clk = FakeClock()
        tr = pkg.Tracer(n_min=1.9, clock=clk)
        w = [tr.register_worker(f"w{i}") for i in range(3)]
        for rep in range(12):
            tr.begin(w[0], "par")
            tr.begin(w[1], "par")
            clk.advance(2_000_000)
            tr.end(w[0])
            tr.end(w[1])
            tr.begin(w[2], "io_phase")
            clk.advance(5_000_000)
            tr.end(w[2])
            if sync_every and rep % sync_every == 0:
                tr.sync()               # mid-capture drain
        return _chrome(pkg, tr)

    baseline = drive(T, 0)              # a single drain at freeze()
    for every in (1, 3, 5):
        assert drive(T, every) == baseline
    assert baseline == drive(J, 0)
    evs = json.loads(baseline)["traceEvents"]
    assert sum(e.get("ph") == "X" for e in evs) == 12 * 3 + 12


def test_chrome_trace_invariant_under_autoflush_pressure():
    """Tiny shards force drains at arbitrary points; the trace equals the
    unpressured capture's, and the reference's."""
    def drive(pkg, capacity):
        clk = FakeClock()
        tr = pkg.Tracer(n_min=0.0, capacity=capacity, clock=clk)
        w = tr.register_worker("w")
        for _ in range(64):
            tr.begin(w, "x")
            clk.advance(1_000)
            tr.end(w)
            clk.advance(100)
        return _chrome(pkg, tr)

    pressured = drive(T, 8)
    assert pressured == drive(T, 1 << 16) == drive(J, 8)
