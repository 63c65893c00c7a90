"""Each metric reader on records of traced runs (recorded on an H100,
read also as untraced), and the trace's reduction on profiles."""
import json
import math
import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from gappbench import cell as cell_lib  # noqa: E402
from gappbench import devtrace, run, yardstick  # noqa: E402

DATA = pathlib.Path(__file__).with_name("data")


def _record(name: str) -> dict:
    rec = json.loads((DATA / name).read_text())
    rec["shape"] = cell_lib.Shape(**rec["shape"])
    return rec


def _read(metric: str, rec: dict):
    return run._reader(metric).read(rec)


@pytest.fixture(scope="module")
def decode_traced():
    return _record("decode-traced.rec.json")


@pytest.fixture(scope="module")
def train_traced():
    return _record("train-traced.rec.json")


def test_end_to_end_readers(decode_traced, train_traced):
    d, t = decode_traced, train_traced
    assert _read("decode_tokens_per_s", d) == sum(d["tokens"]) / d["window_s"]
    gaps = sorted(d["step_s"])
    assert _read("decode_itl_p95_ms", d) == \
        gaps[math.ceil(0.95 * len(gaps)) - 1] * 1e3
    assert _read("decode_itl_p95_ms", d) >= 1e3 * sorted(gaps)[len(gaps) // 2]
    assert _read("train_tokens_per_s", t) == \
        t["steps"] * t["positions"] / t["window_s"]
    assert _read("setup_s", d) == d["setup_s"]
    assert _read("train_tokens_per_s", d) is None
    assert _read("decode_tokens_per_s", t) is None


def test_host_span_readers(decode_traced, train_traced):
    d, t = decode_traced, train_traced
    mean = sum(d["issue_s"]) / len(d["issue_s"]) * 1e3
    assert _read("decode_issue_ms", d) == pytest.approx(mean, rel=1e-12)
    assert _read("train_issue_ms", t) == pytest.approx(
        sum(t["issue_s"]) / len(t["issue_s"]) * 1e3, rel=1e-12)
    assert _read("loader_wait_ms", t) >= 0
    assert _read("gapp_drain_ms.decode", d) > 0
    assert _read("gapp_drain_ms.train", d) is None
    assert _read("gapp_drain_ms.train", t) > 0


def test_device_readers_stay_within_their_roofs(decode_traced, train_traced):
    d, t = decode_traced, train_traced
    for name, rec in (("decode_mfu", d), ("decode_gemm_roofline", d),
                      ("train_mfu", t), ("train_gemm_roofline", t)):
        v = _read(name, rec)
        assert 0 < v <= 100, (name, v)
    idle = _read("device_idle.decode", d)
    tr = d["trace"]
    assert idle == pytest.approx(100 * (1 - tr["busy_s"] / tr["window_s"]))
    bound = sum(yardstick.decode_step(d["shape"], n, r)["bound_s"]
                for n, r in zip(d["tokens"], d["rows"]))
    assert _read("decode_mfu", d) == pytest.approx(
        100 * bound / d["window_s"])


def test_untraced_records_give_no_device_metric(decode_traced):
    rec = dict(decode_traced, trace=None)
    for name in ("decode_mfu", "decode_gemm_roofline", "device_idle.decode"):
        assert _read(name, rec) is None


def test_every_listed_metric_is_read_in_its_cells(decode_traced,
                                                 train_traced):
    for cell, rec in (("ds7b8-decode-c4k-nogapp", decode_traced),
                      ("ivl2-train-s4k-gapp", train_traced)):
        c = cell_lib.load(cell)
        assert set(run.read_metrics(c.per_layer, rec)) == set(c.per_layer)
        assert set(run.read_metrics(c.end_to_end, rec)) == set(c.end_to_end)
    nogapp = cell_lib.load("ds7b8-decode-c4k-nogapp")
    assert "gapp_drain_ms.decode" not in nogapp.per_layer


def test_trace_reduction_on_a_profile():
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(devtrace.WINDOW):
            with record_function("gappbench/engine.step"):
                torch.randn(64, 64) @ torch.randn(64, 64)
    s = devtrace.summarize(prof)
    assert s["busy_s"] == 0 and s["window_s"] > 0
    assert sum(s["idle"].values()) == pytest.approx(s["window_s"])
    b = devtrace.breakdown(s)
    assert b["device_ops"] == [] and len(b["idle_gaps"]) >= 1


def test_union_and_gap_names():
    assert devtrace._union([(5, 7), (0, 2), (1, 3), (6, 9)]) == \
        [[0, 3], [5, 9]]
    host = [(0, 100, "outer"), (10, 20, "inner"), (50, 60, "later")]
    named = devtrace._name_gaps([(12, 14), (30, 40), (52, 58)], host)
    assert named == pytest.approx({"inner": 2e-9, "outer": 10e-9,
                                   "later": 6e-9})


class _Event:
    """A profiler event as torch 2.11 gives it (no ``activity_type`` and
    no ``is_user_annotation``)."""

    def __init__(self, name, a, b, cuda=False, tid=1):
        self._n, self._a, self._b, self._cuda, self._tid = name, a, b, cuda, tid

    def name(self):
        return self._n

    def start_ns(self):
        return self._a

    def end_ns(self):
        return self._b

    def start_thread_id(self):
        return self._tid

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._cuda else \
            torch.autograd.DeviceType.CPU


def test_device_mirrors_of_spans_are_no_device_work():
    import types
    events = [_Event(devtrace.WINDOW, 0, 1000),
              _Event("gappbench/engine.step", 0, 1000),
              _Event("gappbench/engine.step", 0, 1000, cuda=True),
              _Event("nvjet_gemm", 100, 300, cuda=True),
              _Event("copy", 250, 400, cuda=True),
              _Event("aten::mm", 500, 900)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    s = devtrace.summarize(prof)
    assert s["busy_s"] == pytest.approx(300e-9)
    assert set(s["kernels"]) == {"nvjet_gemm", "copy"}
    assert s["idle"] == pytest.approx({"gappbench/engine.step": 100e-9,
                                       "aten::mm": 600e-9})
