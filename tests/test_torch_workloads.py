"""The port's host-side workload demos against the JAX package, on the CPU.

The data pipeline, the straggler monitor, the GPipe schedule and the
pipeline-bubbles what-if: the same inputs through ``repro`` and
``repro_torch``.  ``SyntheticLM`` batches bit-equal (both draw from
``np.random.default_rng``); straggler verdicts equal (the float64 numpy
oracle on both sides; the fused backend's float32 per-host CMetric within
rtol 1e-4 of it); ``what_if(...).to_json()`` byte-equal on numpy; the
what-if within 15% of the injected ground truth on the fused backend, the
bound of ``benchmarks/bench_whatif.py``.
"""
import importlib.util
import pathlib

import numpy as np
import pytest

from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.ft import monitor as jmonitor
from repro.pipeline.gpipe import schedule_intervals as jschedule
from repro_torch.core import ProfileSession
from repro_torch.data import PrefetchLoader, SyntheticLM
from repro_torch.examples import (fleet_profile, pipeline_bubbles,
                                  straggler_hunt)
from repro_torch.ft import StragglerMonitor, run_with_restarts
from repro_torch.pipeline import schedule_intervals

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _reference_example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_reference_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("front", [None, (3, 5)])
def test_synthetic_batches_equal_the_reference(front):
    t = SyntheticLM(262_144, 64, 3, seed=11, frontend_shape=front)
    j = JSyntheticLM(262_144, 64, 3, seed=11, frontend_shape=front)
    for _ in range(4):
        a, b = t.next_batch(), j.next_batch()
        assert list(a) == list(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_data_pipeline_prefetch_and_profile():
    g = ProfileSession(n_min=4, device="cpu")
    src = SyntheticLM(vocab_size=100, seq_len=8, batch_per_host=2)
    loader = PrefetchLoader(src, depth=2, gapp=g)
    g.start()
    batches = [loader.get() for _ in range(5)]
    loader.stop()
    g.stop()
    assert not loader._thread.is_alive()
    assert all(b["tokens"].shape == (2, 8) for b in batches)
    assert all(b["tokens"].min() >= 0 and b["tokens"].max() < 100
               for b in batches)
    # loader spans were recorded
    assert g.tracer.per_worker_cm()[0] > 0
    assert g.tracer.worker_names()[0] == "data_loader"


def _step_records(n_hosts=8, steps=20, slow=5):
    out, t = [], 0
    rng = np.random.default_rng(3)
    for _ in range(steps):
        for h in range(n_hosts):
            dur = 3_000_000 if h == slow else int(rng.integers(9, 11)) \
                * 100_000
            out.append((h, t, t + dur))
        t += 4_000_000
    return out


@pytest.mark.parametrize("backend", ["numpy", "fused"])
def test_straggler_verdict_equals_the_reference(backend):
    records = _step_records()
    t = StragglerMonitor(num_hosts=8, zmax=2.0, fold_backend=backend,
                         device="cpu")
    j = jmonitor.StragglerMonitor(num_hosts=8, zmax=2.0)
    for h, a, b in records:
        t.record_step(h, a, b)
        j.record_step(h, a, b)
    tv, jv = t.verdict(), j.verdict()
    assert tv.host == jv.host == 5 and tv.is_straggler and jv.is_straggler
    assert type(tv).__name__ == type(jv).__name__ == "StragglerVerdict"
    if backend == "numpy":
        assert (tv.cv, tv.max_over_mean) == (jv.cv, jv.max_over_mean)
    else:
        np.testing.assert_allclose([tv.cv, tv.max_over_mean],
                                   [jv.cv, jv.max_over_mean], rtol=1e-4)
    np.testing.assert_allclose(t.session.tracer.per_worker_cm(),
                               j.session.tracer.per_worker_cm(),
                               rtol=0 if backend == "numpy" else 1e-4)
    assert t.gapp is t.session and t.session.device.type == "cpu"


def test_straggler_hunt_example_flags_the_slow_host():
    v = straggler_hunt.main(["--device", "cpu"])
    assert v.host == 23 and v.is_straggler


@pytest.mark.parametrize("n_stages,n_micro", [(4, 8), (8, 2), (1, 3)])
def test_schedule_intervals_equal_the_reference(n_stages, n_micro):
    assert schedule_intervals(n_stages, n_micro, 1e-3) \
        == jschedule(n_stages, n_micro, 1e-3)
    iv = schedule_intervals(n_stages=n_stages, n_micro=n_micro)
    span = max(e for _, _, e in iv) - min(s for _, s, _ in iv)
    busy = sum(e - s for _, s, e in iv)
    bubble = 1 - busy / (span * n_stages)
    assert bubble == pytest.approx((n_stages - 1) / (n_micro + n_stages - 1))


@pytest.mark.parametrize("shrink", [0.0, 0.5])
def test_pipeline_what_if_within_15_percent_of_the_ground_truth(shrink):
    """An injected 2 ms serial optimizer step: the projected speedup of
    removing (or halving) it against the true one, on the fused backend;
    on numpy, the what-if's JSON is the reference's, byte for byte."""
    serial_ns = 2_000_000
    _, _, g = pipeline_bubbles.profile_schedule(
        8, 8, serial_update_ns=serial_ns, device="cpu")
    rep = g.result()
    wi = rep.what_if("optimizer/serial_update", shrink=shrink)
    actual = rep.total_time / (rep.total_time
                               - (1.0 - shrink) * serial_ns / 1e9)
    assert abs(wi.speedup - actual) / actual <= 0.15, (wi.speedup, actual)
    assert wi.matched_slices > 0

    ref = _reference_example("pipeline_bubbles")
    _, _, jg = ref.profile_schedule(8, 8, serial_update_ns=serial_ns)
    _, _, tg = pipeline_bubbles.profile_schedule(
        8, 8, serial_update_ns=serial_ns, device="cpu", fold_backend="numpy")
    j_json = jg.result().what_if("optimizer/serial_update",
                                 shrink=shrink).to_json()
    t_json = tg.result().what_if("optimizer/serial_update",
                                 shrink=shrink).to_json()
    assert t_json == j_json


def test_pipeline_bubbles_and_fleet_profile_examples_run_on_the_cpu(capsys):
    """Each example's own asserts: the conservation check and the exact
    what-if; the fleet's top path on the serial section."""
    pipeline_bubbles.main(["--device", "cpu"])
    fleet_profile.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "conservation check" in out and "most critical host" in out


def test_run_with_restarts():
    calls = []

    def train_fn(start_step):
        calls.append(start_step)
        if len(calls) < 3:
            raise RuntimeError("simulated node failure")
        return 100

    assert run_with_restarts(train_fn, max_restarts=5) == 100
    assert calls == [0, -1, -1]
    seen = []

    def always_fails(start_step):
        raise ValueError("down")
    with pytest.raises(ValueError):
        run_with_restarts(always_fails, max_restarts=2,
                          on_restart=lambda n, e: seen.append(n))
    assert seen == [1, 2]
