"""The offline slice as a whole: EventLog → sanitize → CMetric → SliceTable
→ merge → BottleneckReport → export, in both packages.

A tagged capture (several workers, four call paths, samples from the
probe's offline replay) is built with the JAX package's objects and carried
into the port with ``repro_torch.convert``.  On the float64 ``numpy``
backend the port's ``export("json")`` is byte-identical to the reference's,
whole-log and chunked, and the text export and a what-if projection are
equal.  The fused backend, on the CPU, matches the reference ``pallas``
backend: floats rtol 1e-4 (its float32 tolerance), integers and the ranking
exact.
"""
import json
import math
import os
import sys

import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro_torch import convert
from repro_torch.core import detect_offline, detector, export
from repro_torch.device import use_device
from tests.test_tracer import FakeClock

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

PATHS = [("main", "step", "allreduce"), ("main", "load"),
         ("main", "step", "optimizer", "lock"), ("main", "io")]
N_MIN = 3.0
SAMPLE_DT_NS = 40_000


def _jax_capture(seed, num_workers=6, slices=40):
    """A tagged JAX-package capture: every slice runs one of ``PATHS``."""
    rng = np.random.default_rng(seed)
    log = J.synthetic_log(rng, num_workers, slices)
    tags = J.TagRegistry()
    stacks = J.StackRegistry()
    sids = np.asarray([stacks.intern(tuple(tags.intern(t, f"app.py:{i}")
                                           for t in p))
                       for i, p in enumerate(PATHS)])
    top = np.asarray([stacks.paths[s][-1] for s in sids], np.int32)
    # each DEACTIVATE takes the path of its worker's preceding ACTIVATE
    order = np.argsort(log.workers, kind="stable")
    p = rng.integers(0, len(PATHS), len(log))
    ps = p[order]
    ps[1::2] = ps[0::2]
    p[order] = ps
    log.tags = top[p]
    log.stacks = np.where(log.deltas < 0, sids[p], -1).astype(np.int32)
    samples = J.simulate_samples(log, SAMPLE_DT_NS, N_MIN)
    return log, tags, stacks, samples


def _carry_across(log, tags, stacks, samples):
    fields = {k: getattr(log, k) for k in ("times", "workers", "deltas",
                                           "tags", "stacks", "num_workers")}
    st, sw, sg = samples.frozen()
    return convert.capture_from_numpy(
        fields, tags.names, tags.locations, stacks.paths,
        {"times": st, "workers": sw, "tags": sg,
         "dropped": samples.dropped})


@pytest.fixture(scope="module")
def capture():
    jcap = _jax_capture(4)
    return jcap, _carry_across(*jcap)


@pytest.mark.parametrize("chunk_events", [None, 97, 1000])
def test_numpy_reports_byte_identical(capture, chunk_events):
    (jlog, jtags, jstacks, jsamples), (log, tags, stacks, samples) = capture
    a = J.detect_offline(jlog, jtags, jstacks, N_MIN, samples=jsamples,
                         backend="numpy", chunk_events=chunk_events)
    b = detect_offline(log, tags, stacks, N_MIN, samples=samples,
                       backend="numpy", chunk_events=chunk_events)
    assert len(b.paths) >= 3 and b.total_critical > 0
    assert sum(sum(p.tag_counts.values()) for p in b.paths) > 0
    assert export(b, "json") == J.export(a, "json")
    assert export(b, "text") == J.export(a, "text")


def test_numpy_simulated_sampler_and_what_if_byte_equal(capture):
    (jlog, jtags, jstacks, _), (log, tags, stacks, _) = capture
    a = J.detect_offline(jlog, jtags, jstacks, N_MIN,
                         sample_dt_ns=SAMPLE_DT_NS, backend="numpy")
    b = detect_offline(log, tags, stacks, N_MIN, sample_dt_ns=SAMPLE_DT_NS,
                       backend="numpy")
    assert export(b, "json") == J.export(a, "json")
    assert b.what_if(path=1).to_json() == a.what_if(path=1).to_json()


def _assert_docs_close(a, b, where="$"):
    if isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            _assert_docs_close(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_docs_close(x, y, f"{where}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert math.isclose(a, b, rel_tol=1e-4, abs_tol=1e-9), (where, a, b)
    else:
        assert a == b, (where, a, b)


@pytest.mark.parametrize("backend", ["fused", "pallas"])
@pytest.mark.parametrize("chunk_events", [None, 500])
def test_fused_matches_reference_pallas(capture, backend, chunk_events):
    (jlog, jtags, jstacks, jsamples), (log, tags, stacks, samples) = capture
    a = J.detect_offline(jlog, jtags, jstacks, N_MIN, samples=jsamples,
                         backend="pallas", chunk_events=chunk_events)
    b = detect_offline(log, tags, stacks, N_MIN, samples=samples,
                       backend=backend, chunk_events=chunk_events,
                       device="cpu")
    assert [p.stack for p in b.paths] == [p.stack for p in a.paths]
    _assert_docs_close(json.loads(J.export(a, "json")),
                       json.loads(export(b, "json")))


def test_key_hist_on_the_tag_hist_wrapper_equals_bincount():
    """The detector's device route (taken on CUDA) gives bincount's table;
    on a CPU device the wrapper runs its plain version."""
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 300, 5000)
    np.testing.assert_array_equal(
        detector._key_hist(keys, 300, torch.device("cpu")),
        np.bincount(keys, minlength=300))


def test_detect_offline_device_defaults_to_cuda(capture, monkeypatch):
    """No device given: the fused default runs on CUDA, which raises here
    rather than falling back to the CPU."""
    _, (log, tags, stacks, samples) = capture
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        detect_offline(log, tags, stacks, N_MIN, samples=samples)
    with use_device("cpu"):
        rep = detect_offline(log, tags, stacks, N_MIN, samples=samples)
    assert rep.replay.backend == "fused" and rep.paths


def test_chip_smoke_capture_rehearsal():
    """``chip_smoke.py``'s capture at a small size: its samples are exactly
    the sampler's offline replay, and the injected path ranks first on the
    oracle and the fused backend, whole-log and chunked."""
    fields, names, locs, paths, sfields, n_min = chip_smoke.make_capture(
        1, num_workers=64, rounds=32, group=4)
    log, tags, stacks, samples = convert.capture_from_numpy(
        fields, names, locs, paths, sfields)
    assert len(log) == 2 * 64 * 32 and len(stacks) == 50
    log.validate()
    replay = J.simulate_samples(
        J.EventLog(**{k: fields[k] for k in fields}), 100_000, n_min)
    got = np.lexsort((samples.frozen()[0], samples.frozen()[1]))
    want = np.lexsort((replay.frozen()[0], replay.frozen()[1]))
    for x, y in zip(samples.frozen(), replay.frozen()):
        np.testing.assert_array_equal(x[got], y[want])
    ref = detect_offline(log, tags, stacks, n_min, samples=samples,
                         backend="numpy", chunk_events=1000)
    assert ref.paths[0].stack == chip_smoke.INJECTED_PATH
    for chunk in (None, 1000):
        rep = detect_offline(log, tags, stacks, n_min, samples=samples,
                             backend="fused", chunk_events=chunk,
                             device="cpu")
        assert rep.paths[0].stack == chip_smoke.INJECTED_PATH
        assert rep.total_slices == ref.total_slices
        np.testing.assert_allclose(rep.per_worker, ref.per_worker, rtol=1e-3)
        assert chip_smoke._critical_keys(rep.critical_table) == \
            chip_smoke._critical_keys(ref.critical_table)


def _drive_tracer(pkg):
    """Two parallel workers and one serial worker under two call paths,
    on a fake clock (the JAX package's test_detector trace)."""
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


def test_live_tracer_detect_byte_identical():
    """The copied tracer's batched online fold and ``detect`` give the
    reference's report, byte for byte."""
    a = J.detect(_drive_tracer(J))
    b = T.detect(_drive_tracer(T))
    assert b.total_critical == 8
    assert export(b, "json") == J.export(a, "json")
