"""The port's CMetric backends and chunked fold against the JAX package.

Same seeded logs through ``repro.core`` and ``repro_torch.core`` (carried
across as numpy fields).  The float64 ``numpy`` backend and its
``FoldCarry`` must be bit-equal; the device backends (``vector``,
``fused``), run here on the CPU, are held to the reference's own float32
tolerance: per-worker rtol 1e-4 / atol 1e-6 (tests/test_kernels.py) with
equal slice counts.
"""
import dataclasses

import numpy as np
import pytest

import repro.core as J
from repro_torch import convert
from repro_torch.core import backends, cmetric
from repro_torch.core.slices import SliceTable
from repro_torch.device import use_device

COLUMNS = ("worker", "start_ns", "end_ns", "cm", "threads_av", "stack_id",
           "n_at_exit")


def _logs(seed, num_workers=6, slices=30):
    """A JAX-package log and the same log carried into the port."""
    jlog = J.synthetic_log(np.random.default_rng(seed), num_workers, slices)
    fields = {f.name: getattr(jlog, f.name)
              for f in dataclasses.fields(jlog)}
    tlog, _, _, _ = convert.capture_from_numpy(fields, [], [], [])
    return jlog, tlog


def _carry_fields(carry):
    return {f.name: getattr(carry, f.name)
            for f in dataclasses.fields(carry)}


def _assert_tables_equal(a, b):
    assert len(a) == len(b)
    for col in COLUMNS:
        x, y = getattr(a, col), getattr(b, col)
        assert x.dtype == y.dtype, col
        np.testing.assert_array_equal(x, y, err_msg=col)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_numpy_backend_bit_equal(seed):
    jlog, tlog = _logs(seed)
    a = J.compute_numpy(jlog)
    b = cmetric.compute(tlog, backend="numpy")
    np.testing.assert_array_equal(a.per_worker, b.per_worker)
    _assert_tables_equal(a.table, b.table)
    assert (a.idle_time, a.total_time, a.t0_ns) == (b.idle_time,
                                                    b.total_time, b.t0_ns)


@pytest.mark.parametrize("splits", [[1] * 7 + [10_000], [37, 1, 100, 10_000],
                                    [250, 250, 10_000]])
def test_fold_carry_bit_equal_after_any_partition(splits):
    jlog, tlog = _logs(5, num_workers=5, slices=40)
    jc = J.FoldCarry.init(jlog.num_workers)
    tc = cmetric.FoldCarry.init(tlog.num_workers)
    lo = 0
    for s in splits:
        hi = min(lo + s, len(jlog))
        jc, jt = J.fold_chunk(jc, jlog.chunk(lo, hi), backend="numpy")
        tc, tt = cmetric.fold_chunk(tc, tlog.chunk(lo, hi), backend="numpy")
        _assert_tables_equal(jt, tt)
        for name, value in _carry_fields(jc).items():
            np.testing.assert_array_equal(getattr(tc, name), value,
                                          err_msg=name)
        lo = hi
    assert lo == len(jlog)
    np.testing.assert_array_equal(tc.per_worker,
                                  J.compute_numpy(jlog).per_worker)


def test_carry_from_numpy_resumes_a_reference_fold():
    """A carry handed over mid-stream from the JAX package folds on in the
    port exactly as it would have in the reference."""
    jlog, tlog = _logs(7)
    cut = len(jlog) // 3
    jc, _ = J.fold_chunk(J.FoldCarry.init(jlog.num_workers),
                         jlog.chunk(0, cut), backend="numpy")
    tc = convert.carry_from_numpy(_carry_fields(jc))
    assert tc.cm_hash is not jc.cm_hash
    jc, jt = J.fold_chunk(jc, jlog.chunk(cut, len(jlog)), backend="numpy")
    tc, tt = cmetric.fold_chunk(tc, tlog.chunk(cut, len(tlog)),
                                backend="numpy")
    _assert_tables_equal(jt, tt)
    np.testing.assert_array_equal(tc.per_worker, jc.per_worker)
    assert (tc.global_cm, tc.idle, tc.events) == (jc.global_cm, jc.idle,
                                                  jc.events)


@pytest.mark.parametrize("backend,reference", [("vector", "vector"),
                                               ("fused", "pallas"),
                                               ("pallas", "pallas")])
@pytest.mark.parametrize("seed", [0, 3])
def test_device_backends_match_reference_on_cpu(backend, reference, seed):
    jlog, tlog = _logs(seed, num_workers=8, slices=40)
    a = J.compute(jlog, backend=reference)
    b = cmetric.compute(tlog, backend=backend, device="cpu")
    assert a.num_slices == b.num_slices
    np.testing.assert_allclose(b.per_worker, a.per_worker, rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(b.table.cm, a.table.cm, rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(b.table.worker, a.table.worker)
    np.testing.assert_array_equal(b.table.n_at_exit, a.table.n_at_exit)
    np.testing.assert_allclose(b.idle_time, a.idle_time, rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("backend", ["numpy", "vector", "fused"])
@pytest.mark.parametrize("splits", [[1, 2, 3, 10_000], [97, 10_000],
                                    [500, 500, 10_000]])
def test_chunked_equals_whole_log(backend, splits):
    _, tlog = _logs(11, num_workers=5, slices=50)
    whole = cmetric.compute_numpy(tlog)
    carry = cmetric.FoldCarry.init(tlog.num_workers)
    parts = []
    lo = 0
    with use_device("cpu"):
        for s in splits:
            hi = min(lo + s, len(tlog))
            carry, tbl = cmetric.fold_chunk(carry, tlog.chunk(lo, hi),
                                            backend=backend)
            parts.append(tbl)
            lo = hi
    table = SliceTable.concat(parts)
    assert len(table) == whole.num_slices == carry.slices
    if backend == "numpy":
        np.testing.assert_array_equal(carry.per_worker, whole.per_worker)
        _assert_tables_equal(table, whole.table)
    else:
        np.testing.assert_allclose(carry.per_worker, whole.per_worker,
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(table.cm, whole.table.cm, rtol=1e-4,
                                   atol=1e-6)
        np.testing.assert_array_equal(table.end_ns, whole.table.end_ns)


def test_registry_defaults_and_aliases():
    assert set(backends.available_backends()) == {"numpy", "vector", "fused",
                                                  "pallas"}
    fused, alias = backends.get_backend("fused"), backends.get_backend(
        "pallas")
    assert fused.capabilities == alias.capabilities == {
        "device", "parallel", "fused", "gpu"}
    assert fused.fn is alias.fn and alias.chunk_fn is not None
    assert "stream" not in backends.available_backends()
    import inspect
    assert inspect.signature(cmetric.compute).parameters[
        "backend"].default == "fused"


def test_empty_log_on_every_backend():
    empty = cmetric.EventLog(np.zeros(0, np.int64), np.zeros(0, np.int32),
                             np.zeros(0, np.int8), np.zeros(0, np.int32),
                             np.zeros(0, np.int32), 3)
    for name in ("numpy", "vector", "fused"):
        res = cmetric.compute(empty, backend=name, device="cpu")
        assert res.num_slices == 0 and res.per_worker.shape == (3,)
