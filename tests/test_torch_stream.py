"""The port's ``stream`` backend against the JAX package's.

The same numpy-seeded logs go through ``repro.core.cmetric.
compute_streaming`` (a ``lax.scan`` in float32, JAX on the CPU) and the
port's ``compute(log, backend="stream", device="cpu")``, whose
``stream_scan`` wrapper runs its plain version (float32 in event order,
on the host) for CPU tensors.  Tolerance: per-worker CMetric rtol 1e-4 / atol
1e-6, the reference's own bound for its device backends
(tests/test_cmetric.py), with the slice structure (count, workers,
n_at_exit, stacks) exact.  Both sides round every operation to float32 in
the same order, and on these logs they come out bit-equal: the tests
assert that too, and say so where it is asserted.
"""
import dataclasses

import numpy as np
import pytest

import repro.core as J
from repro.core import cmetric as J_cmetric
from repro_torch import convert
from repro_torch.core import backends, cmetric
from repro_torch.core.events import ACTIVATE, DEACTIVATE, NO_STACK, NO_TAG

COLUMNS = ("worker", "start_ns", "end_ns", "cm", "threads_av", "stack_id",
           "n_at_exit")


def _carry(jlog):
    fields = {f.name: getattr(jlog, f.name)
              for f in dataclasses.fields(jlog)}
    tlog, _, _, _ = convert.capture_from_numpy(fields, [], [], [])
    return tlog


def _fig1():
    """The paper's Figure-1 example (tests/test_cmetric.py)."""
    ev = [(0, 0, ACTIVATE), (2, 1, ACTIVATE), (4, 2, ACTIVATE),
          (8, 1, DEACTIVATE), (10, 0, DEACTIVATE), (12, 2, DEACTIVATE)]
    t, w, d = zip(*ev)
    return J.EventLog(
        times=(np.asarray(t, np.float64) * 1e9).astype(np.int64),
        workers=np.asarray(w, np.int32), deltas=np.asarray(d, np.int8),
        tags=np.full(6, NO_TAG, np.int32),
        stacks=np.full(6, NO_STACK, np.int32), num_workers=3)


def _logs():
    yield "fig1", _fig1()
    for seed in range(8):
        rng = np.random.default_rng(seed)
        yield f"seed{seed}", J.synthetic_log(
            rng, int(rng.integers(2, 12)), int(rng.integers(1, 40)))


LOGS = dict(_logs())


@pytest.mark.parametrize("name", sorted(LOGS))
def test_stream_matches_the_reference(name):
    jlog = LOGS[name].sanitize()
    a = J_cmetric.compute_streaming(jlog)
    b = cmetric.compute(_carry(jlog), backend="stream", device="cpu")
    np.testing.assert_allclose(b.per_worker, a.per_worker, rtol=1e-4,
                               atol=1e-6)
    assert b.num_slices == a.num_slices
    for col in ("worker", "n_at_exit", "stack_id"):
        np.testing.assert_array_equal(getattr(b.table, col),
                                      getattr(a.table, col), err_msg=col)
    # the same float32 operations in the same order: bit-equal here
    np.testing.assert_array_equal(b.per_worker, a.per_worker)
    for col in COLUMNS:
        np.testing.assert_array_equal(getattr(b.table, col),
                                      getattr(a.table, col), err_msg=col)
    assert (b.idle_time, b.total_time, b.t0_ns) == (a.idle_time,
                                                    a.total_time, a.t0_ns)


def test_stream_figure1_hand_values():
    res = cmetric.compute(_carry(_fig1()), backend="stream", device="cpu")
    np.testing.assert_allclose(
        res.per_worker, [2 + 1 + 4 / 3 + 1, 1 + 4 / 3, 4 / 3 + 1 + 2],
        rtol=1e-5)
    assert res.num_slices == 3 and res.idle_time == 0.0


@pytest.mark.parametrize("splits", [[1] * 7 + [10_000], [37, 1, 100, 10_000],
                                    [250, 250, 10_000]])
def test_stream_fold_chunk_bit_equal_after_any_partition(splits):
    jlog = J.synthetic_log(np.random.default_rng(5), 5, 40)
    tlog = _carry(jlog)
    jc = J.FoldCarry.init(jlog.num_workers)
    tc = cmetric.FoldCarry.init(tlog.num_workers)
    lo = 0
    for s in splits:
        hi = min(lo + s, len(jlog))
        jc, jt = J.fold_chunk(jc, jlog.chunk(lo, hi), backend="stream")
        tc, tt = cmetric.fold_chunk(tc, tlog.chunk(lo, hi), backend="stream")
        for col in COLUMNS:
            np.testing.assert_array_equal(getattr(tt, col), getattr(jt, col),
                                          err_msg=col)
        for f in dataclasses.fields(jc):
            np.testing.assert_array_equal(getattr(tc, f.name),
                                          getattr(jc, f.name),
                                          err_msg=f.name)
        lo = hi
    assert lo == len(jlog)


def test_stream_registered_with_the_reference_capabilities():
    import repro.core.backends as J_backends
    ours = backends.get_backend("stream")
    theirs = J_backends.get_backend("stream")
    assert ours.capabilities == theirs.capabilities == {
        "device", "sequential", "paper-faithful"}
    assert ours.chunk_fn is not None
    assert "stream" in backends.backends_with("sequential")


def test_stream_on_an_empty_log():
    empty = _carry(_fig1()).chunk(0, 0)
    res = cmetric.compute(empty, backend="stream", device="cpu")
    assert res.num_slices == 0 and res.per_worker.shape == (3,)


def test_stream_detect_offline_matches_the_reference():
    jlog = J.synthetic_log(np.random.default_rng(11), 6, 30)
    tags, stacks = J.TagRegistry(), J.StackRegistry()
    a = J.detect_offline(jlog, tags, stacks, 3.0, backend="stream")
    from repro_torch.core import StackRegistry, TagRegistry, detect_offline
    b = detect_offline(_carry(jlog), TagRegistry(), StackRegistry(), 3.0,
                       backend="stream", device="cpu")
    np.testing.assert_array_equal(b.per_worker, a.per_worker)
    assert (b.total_slices, b.total_critical) == (a.total_slices,
                                                  a.total_critical)


def _dirty(seed):
    """Columns of a log the sanitizer would reject: switch-outs with no
    switch-in, repeated switch-ins, zero deltas (switch-outs to the scan),
    equal times and counts that go negative."""
    rng = np.random.default_rng(seed)
    e, w = int(rng.integers(1, 300)), int(rng.integers(1, 9))
    t = np.sort(rng.integers(0, 50, e)).astype(np.float32) * np.float32(
        rng.choice([1e-3, 0.37, 1e3]))
    return (t.astype(np.float32), rng.integers(0, w, e).astype(np.int32),
            rng.choice([1, -1, 0], e).astype(np.int32), w)


@pytest.mark.parametrize("seed", range(8))
def test_stream_ref_matches_the_reference_scan_on_dirty_logs(seed):
    """The plain version (whole-array float32 operations) against the JAX
    package's ``lax.scan`` on the raw columns, bit for bit: the pairing of
    a switch-out with its worker's last switch-in, and the event-order
    float32 sums, hold on logs no sanitizer has touched."""
    import jax.numpy as jnp
    import torch

    from repro_torch.kernels import ref
    t, w, d, nw = _dirty(seed)
    cm_j, idle_j, outs = J_cmetric._streaming_scan(
        jnp.asarray(t), jnp.asarray(w), jnp.asarray(d), nw)
    is_out, *cols = (np.asarray(x) for x in outs)
    m = is_out.astype(bool)
    cm, idle, _, rows = ref.stream_ref(torch.from_numpy(t),
                                       torch.from_numpy(w),
                                       torch.from_numpy(d), nw)
    np.testing.assert_array_equal(cm.numpy(), np.asarray(cm_j))
    assert float(idle) == float(idle_j)
    names = ("worker", "start", "end", "cm", "threads_av", "n_at_exit")
    for name, got, want in zip(names, rows, cols):
        np.testing.assert_array_equal(got.numpy(), want[m], err_msg=name)


@pytest.mark.parametrize("bad_id", [-1, 3])
def test_stream_wrapper_rejects_worker_ids_outside_the_range(bad_id):
    """A worker id outside ``[0, num_workers)`` raises on the CPU as on
    the card, before any walk."""
    import torch

    from repro_torch.kernels import stream_scan as stream_k
    t = torch.arange(4, dtype=torch.float32)
    w = torch.tensor([0, 1, bad_id, 2], dtype=torch.int32)
    d = torch.tensor([1, 1, 1, -1], dtype=torch.int32)
    with pytest.raises(ValueError, match="worker ids"):
        stream_k.stream_scan(t, w, d, 3)
