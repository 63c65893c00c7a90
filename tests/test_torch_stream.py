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


# ---- the stream_scan pipeline's plain stages --------------------------------
# ``ref.stream_stages_ref`` composes the plain versions of the kernel's five
# launches (prepass, chain, pair, rows, cm) as the kernel composes them; it
# must equal ``ref.stream_ref`` and the JAX ``_streaming_scan`` bit for bit.

def _jax_scan(t, w, d, nw):
    """The JAX package's scan on raw columns: (cm, idle, row columns)."""
    import jax.numpy as jnp
    cm_j, idle_j, outs = J_cmetric._streaming_scan(
        jnp.asarray(t), jnp.asarray(w), jnp.asarray(d), nw)
    is_out, *cols = (np.asarray(x) for x in outs)
    m = is_out.astype(bool)
    return np.asarray(cm_j), float(idle_j), [c[m] for c in cols]


def _stages_equal_everywhere(t, w, d, nw):
    """The composed plain stages against stream_ref and the JAX scan, bit
    for bit; returns the stages' result."""
    import torch

    from repro_torch.kernels import ref
    args = (torch.from_numpy(t), torch.from_numpy(w), torch.from_numpy(d),
            nw)
    got, want = ref.stream_stages_ref(*args), ref.stream_ref(*args)
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    assert float(got[1]) == float(want[1])
    assert float(got[2]) == float(want[2])
    names = ("worker", "start", "end", "cm", "threads_av", "n_at_exit")
    for name, a, b in zip(names, got[3], want[3]):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=name)
    cm_j, idle_j, cols_j = _jax_scan(t, w, d, nw)
    np.testing.assert_array_equal(got[0].numpy(), cm_j)
    assert float(got[1]) == idle_j
    for name, a, b in zip(names, got[3], cols_j):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    return got


@pytest.mark.parametrize("seed", range(8))
def test_stream_stages_match_the_reference_scan_on_dirty_logs(seed):
    _stages_equal_everywhere(*_dirty(seed))


@pytest.mark.parametrize("num_workers", [1, 2, 5, 17, 64])
def test_stream_stages_match_the_reference_scan_on_sanitized_logs(
        num_workers):
    log = J.synthetic_log(np.random.default_rng(num_workers), num_workers,
                          int(200 // num_workers) + 3).sanitize()
    _stages_equal_everywhere(log.slice_seconds().astype(np.float32),
                             log.workers.astype(np.int32),
                             log.deltas.astype(np.int32), num_workers)


def _cols(events, dtype=np.float32):
    """(time, worker, delta) triples as the scan's columns."""
    t, w, d = zip(*events)
    return (np.asarray(t, dtype), np.asarray(w, np.int32),
            np.asarray(d, np.int32))


def test_stream_stages_zero_delta_is_a_switch_out():
    cm, _, _, rows = _stages_equal_everywhere(
        *_cols([(0, 0, 1), (2, 0, 0), (3, 1, 1), (5, 1, -1)]), 2)
    assert rows[0].tolist() == [0, 1] and cm.tolist() == [2.0, 2.0]


def test_stream_stages_negative_count_goes_to_idle():
    # two switch-outs first: the count before events 1-3 is -1, -2, -1
    cm, idle, _, rows = _stages_equal_everywhere(
        *_cols([(0, 0, -1), (1, 1, -1), (3, 0, 1), (7, 1, 1)]), 2)
    assert float(idle) == 7.0 and cm.tolist() == [0.0, 0.0]
    assert rows[5].tolist() == [0, -1]


def test_stream_stages_switch_out_without_switch_in_starts_at_zero():
    # worker 1 leaves at t = 4 without having come in: local 0, start 0;
    # the count is then 0, so the last 2 s are idle
    _, idle, _, rows = _stages_equal_everywhere(
        *_cols([(1, 0, 1), (4, 1, -1), (6, 0, -1)]), 2)
    worker, start, end, slice_cm = (r.tolist() for r in rows[:4])
    assert worker == [1, 0] and start == [0.0, 1.0] and end == [4.0, 6.0]
    assert slice_cm == [3.0, 3.0] and float(idle) == 2.0


def test_stream_stages_last_of_repeated_switch_ins_counts():
    # worker 0 comes in at 0 and again at 2 (the count is then 2, so the
    # last 3 s add 1.5); its slice starts at 2
    cm, _, _, rows = _stages_equal_everywhere(
        *_cols([(0, 0, 1), (2, 0, 1), (5, 0, -1)]), 1)
    assert rows[1].tolist() == [2.0] and cm.tolist() == [1.5]


def test_stream_stages_repeated_switch_outs_share_their_switch_in():
    # both switch-outs pair with the switch-in at 0 and both add to cm
    cm, _, _, rows = _stages_equal_everywhere(
        *_cols([(0, 0, 1), (2, 0, -1), (4, 0, -1)]), 1)
    assert rows[1].tolist() == [0.0, 0.0] and rows[3].tolist() == [2.0, 2.0]
    assert cm.tolist() == [4.0]


def test_stream_stages_one_event():
    for d in (1, -1):
        cm, idle, gcm, rows = _stages_equal_everywhere(
            *_cols([(3.5, 0, d)]), 2)
        assert cm.tolist() == [0.0, 0.0] and float(idle) == 0.0
        assert float(gcm) == 0.0 and rows[0].shape[0] == (d <= 0)
