"""The port's live path (``ProfileSession``, ``SpillStore``, the ``Gapp``
wrappers) against the JAX package's, all on ``device="cpu"``.

On the float64 ``numpy`` fold backend the two packages run the same host
arithmetic, so snapshots, results and exports are compared byte for byte;
the port's default ``fused`` backend (its kernels' plain versions here) is
held to the reference's float32 tolerance, per-worker rtol 1e-4.  Also:
the device a session or tracer is built for holds on every thread that
drains it, and spill files cross between the packages both ways.
"""
import os
import pathlib
import subprocess
import sys
import threading
import warnings

import numpy as np
import pytest
import torch

import repro.core as J
from repro_torch import convert
from repro_torch import core as T
from tests.test_torch_detector import N_MIN, _carry_across, _jax_capture
from tests.test_tracer import FakeClock

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _carry_log(jlog):
    fields = {name: getattr(jlog, name) for name in (
        "times", "workers", "deltas", "tags", "stacks", "num_workers")}
    return convert.capture_from_numpy(fields, [], [], [])[0]


def _script(s, clk, snap_after):
    """Three workers on a fake clock: two run in parallel, one holds a
    serial section under two call paths; ``snap_after`` lists the event
    counts after which a snapshot is taken (the drain schedule).  Returns
    the JSON of every snapshot and of the final result."""
    w = [s.register_worker(f"w{i}") for i in range(3)]
    seen, snaps = 0, []

    def tick():
        nonlocal seen
        seen += 1
        if seen in snap_after:
            snaps.append(s.export("json"))

    for rep in range(12):
        for i in (0, 1):
            s.begin(w[i], "par")
            tick()
        clk.advance(2_000_000)
        for i in (0, 1):
            s.end(w[i])
            tick()
        s.begin(w[2], "io_phase")
        tick()
        s.push(w[2], "flush" if rep % 2 else "compress")
        clk.advance(5_000_000 + 1_000 * rep)
        s.pop(w[2])
        s.end(w[2])
        tick()
    rep = s.result()
    return snaps, s.export("json"), rep


@pytest.mark.parametrize("schedule", [(), (1, 2, 3, 50), tuple(range(1, 80, 7)),
                                      tuple(range(1, 200))],
                         ids=["final-only", "early", "every-7", "every-event"])
def test_live_snapshots_and_result_bit_equal_to_the_reference(schedule):
    cj, ct = FakeClock(), FakeClock()
    sj = J.ProfileSession(n_min=1.9, clock=cj)
    st = T.ProfileSession(n_min=1.9, clock=ct, fold_backend="numpy",
                          device="cpu")
    snaps_j, final_j, rep_j = _script(sj, cj, set(schedule))
    snaps_t, final_t, rep_t = _script(st, ct, set(schedule))
    assert len(snaps_t) == len(snaps_j) == len(
        [n for n in schedule if n <= 72])
    assert snaps_t == snaps_j
    assert final_t == final_j
    np.testing.assert_array_equal(rep_t.per_worker, rep_j.per_worker)
    assert rep_t.total_critical == 12
    assert rep_t.replay.device == torch.device("cpu")


def test_live_fused_session_matches_numpy_on_the_cpu():
    ca, cb = FakeClock(), FakeClock()
    a = T.ProfileSession(n_min=1.9, clock=ca, device="cpu")
    b = T.ProfileSession(n_min=1.9, clock=cb, fold_backend="numpy",
                         device="cpu")
    assert a.fold_backend == "fused" and a.device == torch.device("cpu")
    _, _, ra = _script(a, ca, {10, 40})
    _, _, rb = _script(b, cb, set())
    np.testing.assert_allclose(ra.per_worker, rb.per_worker, rtol=1e-4,
                               atol=1e-6)
    assert (ra.total_slices, ra.total_critical) == (rb.total_slices,
                                                    rb.total_critical)
    assert [p.stack for p in ra.paths] == [p.stack for p in rb.paths]


def test_device_follows_the_tracer_across_threads():
    """A fused tracer built for the CPU folds on the CPU when another
    thread drains it: the device is the object's, not the draining
    thread's context (which defaults to CUDA, absent here)."""
    clk = FakeClock()
    tr = T.Tracer(n_min=1.5, clock=clk, fold_backend="fused", device="cpu")
    w = [tr.register_worker(f"w{i}") for i in range(2)]
    for _ in range(20):
        tr.begin(w[0], "a")
        tr.begin(w[1], "b")
        clk.advance(1000)
        tr.end(w[1])
        clk.advance(500)
        tr.end(w[0])
    errors = []

    def drain():
        try:
            tr.sync()
        except Exception as e:      # noqa: BLE001 — reported below
            errors.append(e)

    th = threading.Thread(target=drain)
    th.start()
    th.join(timeout=30)
    assert not th.is_alive()
    assert errors == []
    snap = tr.snapshot()
    assert snap["total_slices"] == 40 and tr.ring.pending() == 0


def test_device_follows_the_session_to_its_worker_thread():
    """The session's background drain worker and a reader thread both
    fold on the session's device."""
    s = T.ProfileSession(n_min=None, dt=0.0005, device="cpu",
                         drain_interval=0.001)
    wids = [s.register_worker(f"t{i}") for i in range(3)]
    reads = []

    def work(wid):
        h = s.handle(wid)
        for i in range(300):
            with h.span(("step", "io")[i % 2]):
                pass

    def read():
        reads.append(s.snapshot().total_slices)

    with s.running():
        threads = [threading.Thread(target=work, args=(w,)) for w in wids]
        threads.append(threading.Thread(target=read))
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    rep = s.result()
    assert s.watch_errors == [] and len(reads) == 1
    assert rep.total_slices == 900
    oracle = T.detect_offline(s.freeze(), s.tags, s.stacks,
                              s._resolved_n_min(), backend="numpy",
                              worker_names=s.tracer.worker_names())
    np.testing.assert_allclose(rep.per_worker, oracle.per_worker, rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("chunk_events", [None, 101, 4096])
def test_offline_session_matches_detect_offline(chunk_events):
    jlog = J.synthetic_log(np.random.default_rng(4), 8, 60)
    log = _carry_log(jlog)
    tags, stacks = T.TagRegistry(), T.StackRegistry()
    sess = T.ProfileSession.offline(log, tags, stacks, n_min=4.0,
                                    backend="numpy",
                                    chunk_events=chunk_events, device="cpu")
    rep = sess.result()
    oracle = T.detect_offline(log, tags, stacks, 4.0, backend="numpy",
                              device="cpu")
    np.testing.assert_array_equal(rep.per_worker, oracle.per_worker)
    assert T.export(rep, "json") == T.export(oracle, "json")
    ref = J.ProfileSession.offline(jlog, J.TagRegistry(), J.StackRegistry(),
                                   n_min=4.0, chunk_events=chunk_events)
    ref.result()
    assert sess.export("json") == ref.export("json")
    fused = T.ProfileSession.offline(log, tags, stacks, n_min=4.0,
                                     chunk_events=chunk_events,
                                     device="cpu").result()
    np.testing.assert_allclose(fused.per_worker, oracle.per_worker,
                               rtol=1e-4, atol=1e-6)
    assert fused.total_slices == oracle.total_slices
    assert fused.replay.device == torch.device("cpu")


def test_offline_session_what_if_bit_equal_to_the_reference():
    """A tagged, sampled capture through an offline session on numpy: the
    report and a what-if on its top path's tag are byte-equal."""
    jcap = _jax_capture(7)
    log, tags, stacks, samples = _carry_across(*jcap)
    a = J.ProfileSession.offline(jcap[0], jcap[1], jcap[2], n_min=N_MIN,
                                 samples=jcap[3], chunk_events=97).result()
    b = T.ProfileSession.offline(log, tags, stacks, n_min=N_MIN,
                                 samples=samples, backend="numpy",
                                 chunk_events=97, device="cpu").result()
    assert T.export(b, "json") == J.export(a, "json")
    name = b.tag_names[b.paths[0].stack[-1]]
    assert b.what_if(name, shrink=0.5).to_json() == \
        a.what_if(name, shrink=0.5).to_json()


def _spill(pkg, path, log, chunk_events=64):
    st = pkg.SpillStore(str(path), chunk_events=chunk_events)
    st.append_columns(log.times, log.workers, log.deltas, log.tags,
                      log.stacks)
    st.close()


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_spill_files_cross_between_the_packages(tmp_path, writer):
    jlog = J.synthetic_log(np.random.default_rng(6), 5, 50)
    path = tmp_path / "capture.gappspill"
    _spill(J if writer == "reference" else T, path,
           jlog if writer == "reference" else _carry_log(jlog))
    a = J.ProfileSession(J.SpillSource(str(path), 5, chunk_events=37),
                         n_min=2.5).result()
    b = T.ProfileSession(T.SpillSource(str(path), 5, chunk_events=37),
                         n_min=2.5, fold_backend="numpy",
                         device="cpu").result()
    np.testing.assert_array_equal(b.per_worker, a.per_worker)
    assert T.export(b, "json") == J.export(a, "json")
    back = T.SpillStore.open_readonly(str(path)).freeze(5)
    for col in ("times", "workers", "deltas", "tags", "stacks"):
        np.testing.assert_array_equal(getattr(back, col),
                                      getattr(jlog, col), err_msg=col)


def test_stats_key_sets_equal_the_reference(tmp_path):
    cj, ct = FakeClock(), FakeClock()
    sj = J.ProfileSession(n_min=1.9, clock=cj)
    st = T.ProfileSession(n_min=1.9, clock=ct, device="cpu")
    _script(sj, cj, set())
    _script(st, ct, set())
    a, b = sj.stats(), st.stats()
    assert set(b) == set(a) and set(b["samples"]) == set(a["samples"])
    jlog = J.synthetic_log(np.random.default_rng(1), 3, 10)
    a = J.ProfileSession.offline(jlog, n_min=1.5)
    b = T.ProfileSession.offline(_carry_log(jlog), n_min=1.5, device="cpu")
    a.result()
    b.result()
    assert set(b.stats()) == set(a.stats())


def test_gapp_and_profile_log_wrappers(tmp_path):
    jlog = J.synthetic_log(np.random.default_rng(2), 4, 25)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        a = J.profile_log(jlog, J.TagRegistry(), J.StackRegistry(), 2.0)
        b = T.profile_log(_carry_log(jlog), T.TagRegistry(),
                          T.StackRegistry(), 2.0, backend="numpy",
                          device="cpu")
        g = T.Gapp(n_min=1.9, clock=FakeClock(), device="cpu")
    assert T.export(b, "json") == J.export(a, "json")
    assert g.session.device == torch.device("cpu")
    assert g.session.fold_backend == "fused"


def test_quickstart_example_runs_on_the_cpu():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.quickstart",
         "--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "pinpointed the serial section: write_output" in out.stdout
