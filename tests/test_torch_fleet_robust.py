"""The port's ingest robustness and durability against the JAX package's.

The cases of ``tests/test_fleet_robust.py`` and
``tests/test_fleet_durable.py`` run through ``repro_torch.fleet``: read
deadlines, heartbeats, idle and ghost hosts, ``finish_host``, backoff,
overload shedding and pausing, the close barrier, producer and server
restarts, ``from_fleet_dir``, journal meta seeding and torn journals.
Where a case ends in a report, the same seeded capture (a fake clock)
runs through the reference too, and the two reports' ``export("json")``
are byte-equal; the port's report is also held against ``detect_offline``
over the durable stores, read by both packages.

Everything runs on ``device="cpu"`` with the float64 ``numpy`` fold
backend, the reference's default.  ``finish_host`` carries a test of its
own: the server's loop held back from a flushed chunk
(:func:`test_finish_host_waits_for_a_flushed_chunk_the_loop_has_not_taken`).
"""
import json
import os
import socket
import struct
import time
import types

import numpy as np
import pytest

import repro.core as J_core
import repro.fleet as J_fleet
import repro_torch.core as T_core
import repro_torch.fleet as T_fleet
from repro.fleet import wire as J_wire
from repro_torch.device import use_device
from repro_torch.fleet import transport as T_transport
from repro_torch.fleet import wire as T_wire
from tests.test_tracer import FakeClock

REF = types.SimpleNamespace(name="ref", core=J_core, fleet=J_fleet,
                            wire=J_wire)
PORT = types.SimpleNamespace(name="port", core=T_core, fleet=T_fleet,
                             wire=T_wire)


@pytest.fixture(autouse=True)
def _on_cpu():
    """Every port object built on the test's thread resolves to the CPU
    (``IngestServer``, ``FleetSource``, ``ProfileSession``)."""
    with use_device("cpu"):
        yield


def _session(pkg, src=None, **kw):
    """A session of ``pkg`` folding with the float64 ``numpy`` backend
    (the reference's default; the port's is ``fused``)."""
    if pkg is PORT:
        kw.setdefault("fold_backend", "numpy")
    return pkg.core.ProfileSession(src, **kw)


def _detect(pkg, src):
    kw = {"backend": "numpy"} if pkg is PORT else {}
    return pkg.core.detect_offline(src.full_log(), src.tags, src.stacks,
                                   n_min=1.0, **kw)


def _wait(cond, timeout=5.0):
    deadline = time.time() + timeout
    while not cond() and time.time() < deadline:
        time.sleep(0.01)
    assert cond()


def _stream_spans(s, w, clk, n, tag="x"):
    for _ in range(n):
        s.begin(w, tag)
        clk.advance(1000)
        s.end(w)
        clk.advance(500)


def _ranked(rep):
    return [(rep.path_str(p), p.cmetric, p.slices) for p in rep.paths]


def _export(pkg, rep):
    return pkg.core.export(rep, "json")


def _both(case, *args):
    """``case`` run on the reference then on the port; their reports'
    JSON must be byte-equal.  Returns the port's result."""
    ref = case(REF, *args)
    port = case(PORT, *args)
    assert _export(PORT, port[0]) == _export(REF, ref[0])
    return port


# ---------------------------------------------------------------------------
# deadline honoring
# ---------------------------------------------------------------------------

def test_wait_idle_returns_false_on_deadline_not_hangs():
    server = T_fleet.IngestServer()
    server.start()
    clk = FakeClock()
    s = _session(PORT, n_min=1.0, clock=clk, drain_interval=0.001)
    w = s.register_worker("w")
    sink = T_fleet.attach_remote(s, server.address, host_id="h",
                                 clock_offset_ns=0, heartbeat_interval=None)
    try:
        _stream_spans(s, w, clk, 5)
        s.snapshot()
        assert sink.flush(5.0)
        t0 = time.monotonic()
        assert server.wait_idle(0.3) is False
        assert time.monotonic() - t0 < 2.0
    finally:
        s.close()
        sink.close()
        server.close()


def test_flush_returns_false_against_unreachable_server():
    probe = T_fleet.IngestServer()
    addr = probe.address
    probe.close()
    sink = T_fleet.RemoteSink(addr, "h", num_workers=1, worker_names=["w"],
                              clock_offset_ns=0, reconnect_delay=0.01,
                              backoff_max=0.05, max_reconnects=1 << 30,
                              heartbeat_interval=None)
    sink.start()
    try:
        sink.append_columns(np.array([1], np.int64), np.zeros(1, np.int32),
                            np.ones(1, np.int8), np.zeros(1, np.int32),
                            np.full(1, -1, np.int32))
        t0 = time.monotonic()
        assert sink.flush(0.5) is False
        assert time.monotonic() - t0 < 3.0
    finally:
        sink.abort()


def test_read_deadline_reclaims_silent_connection():
    server = T_fleet.IngestServer(read_deadline=0.2, idle_release=None)
    server.start()
    raw = socket.create_connection(server.address)
    try:
        f = raw.makefile("rwb")
        f.write(T_wire.encode_hello("frozen", 1, ["w"], t_client_ns=0,
                                    clock_offset_ns=0))
        f.flush()
        assert T_wire.read_frame(f)[0] == T_wire.WELCOME
        t0 = time.monotonic()
        assert server.wait_idle(0.5) is False
        assert time.monotonic() - t0 < 2.0
        _wait(lambda: server.stats()["deadline_closed"] >= 1)
        _wait(lambda: server.stats()["open_connections"] == 0)
    finally:
        raw.close()
        server.close()


# ---------------------------------------------------------------------------
# heartbeats and idle hosts
# ---------------------------------------------------------------------------

def test_heartbeat_keeps_idle_connection_alive():
    server = T_fleet.IngestServer(read_deadline=0.3, idle_release=None)
    server.start()
    clk = FakeClock()
    s = _session(PORT, n_min=1.0, clock=clk, drain_interval=0.001)
    w = s.register_worker("w")
    sink = T_fleet.attach_remote(s, server.address, host_id="h",
                                 clock_offset_ns=0, heartbeat_interval=0.05)
    try:
        _stream_spans(s, w, clk, 3)
        s.snapshot()
        assert sink.flush(5.0)
        time.sleep(1.0)                 # >3x the read deadline, zero data
        st = server.stats()
        assert st["open_connections"] == 1, st
        assert st["deadline_closed"] == 0, st
        assert st["heartbeats"] >= 3, st
        assert sink.heartbeats_sent >= 3
    finally:
        s.close()
        sink.close()
        server.close()


def _ghost_host(pkg, tmp_path):
    fleet_dir = str(tmp_path / pkg.name)
    server = pkg.fleet.IngestServer(fleet_dir=fleet_dir, read_deadline=None,
                                    idle_release=0.15)
    server.start()
    fleet_sess = _session(pkg, server.source, n_min=1.0)
    fleet_sess.start()
    ghost = pkg.fleet.RemoteSink(server.address, "ghost", num_workers=1,
                                 worker_names=["g0"], clock_offset_ns=0,
                                 heartbeat_interval=None)
    ghost.start()
    clk = FakeClock()
    s = _session(pkg, n_min=1.0, clock=clk, drain_interval=0.001)
    w = s.register_worker("w")
    sink = pkg.fleet.attach_remote(s, server.address, host_id="h",
                                   clock_offset_ns=0, heartbeat_interval=None)
    try:
        _wait(lambda: server.stats()["hosts"] == 2)
        _stream_spans(s, w, clk, 10)
        s.snapshot()
        assert sink.flush(5.0)
        _wait(lambda: server.stats()["idle_hosts"] >= 1)
        _wait(lambda: fleet_sess.stats()["events_folded"] >= 20)
        s.result()
        sink.close()
        rep = fleet_sess.result()
    finally:
        fleet_sess.stop()
        ghost.abort()
        server.close()
    return rep, server.stats(), fleet_dir


def test_silent_host_released_from_watermark_and_leaves_no_journal(tmp_path):
    rep, st, fleet_dir = _both(_ghost_host, tmp_path)
    assert rep.total_slices == 10
    assert st["idle_released"] >= 1, st
    names = os.listdir(fleet_dir)
    assert not any(n.startswith("ghost") for n in names), names
    src = T_fleet.FleetSource.from_fleet_dir(fleet_dir)
    assert [h.host_id for h in src.hosts] == ["h"]
    assert len(src.full_log()) == 20


def test_dataless_heartbeat_does_not_pin_watermark():
    server = T_fleet.IngestServer(read_deadline=None, idle_release=None)
    server.start()
    fleet_sess = _session(PORT, server.source, n_min=1.0)
    fleet_sess.start()
    idle = T_fleet.RemoteSink(server.address, "idle", num_workers=1,
                              worker_names=["i0"], clock_offset_ns=0,
                              heartbeat_interval=0.05)
    idle.start()
    clk = FakeClock()
    s = _session(PORT, n_min=1.0, clock=clk, drain_interval=0.001)
    w = s.register_worker("w")
    sink = T_fleet.attach_remote(s, server.address, host_id="h",
                                 clock_offset_ns=0, heartbeat_interval=None)
    try:
        _wait(lambda: server.stats()["hosts"] == 2)
        _stream_spans(s, w, clk, 10)
        s.snapshot()
        assert sink.flush(5.0)
        _wait(lambda: server.stats()["idle_hosts"] >= 1)
        _wait(lambda: fleet_sess.stats()["events_folded"] >= 10)
    finally:
        s.close()
        sink.close()
        idle.abort()
        fleet_sess.stop()
        server.close()


# ---------------------------------------------------------------------------
# finish_host
# ---------------------------------------------------------------------------

def _finish_host(pkg):
    server = pkg.fleet.IngestServer()
    server.start()
    clk = FakeClock()
    s = _session(pkg, n_min=1.0, clock=clk, drain_interval=0.001)
    w = s.register_worker("w")
    sink = pkg.fleet.attach_remote(s, server.address, host_id="h",
                                   clock_offset_ns=0, heartbeat_interval=None)
    try:
        _stream_spans(s, w, clk, 5)
        s.snapshot()
        assert sink.flush(5.0)
        assert server.finish_host("h") is True
        assert server.finish_host("h") is True      # idempotent
        assert server.finish_host("nope") is False
        rep = _session(pkg, server.source, n_min=1.0).result()
    finally:
        s.close()
        sink.abort()
        server.close()
    return rep


def test_finish_host_idempotent_and_unknown_false():
    rep = _finish_host(PORT)
    assert rep.total_slices == 5                # finished, data intact
    assert _export(PORT, rep) == _export(REF, _host_said_bye(REF))


def _host_said_bye(pkg):
    """The report of ``_finish_host``'s capture when the host ends it
    with BYE (the reference's own ``finish_host`` flow races, see the
    next test)."""
    server = pkg.fleet.IngestServer()
    server.start()
    clk = FakeClock()
    s = _session(pkg, n_min=1.0, clock=clk, drain_interval=0.001)
    w = s.register_worker("w")
    sink = pkg.fleet.attach_remote(s, server.address, host_id="h",
                                   clock_offset_ns=0, heartbeat_interval=None)
    try:
        _stream_spans(s, w, clk, 5)
        s.result()
        sink.close()
        assert server.wait_idle(10), server.stats()
        return _session(pkg, server.source, n_min=1.0).result()
    finally:
        server.close()


def test_finish_host_waits_for_a_flushed_chunk_the_loop_has_not_taken(
        monkeypatch):
    """``RemoteSink.flush`` returns once a chunk's bytes are in the
    socket; the server's loop pushes them into the host's stream later.
    A ``finish_host`` in between must not retire the stream first: here
    the loop is held back 0.3 s on every chunk, and the report must still
    hold all five slices (it held none before the repair)."""
    real = T_transport.IngestServer._on_chunk

    def slow(self, *args):
        time.sleep(0.3)
        return real(self, *args)

    monkeypatch.setattr(T_transport.IngestServer, "_on_chunk", slow)
    rep = _finish_host(PORT)
    assert rep.total_slices == 5


def test_backoff_full_jitter_bounded_and_seeded(monkeypatch):
    def schedule():
        slept = []
        monkeypatch.setattr(T_transport.time, "sleep",
                            lambda s: slept.append(s))
        sink = T_fleet.RemoteSink(("127.0.0.1", 1), "h",
                                  reconnect_delay=0.05, backoff_max=0.4,
                                  backoff_seed=42)
        for a in range(12):
            sink._backoff(a)
        return slept

    slept = schedule()
    assert len(slept) == 12
    for a, d in enumerate(slept):
        assert 0.0 <= d <= min(0.4, 0.05 * (1 << min(a, 16)))
    assert len(set(round(d, 12) for d in slept)) > 1
    assert schedule() == slept          # the same seed, the same schedule
    import repro.fleet.transport as J_transport
    ref = []
    monkeypatch.setattr(J_transport.time, "sleep", lambda s: ref.append(s))
    jsink = J_fleet.RemoteSink(("127.0.0.1", 1), "h", reconnect_delay=0.05,
                               backoff_max=0.4, backoff_seed=42)
    for a in range(12):
        jsink._backoff(a)
    assert ref == slept                 # and the reference's schedule


# ---------------------------------------------------------------------------
# overload: shedding with journals, pausing without
# ---------------------------------------------------------------------------

def _overload(pkg, tmp_path):
    fleet_dir = str(tmp_path / pkg.name / "fleet")
    journal = str(tmp_path / pkg.name / "h.journal")
    server = pkg.fleet.IngestServer(fleet_dir=fleet_dir, max_pending_rows=20,
                                    read_deadline=None, idle_release=None)
    server.start()                      # no session draining
    clk = FakeClock()
    s = _session(pkg, n_min=1.0, clock=clk, drain_interval=0.001)
    w = s.register_worker("w")
    sink = pkg.fleet.attach_remote(s, server.address, host_id="h",
                                   clock_offset_ns=0, journal=journal,
                                   heartbeat_interval=None)
    try:
        for _ in range(10):
            _stream_spans(s, w, clk, 5)
            s.snapshot()
        s.result()
        sink.close()
        assert server.wait_idle(10), server.stats()
        st = server.stats()
    finally:
        server.close()
    fleet = pkg.fleet.FleetSource.from_fleet_dir(fleet_dir)
    prod = pkg.fleet.FleetSource.from_producer_journals([journal])
    return _detect(pkg, fleet), st, fleet, prod


def test_overload_sheds_oldest_but_journals_recover(tmp_path):
    ra, st, fleet, prod = _both(_overload, tmp_path)
    assert st["shed_chunks"] > 0, st
    assert st["shed_rows"] >= st["shed_chunks"], st
    assert st["lost_chunks"] == 0, st
    assert st["rows_in"] == 100
    assert st["buffered_rows"] <= 20 + 10
    flog, plog = fleet.full_log(), prod.full_log()
    assert len(flog) == 100
    np.testing.assert_array_equal(flog.times, plog.times)
    rb = _detect(PORT, prod)
    np.testing.assert_array_equal(ra.per_worker, rb.per_worker)
    assert ra.total_slices == rb.total_slices == 50


def test_non_journaled_overload_pauses_reads_lossless():
    server = T_fleet.IngestServer(max_pending_rows=20, read_deadline=None,
                                  idle_release=None)
    server.start()
    clk = FakeClock()
    s = _session(PORT, n_min=1.0, clock=clk, drain_interval=0.001)
    w = s.register_worker("w")
    sink = T_fleet.attach_remote(s, server.address, host_id="h",
                                 clock_offset_ns=0, heartbeat_interval=None)
    try:
        for _ in range(8):
            _stream_spans(s, w, clk, 5)
            s.snapshot()
        _wait(lambda: server.stats()["buffered_rows"] >= 20)
        time.sleep(0.2)                 # reads paused: no shedding ever
        st = server.stats()
        assert st["shed_chunks"] == 0, st
        assert st["buffered_rows"] <= 30, st
        fleet_sess = _session(PORT, server.source, n_min=1.0)
        fleet_sess.start()
        s.result()
        sink.close()
        assert server.wait_idle(10), server.stats()
        rep = fleet_sess.result()
        fleet_sess.stop()
        assert server.stats()["rows_in"] == 80
        assert rep.total_slices == 40
    finally:
        s.close()
        server.close()


def test_close_delivery_barrier_replays_into_restarted_server(tmp_path):
    """The server dies with the producer's tail unread; ``close()``
    surfaces the loss and replays the journal into a restarted server.
    The durable stores it leaves are read by both packages."""
    fleet_dir = str(tmp_path / "fleet")
    server = T_fleet.IngestServer(fleet_dir=fleet_dir)
    addr = server.address
    server.start()
    clk = FakeClock()
    s = _session(PORT, n_min=1.0, clock=clk, drain_interval=0.001)
    w = s.register_worker("w")
    sink = T_fleet.attach_remote(s, addr, host_id="h", clock_offset_ns=0,
                                 journal=str(tmp_path / "h.journal"),
                                 reconnect_delay=0.01, backoff_max=0.05,
                                 max_reconnects=1 << 30,
                                 heartbeat_interval=None)
    server2 = None
    try:
        _stream_spans(s, w, clk, 5)
        s.snapshot()
        assert sink.flush(5.0)
        server.close()
        _stream_spans(s, w, clk, 5)
        s.snapshot()
        s.result()
        server2 = T_fleet.IngestServer(addr, fleet_dir=fleet_dir)
        server2.start()
        sink.close(timeout=10.0)
        assert not sink.failed, sink.last_error
        assert sink.stats()["pending"] == 0
        assert server2.wait_idle(10.0), server2.stats()
        assert server2.stats()["lost_chunks"] == 0, server2.stats()
    finally:
        s.close()
        sink.close()
        server.close()
        if server2 is not None:
            server2.close()
    reps = {pkg.name: _detect(pkg, pkg.fleet.FleetSource.from_fleet_dir(
        fleet_dir)) for pkg in (REF, PORT)}
    assert reps["port"].total_slices == 10      # nothing silently eaten
    assert _export(PORT, reps["port"]) == _export(REF, reps["ref"])


# ---------------------------------------------------------------------------
# durability: producer and server restarts (tests/test_fleet_durable.py)
# ---------------------------------------------------------------------------

def _fleet_equals_journals(rep, fleet_dir, n_min=1.0):
    """The live fleet report against ``detect_offline`` on the merged
    durable per-host stores, as the port and the reference read them."""
    for pkg in (PORT, REF):
        src = pkg.fleet.FleetSource.from_fleet_dir(fleet_dir)
        merged = src.full_log()
        kw = {"backend": "numpy"} if pkg is PORT else {}
        oracle = pkg.core.detect_offline(merged, src.tags, src.stacks,
                                         n_min=n_min, **kw)
        np.testing.assert_array_equal(rep.per_worker, oracle.per_worker)
        assert rep.total_slices == oracle.total_slices
        assert rep.total_critical == oracle.total_critical
        assert rep.idle_time == oracle.idle_time
        assert rep.total_time == oracle.total_time
        assert _ranked(rep) == _ranked(oracle)
    return merged


def _producer_restart(pkg, tmp_path):
    base = tmp_path / pkg.name
    journal = str(base / "hostA.journal")
    fleet_dir = str(base / "fleet")
    server = pkg.fleet.IngestServer(fleet_dir=fleet_dir)
    server.start()
    fleet_sess = _session(pkg, server.source, n_min=1.0)
    fleet_sess.start()
    instances = []
    try:
        for phase in range(2):
            clk = FakeClock()
            clk.t = phase * 10_000_000      # restart: the clock moves on
            s = _session(pkg, n_min=1.0, clock=clk, drain_interval=0.001)
            w = s.register_worker("w")
            sink = pkg.fleet.attach_remote(s, server.address,
                                           host_id="hostA",
                                           clock_offset_ns=0,
                                           journal=journal)
            instances.append(sink.instance)
            _stream_spans(s, w, clk, 50, tag="x")
            _stream_spans(s, w, clk, 20, tag=f"warm{phase}")
            s.result()
            sink.close()
            assert not sink.failed and sink.dropped_chunks == 0
        assert server.wait_idle(10), server.stats()
        rep = fleet_sess.result()
        st = server.stats()
    finally:
        fleet_sess.stop()
        server.close()
    return rep, st, instances, journal, fleet_dir


def test_producer_restart_resumes_capture_no_loss(tmp_path):
    rep, st, instances, journal, fleet_dir = _both(_producer_restart,
                                                   tmp_path)
    assert instances[0] == instances[1]     # the resumed capture nonce
    assert st["hosts"] == 1
    assert st["lost_chunks"] == 0 and st["duplicate_chunks"] == 0
    assert st["rows_in"] == 280
    assert rep.total_slices == 140
    merged = _fleet_equals_journals(rep, fleet_dir)
    back = T_core.SpillStore.open_readonly(journal).freeze(1)
    assert len(back) == 280
    np.testing.assert_array_equal(np.sort(back.times), merged.times)
    assert {"x", "warm0", "warm1"} <= set(rep.tag_names)


def _server_restart_ack0(pkg, tmp_path):
    journal = str(tmp_path / f"{pkg.name}.journal")
    server = pkg.fleet.IngestServer()
    server.start()
    addr = server.address
    clk = FakeClock()
    s = _session(pkg, n_min=1.0, clock=clk, drain_interval=0.001)
    w = s.register_worker("w")
    sink = pkg.fleet.attach_remote(s, addr, host_id="h", clock_offset_ns=0,
                                   journal=journal, reconnect_delay=0.01)
    try:
        _stream_spans(s, w, clk, 30)
        s.snapshot()
        assert sink.flush(5.0)
        _wait(lambda: server.source.stats()["rows_in"] == 60)
        server.close()                  # every byte of ingest state lost
        server = pkg.fleet.IngestServer(addr)
        server.start()
        _stream_spans(s, w, clk, 10)
        s.result()
        sink.close()
        assert not sink.failed, sink.last_error
        assert server.wait_idle(10), server.stats()
        st = server.stats()
        rep = _session(pkg, server.source, n_min=1.0).result()
    finally:
        server.close()
    return rep, st, sink.replayed_chunks


def test_server_restart_ack0_triggers_full_journal_replay(tmp_path):
    rep, st, replayed = _both(_server_restart_ack0, tmp_path)
    assert st["rows_in"] == 80, st      # replayed history + the new rows
    assert st["lost_chunks"] == 0 and st["duplicate_chunks"] == 0, st
    assert replayed > 0
    assert rep.total_slices == 40


def _fleet_dir_restart(pkg, tmp_path):
    base = tmp_path / pkg.name
    fleet_dir = str(base / "fleet")
    server = pkg.fleet.IngestServer(fleet_dir=fleet_dir)
    server.start()
    addr = server.address
    clk = FakeClock()
    s = _session(pkg, n_min=1.0, clock=clk, drain_interval=0.001)
    w = s.register_worker("w")
    sink = pkg.fleet.attach_remote(s, addr, host_id="h", clock_offset_ns=0,
                                   journal=str(base / "h.journal"),
                                   reconnect_delay=0.01)
    try:
        _stream_spans(s, w, clk, 40, tag="phase1")
        s.snapshot()
        assert sink.flush(5.0)
        _wait(lambda: server.stats()["rows_in"] == 80)
        server.close()
        server = pkg.fleet.IngestServer(addr, fleet_dir=fleet_dir)
        server.start()
        fleet_sess = _session(pkg, server.source, n_min=1.0)
        fleet_sess.start()
        _stream_spans(s, w, clk, 15, tag="phase2")
        s.result()
        sink.close()
        assert not sink.failed, sink.last_error
        assert server.wait_idle(10), server.stats()
        rep = fleet_sess.result()
        st = server.stats()
    finally:
        server.close()
    return rep, st, fleet_dir


def test_fleet_dir_server_restart_restores_floor_and_backfills(tmp_path):
    rep, st, fleet_dir = _both(_fleet_dir_restart, tmp_path)
    assert st["duplicate_chunks"] == 0 and st["lost_chunks"] == 0, st
    assert st["backfilled_rows"] == 80, st
    assert rep.total_slices == 55
    assert {"phase1", "phase2"} <= set(rep.tag_names)
    _fleet_equals_journals(rep, fleet_dir)


def _two_hosts(pkg, tmp_path):
    fleet_dir = str(tmp_path / pkg.name)
    server = pkg.fleet.IngestServer(fleet_dir=fleet_dir)
    server.start()
    fleet_sess = _session(pkg, server.source, n_min=2.0)
    fleet_sess.start()
    try:
        prods = []
        for hi in range(2):
            clk = FakeClock()
            clk.t = hi * 137
            s = _session(pkg, n_min=2.0, clock=clk, drain_interval=0.001)
            wids = [s.register_worker(f"t{i}") for i in range(2)]
            sink = pkg.fleet.attach_remote(s, server.address,
                                           host_id=f"host{hi}",
                                           clock_offset_ns=0)
            prods.append((s, wids, clk, sink))
            _wait(lambda hi=hi: server.stats()["hosts"] == hi + 1)
        for s, wids, clk, sink in prods:
            with s.running():
                for _ in range(100):
                    s.begin(wids[0], "step")
                    clk.advance(1000)
                    s.begin(wids[1], "io")
                    clk.advance(1000)
                    s.end(wids[1])
                    clk.advance(700)
                    s.end(wids[0])
                    clk.advance(300)
            s.result()
            sink.close()
        assert server.wait_idle(10), server.stats()
        rep = fleet_sess.result()
    finally:
        fleet_sess.stop()
        server.close()
    return rep, fleet_dir


def test_from_fleet_dir_matches_live_two_hosts(tmp_path):
    rep, fleet_dir = _both(_two_hosts, tmp_path)
    merged = _fleet_equals_journals(rep, fleet_dir, n_min=2.0)
    assert len(merged) == 800
    src = T_fleet.FleetSource.from_fleet_dir(fleet_dir)
    assert [h.host_id for h in src.hosts] == ["host0", "host1"]
    assert src.worker_hosts() == ["host0"] * 2 + ["host1"] * 2
    rep2 = _session(PORT, src, n_min=2.0).result()
    assert rep2.worker_hosts == rep.worker_hosts
    assert _ranked(rep2) == _ranked(rep)
    metas = sorted(f for f in os.listdir(fleet_dir)
                   if f.endswith(".meta.json"))
    assert len(metas) == 2
    with open(os.path.join(fleet_dir, metas[0])) as f:
        meta = json.load(f)
    assert meta["host_id"] in ("host0", "host1")
    assert meta["num_workers"] == 2
    assert meta["next_seq"] >= 1
    assert any(t and t[0] in ("step", "io") for t in meta["tags"])


def test_from_fleet_dir_missing_journal_raises(tmp_path):
    """A meta whose journal is gone fails loudly in both packages."""
    fleet_dir = tmp_path / "fleet"
    fleet_dir.mkdir()
    with open(fleet_dir / "h.meta.json", "w") as f:
        json.dump({"host_id": "h", "host_index": 0, "num_workers": 1,
                   "journal": "h.spill", "instance": "i"}, f)
    for pkg in (PORT, REF):
        with pytest.raises(FileNotFoundError):
            pkg.fleet.FleetSource.from_fleet_dir(str(fleet_dir))


def _seeding(pkg, tmp_path):
    from importlib import import_module
    tracer = import_module(f"{pkg.core.__name__}.tracer")
    journal = str(tmp_path / f"{pkg.name}.journal")
    sink = pkg.fleet.RemoteSink(("127.0.0.1", 1), "h", journal=journal,
                                max_reconnects=0, connect_timeout=0.05)
    sink.close(timeout=0.1)
    with open(journal + ".meta.json") as f:
        meta = json.load(f)
    meta["tags"] = [["old_tag", "m:1"]]
    meta["instance"] = "prev-instance"
    with open(journal + ".meta.json", "w") as f:
        json.dump(meta, f)
    empty = tracer.TagRegistry()
    s2 = pkg.fleet.RemoteSink(("127.0.0.1", 1), "h", journal=journal,
                              tags=empty, stacks=tracer.StackRegistry(),
                              max_reconnects=0, connect_timeout=0.05)
    out = [s2.instance, list(empty.names)]
    s2.close(timeout=0.1)
    busy = tracer.TagRegistry()
    busy.intern("mine", "m:0")
    s3 = pkg.fleet.RemoteSink(("127.0.0.1", 1), "h", journal=journal,
                              tags=busy, stacks=tracer.StackRegistry(),
                              max_reconnects=0, connect_timeout=0.05)
    s3.close(timeout=0.1)
    return out + [list(busy.names)]


def test_journal_meta_seeds_only_empty_registries(tmp_path):
    """Resume seeding fills an empty tag registry from the meta and
    leaves a registry that already interned tags alone."""
    got = _seeding(PORT, tmp_path)
    assert got == ["prev-instance", ["old_tag"], ["mine"]]
    assert got == _seeding(REF, tmp_path)


def _fewer_workers(pkg, tmp_path):
    journal = str(tmp_path / f"{pkg.name}.journal")
    server = pkg.fleet.IngestServer()
    server.start()
    try:
        clk = FakeClock()
        s = _session(pkg, n_min=1.0, clock=clk, drain_interval=0.001)
        w0 = s.register_worker("a")
        w1 = s.register_worker("b")
        sink = pkg.fleet.attach_remote(s, server.address, host_id="h",
                                       clock_offset_ns=0, journal=journal)
        _stream_spans(s, w0, clk, 10)
        _stream_spans(s, w1, clk, 10)
        s.result()
        sink.close()
        server.close()
        # the server loses everything; phase 2 registers one worker
        server2 = pkg.fleet.IngestServer(server.address)
        server2.start()
        clk2 = FakeClock()
        clk2.t = 10_000_000
        s2 = _session(pkg, n_min=1.0, clock=clk2, drain_interval=0.001)
        v0 = s2.register_worker("a")
        sink2 = pkg.fleet.attach_remote(s2, server2.address, host_id="h",
                                        clock_offset_ns=0, journal=journal)
        _stream_spans(s2, v0, clk2, 5)
        s2.result()
        sink2.close()
        assert server2.wait_idle(10), server2.stats()
        st = server2.stats()
        host = server2.source.hosts[0]
        server = server2
        return [st["bad_rows"], st["rows_in"], host.num_workers,
                host.worker_names]
    finally:
        server.close()


def test_resume_with_fewer_workers_keeps_history(tmp_path):
    """A resumed incarnation with fewer workers HELLOs the union worker
    table from the meta, so the replayed rows of the missing worker are
    kept."""
    got = _fewer_workers(PORT, tmp_path)
    assert got == [0, 50, 2, ["a", "b"]]
    assert got == _fewer_workers(REF, tmp_path)


def _orphaned(pkg, tmp_path):
    base = tmp_path / pkg.name
    base.mkdir()
    journal = str(base / "o.journal")
    z = [np.asarray(a) for a in
         ([10, 20], np.zeros(2, np.int32), [1, -1],
          np.full(2, -1, np.int32), np.full(2, -1, np.int32))]
    sink = pkg.fleet.RemoteSink(("127.0.0.1", 1), "h", journal=journal,
                                max_reconnects=0, connect_timeout=0.05)
    sink.append_columns(*z)
    sink.close(timeout=0.2)
    assert os.path.getsize(journal) > 0
    os.remove(journal + ".meta.json")
    s2 = pkg.fleet.RemoteSink(("127.0.0.1", 1), "h", journal=journal,
                              max_reconnects=0, connect_timeout=0.05)
    orphans = [p for p in os.listdir(base) if ".orphaned" in p]
    out = [s2._next_seq, pkg.core.SpillStore.open_readonly(journal).blocks,
           len(orphans),
           pkg.core.SpillStore.open_readonly(str(base / orphans[0])).blocks]
    s2.close(timeout=0.2)
    return out


def test_orphaned_journal_without_meta_starts_clean(tmp_path):
    """Journal blocks with no meta are a dead capture: the sink starts
    clean and rotates the history aside, never destroying it."""
    got = _orphaned(PORT, tmp_path)
    assert got == [0, 0, 1, 1]
    assert got == _orphaned(REF, tmp_path)


def _seq_gap(pkg, tmp_path):
    fleet_dir = str(tmp_path / pkg.name)
    server = pkg.fleet.IngestServer(fleet_dir=fleet_dir)
    server.start()
    addr = server.address
    cols = (np.asarray([10, 20], np.int64), np.zeros(2, np.int32),
            np.asarray([1, -1], np.int8), np.full(2, -1, np.int32),
            np.full(2, -1, np.int32))
    try:
        sock = socket.create_connection(addr, timeout=5)
        f = sock.makefile("rwb")
        f.write(pkg.wire.encode_hello("gappy", 1, ["w0"], t_client_ns=0,
                                      clock_offset_ns=0, instance="inst-1"))
        f.flush()
        _, payload = pkg.wire.read_frame(f)
        epoch = pkg.wire.decode_json(payload)["epoch"]
        f.write(pkg.wire.encode_chunk(0, pkg.wire.MERGED_SHARD, epoch, 0,
                                      *cols))
        c2 = (np.asarray([30, 40], np.int64),) + cols[1:]
        f.write(pkg.wire.encode_chunk(0, pkg.wire.MERGED_SHARD, epoch, 3,
                                      *c2))     # seqs 1 and 2 never sent
        f.write(pkg.wire.encode_bye(rows_sent=4, chunks_sent=2))
        f.flush()
        _wait(lambda: server.stats()["lost_chunks"] == 2)
        f.close()
        sock.close()
        server.wait_idle(10)
        server.close()
        journals = {n: open(os.path.join(fleet_dir, n), "rb").read()
                    for n in sorted(os.listdir(fleet_dir))
                    if not n.endswith(".json")}
        # restart: the floor must be 4 (past the gap), not 2
        server = pkg.fleet.IngestServer(addr, fleet_dir=fleet_dir)
        server.start()
        sock = socket.create_connection(addr, timeout=5)
        f = sock.makefile("rwb")
        f.write(pkg.wire.encode_hello("gappy", 1, ["w0"], t_client_ns=0,
                                      clock_offset_ns=0, instance="inst-1"))
        f.flush()
        _, payload = pkg.wire.read_frame(f)
        welcome = pkg.wire.decode_json(payload)
        out = [welcome["ack_seq"], server.stats()["backfilled_rows"],
               journals]
        f.close()
        sock.close()
        return out
    finally:
        server.close()


def test_accepted_seq_gap_journals_filler_blocks(tmp_path):
    """An accepted gap journals empty filler blocks (block index == seq),
    so a restarted server's floor is past it; the backfill skips the
    fillers.  The journals are byte-equal to the reference server's."""
    ack, backfilled, journals = _seq_gap(PORT, tmp_path)
    assert ack == 4 and backfilled == 4
    assert [ack, backfilled, journals] == _seq_gap(REF, tmp_path)


def _v1_welcome(pkg):
    server = pkg.fleet.IngestServer()
    server.start()
    try:
        sock = socket.create_connection(server.address, timeout=5)
        f = sock.makefile("rwb")
        hello = {"magic": pkg.wire.MAGIC, "wire_version": 1,
                 "host_id": "old", "num_workers": 1, "worker_names": ["w0"],
                 "t_client_ns": 0, "clock_offset_ns": 0}
        payload = json.dumps(hello).encode()
        f.write(struct.pack("<BBHI", pkg.wire.HELLO, 0, 1, len(payload))
                + payload)
        f.flush()
        hdr = f.read(8)
        kind, flags, version, length = struct.unpack("<BBHI", hdr)
        welcome = json.loads(f.read(length))
        f.close()
        sock.close()
        return [kind, flags, version, welcome]
    finally:
        server.close()


def test_v1_producer_handshake_gets_v1_welcome():
    kind, flags, version, welcome = _v1_welcome(PORT)
    assert kind == T_wire.WELCOME
    assert version == 1 and flags == 0  # a v1 decoder accepts it, raw
    assert welcome["codec"] == "raw"
    ref = _v1_welcome(REF)
    assert [kind, flags, version] == ref[:3]
    assert welcome.keys() == ref[3].keys()


def _torn_journal(pkg, tmp_path):
    journal = str(tmp_path / f"{pkg.name}.journal")
    z = [np.asarray(a) for a in
         ([10, 20], np.zeros(2, np.int32), [1, -1],
          np.full(2, -1, np.int32), np.full(2, -1, np.int32))]
    sink = pkg.fleet.RemoteSink(("127.0.0.1", 1), "h", journal=journal,
                                max_reconnects=0, connect_timeout=0.05)
    for k in range(4):
        sink.append_columns(np.asarray([10 + 100 * k, 20 + 100 * k],
                                       np.int64), *z[1:])
    out = [sink._next_seq]
    sink.close(timeout=0.2)
    with open(journal, "r+b") as f:
        f.truncate(os.path.getsize(journal) - 7)   # into the last payload
    server = pkg.fleet.IngestServer()
    server.start()
    try:
        s2 = pkg.fleet.RemoteSink(server.address, "h", num_workers=1,
                                  worker_names=["w0"], clock_offset_ns=0,
                                  journal=journal)
        out.append(s2._next_seq)            # the floor excludes the tear
        s2.start()                          # ack 0: replay all 3
        assert s2.flush(5.0)
        _wait(lambda: server.source.stats()["rows_in"] == 6)
        s2.append_columns(np.asarray([1000, 1100], np.int64), *z[1:])
        s2.close()
        assert server.wait_idle(10), server.stats()
        st = server.stats()
        return out + [st["rows_in"], st["lost_chunks"],
                      st["duplicate_chunks"]]
    finally:
        server.close()


def test_truncated_journal_replay_floor_survives(tmp_path):
    """A torn tail in the producer journal: the resumed sink's floor
    excludes the torn block and the server gets a gapless stream."""
    got = _torn_journal(PORT, tmp_path)
    assert got == [4, 3, 8, 0, 0]
    assert got == _torn_journal(REF, tmp_path)
