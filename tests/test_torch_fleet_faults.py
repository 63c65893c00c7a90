"""The port's deterministic fault injection (``fleet.faults.FaultPlan``)
against the JAX package's.

The cases of ``tests/test_fleet_faults.py`` run through
``repro_torch.fleet``.  The rule semantics (no sockets) are compared with
the reference's plan on the same script: the bytes each wrapped stream
lets through, the schedules and the logged events.  The end-to-end
recovery contracts (a journaled producer streaming through a scripted
fault into a ``fleet_dir`` server) run in both packages on the same
fake-clock capture: the two fleet reports' ``export("json")`` are
byte-equal, the faults logged are the same, and the port's report equals
``detect_offline`` over the journals it left, as both packages read them.
Everything runs on ``device="cpu"`` with the ``numpy`` fold backend.
"""
import errno
import io
import time

import numpy as np
import pytest

import repro.fleet as J_fleet
import repro_torch.fleet as T_fleet
from repro_torch.device import use_device
from tests.test_torch_fleet_robust import (PORT, REF, _detect, _export,
                                           _ranked, _session, _stream_spans)
from tests.test_tracer import FakeClock


@pytest.fixture(autouse=True)
def _on_cpu():
    with use_device("cpu"):
        yield


def _kinds(plan):
    return [(h, k) for h, k, _ in plan.events]


# ---------------------------------------------------------------------------
# FaultPlan rule semantics (no sockets)
# ---------------------------------------------------------------------------

def _corrupt_and_drop(fleet):
    plan = fleet.FaultPlan(seed=7)
    plan.drop("h", frame=2).corrupt("h", frame=1, offset=2)
    raw = io.BytesIO()
    f = plan.wrap_producer("h", raw, conn=0)
    f.write(b"frame0-ok")
    f.write(b"frame1-corrupt-me")
    with pytest.raises(ConnectionResetError):
        f.write(b"frame2-dropped")
    return raw.getvalue(), plan.events


def test_rules_fire_on_exact_frames_and_log_events():
    data, events = _corrupt_and_drop(T_fleet)
    assert data.startswith(b"frame0-ok")
    orig = b"frame1-corrupt-me"
    got = data[len(b"frame0-ok"):]
    assert got[2] == orig[2] ^ 0xFF     # exactly byte 2 of frame 1
    assert got[:2] + got[3:] == orig[:2] + orig[3:]
    assert [(h, k) for h, k, _ in events] == [("h", "corrupt"),
                                              ("h", "drop")]
    assert (data, events) == _corrupt_and_drop(J_fleet)


def _truncated(fleet):
    plan = fleet.FaultPlan()
    plan.truncate("h", frame=1, keep=4)
    raw = io.BytesIO()
    f = plan.wrap_producer("h", raw)
    f.write(b"AAAA-first")
    with pytest.raises(ConnectionResetError):
        f.write(b"BBBBBBBB-second")
    return raw.getvalue(), plan.events


def test_truncate_writes_prefix_then_dies():
    data, events = _truncated(T_fleet)
    assert data == b"AAAA-firstBBBB"     # a torn frame on the wire
    assert (data, events) == _truncated(J_fleet)


def _dials(fleet):
    plan = fleet.FaultPlan()
    plan.refuse_connect("h", times=2)
    for _ in range(2):
        with pytest.raises(ConnectionRefusedError):
            plan.connect("h")
    return [plan.connect("h"), plan.connect("h"),
            plan.connect("other")], plan.events


def test_refuse_connect_budget_and_conn_indices():
    conns, events = _dials(T_fleet)
    assert conns == [0, 1, 0]           # first successful dial is conn 0,
    #                                     counted per host
    assert (conns, events) == _dials(J_fleet)


def _disk_full(pkg, path):
    plan = pkg.fleet.FaultPlan()
    plan.disk_full("h", at_block=2, failures=2)
    st = plan.wrap_journal("h", pkg.core.SpillStore(str(path)))
    cols = (np.array([1], np.int64), np.zeros(1, np.int32),
            np.ones(1, np.int8), np.zeros(1, np.int32),
            np.full(1, -1, np.int32))
    out = [st.append_block(*cols), st.append_block(*cols)]
    for _ in range(2):                  # a budget of 2 ENOSPC failures
        with pytest.raises(OSError) as ei:
            st.append_block(*cols)
        out.append(ei.value.errno)
    out.append(st.append_block(*cols))  # the disk "recovered"
    st.close()
    with open(path, "rb") as f:
        return out, plan.events, f.read()


def test_disk_full_triggers_at_block_then_recovers(tmp_path):
    got = _disk_full(PORT, tmp_path / "port.spill")
    assert got[0] == [0, 1, errno.ENOSPC, errno.ENOSPC, 2]
    assert got == _disk_full(REF, tmp_path / "ref.spill")


def _scheduled(fleet):
    plan = fleet.FaultPlan()
    plan.schedule("kill", [3, 5])
    fired = [step for step in range(8) if plan.due("kill", step)]
    return fired, plan.due("kill", 99), plan.events


def test_schedule_fires_each_threshold_once_in_order():
    fired, late, events = _scheduled(T_fleet)
    assert fired == [3, 5] and not late     # then exhausted
    assert (fired, late, events) == _scheduled(J_fleet)


def test_slow_applies_to_every_frame():
    plans = {}
    for name, fleet in (("ref", J_fleet), ("port", T_fleet)):
        plan = fleet.FaultPlan()
        plan.slow("h", per_frame=0.01)
        raw = io.BytesIO()
        f = plan.wrap_producer("h", raw)
        t0 = time.perf_counter()
        for _ in range(3):
            f.write(b"x")
        plans[name] = (time.perf_counter() - t0, raw.getvalue(), plan.events)
    assert plans["port"][0] >= 0.03
    assert plans["port"][1:] == plans["ref"][1:]


# ---------------------------------------------------------------------------
# end-to-end recovery contracts (real sockets, scripted faults)
# ---------------------------------------------------------------------------

def _faulted_capture(pkg, tmp_path, script, *, server_script=None,
                     rounds=6, spans=5, sink_kw=None):
    """One journaled producer of ``pkg`` streams ``rounds`` snapshot-
    bounded chunks through the plan ``script`` builds; returns (report,
    server stats, sink, fleet_dir, producer plan, server plan)."""
    base = tmp_path / pkg.name
    fleet_dir = str(base / "fleet")
    plan = script(pkg.fleet.FaultPlan())
    server_kw = {}
    server_plan = None
    if server_script is not None:
        server_plan = server_script(pkg.fleet.FaultPlan())
        server_kw["fault_plan"] = server_plan
    server = pkg.fleet.IngestServer(fleet_dir=fleet_dir, **server_kw)
    server.start()
    fleet_sess = _session(pkg, server.source, n_min=1.0)
    fleet_sess.start()
    clk = FakeClock()
    s = _session(pkg, n_min=1.0, clock=clk, drain_interval=0.001)
    w = s.register_worker("w")
    sink = pkg.fleet.attach_remote(s, server.address, host_id="h",
                                   clock_offset_ns=0,
                                   journal=str(base / "h.journal"),
                                   reconnect_delay=0.01,
                                   heartbeat_interval=None, fault_plan=plan,
                                   **(sink_kw or {}))
    try:
        for _ in range(rounds):
            _stream_spans(s, w, clk, spans)
            s.snapshot()                # a chunk boundary: fixed seqs
        s.result()
        sink.close()
        assert server.wait_idle(10), server.stats()
        rep = fleet_sess.result()
        st = server.stats()
    finally:
        fleet_sess.stop()
        server.close()
    return rep, st, sink, fleet_dir, plan, server_plan


def _recovered(tmp_path, script, **kw):
    """The capture in both packages: the reports byte-equal, the same
    faults logged, and the port's report equal to ``detect_offline`` over
    its journals, read by the port and by the reference."""
    ref = _faulted_capture(REF, tmp_path, script, **kw)
    port = _faulted_capture(PORT, tmp_path, script, **kw)
    rep, fleet_dir = port[0], port[3]
    assert _export(PORT, rep) == _export(REF, ref[0])
    for i in (4, 5):
        if port[i] is not None:
            assert _kinds(port[i]) == _kinds(ref[i])
    for pkg in (PORT, REF):
        oracle = _detect(pkg, pkg.fleet.FleetSource.from_fleet_dir(
            fleet_dir))
        np.testing.assert_array_equal(rep.per_worker, oracle.per_worker)
        assert rep.total_slices == oracle.total_slices
        assert _ranked(rep) == _ranked(oracle)
    return port


def test_connection_drop_replays_with_zero_loss(tmp_path):
    rep, st, sink, _, plan, _ = _recovered(
        tmp_path, lambda p: p.drop("h", frame=4, conn=0))
    assert ("h", "drop") in _kinds(plan)
    assert sink.reconnects >= 1
    assert not sink.failed, sink.last_error
    assert st["lost_chunks"] == 0, st
    assert st["rows_in"] == 60          # 6 rounds x 5 spans x 2 events
    assert rep.total_slices == 30


def test_corrupt_frame_is_detected_then_replayed(tmp_path):
    # the server rejects frame 3 and closes; a stall on frame 5 lets the
    # reset surface mid-stream instead of racing the BYE
    rep, st, _, _, plan, _ = _recovered(
        tmp_path, lambda p: p.corrupt("h", frame=3, conn=0).stall(
            "h", frame=5, seconds=0.3, conn=0))
    assert ("h", "corrupt") in _kinds(plan)
    assert st["proto_errors"] >= 1, st  # detected, not folded
    assert st["lost_chunks"] == 0, st
    assert rep.total_slices == 30


def test_truncated_frame_torn_on_wire_then_replayed(tmp_path):
    rep, st, _, _, plan, _ = _recovered(
        tmp_path, lambda p: p.truncate("h", frame=4, keep=6, conn=0))
    assert ("h", "truncate") in _kinds(plan)
    assert st["lost_chunks"] == 0, st
    assert st["duplicate_chunks"] == 0, st
    assert rep.total_slices == 30


def test_partition_drop_then_refuse_recovers(tmp_path):
    rep, st, sink, _, plan, _ = _recovered(
        tmp_path, lambda p: p.drop("h", frame=5, conn=0).refuse_connect(
            "h", times=3),
        sink_kw=dict(backoff_max=0.05, backoff_seed=1, max_reconnects=64))
    assert sum(1 for _, k in _kinds(plan) if k == "refuse") == 3
    assert not sink.failed
    assert st["lost_chunks"] == 0, st
    assert rep.total_slices == 30


def test_producer_disk_full_sheds_chunk_whole(tmp_path):
    """Producer journal ENOSPC: the chunk is dropped before it takes a
    seq, absent from the live fold and the journals alike."""
    rep, st, sink, _, _, _ = _recovered(
        tmp_path, lambda p: p.disk_full("h", at_block=2, failures=1))
    assert sink.journal_errors == 1
    assert sink.dropped_chunks == 1
    assert not sink.failed
    assert st["lost_chunks"] == 0, st   # dropped is not lost: no seq gap
    assert st["rows_in"] == 50          # one 10-row chunk shed
    assert rep.total_slices == 25


def test_server_disk_full_refuses_chunk_and_replay_recovers(tmp_path):
    """Server journal ENOSPC: the chunk is refused (no commit, the
    connection closed) and the reconnect's replay delivers it."""
    rep, st, _, _, _, server_plan = _recovered(
        tmp_path, lambda p: p.stall("h", frame=6, seconds=0.3, conn=0),
        server_script=lambda p: p.disk_full("h", at_block=2, failures=1))
    assert ("h", "disk_full") in _kinds(server_plan)
    assert st["journal_errors"] == 1, st
    assert st["lost_chunks"] == 0, st
    assert st["duplicate_chunks"] == 0, st
    assert st["rows_in"] == 60          # everything arrived in the end
    assert rep.total_slices == 30
