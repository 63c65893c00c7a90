"""The port's fleet ingest and HTTP service against the JAX package's.

* Wire frames encode to the same bytes in both packages and decode in
  either.
* A reference ``RemoteSink`` feeds a port ``IngestServer`` and the
  reverse; the fleet report is byte-equal to the all-reference run.
* ``FleetSource.from_fleet_dir`` over a directory the reference's server
  wrote replays bit-equal.
* The port's ``/api/report`` and ``/api/whatif`` are byte-equal to its own
  ``export("json")`` and ``what_if(...).to_json()``.

Everything runs on ``device="cpu"``; the byte comparisons with the
reference use the float64 ``numpy`` fold backend, the service's the
port's default ``fused`` one.  Sockets bind ``("127.0.0.1", 0)``, every
wait has its own timeout, and waits are on conditions (``wait_idle``, the
source's condition variable), not sleeps.
"""
import io
import json
import types
import urllib.request

import numpy as np
import pytest
import torch

import repro.core as J_core
import repro.fleet as J_fleet
import repro_torch.core as T_core
import repro_torch.fleet as T_fleet
from repro.fleet import wire as J_wire
from repro_torch.fleet import wire as T_wire
from tests.test_stats_schema import (INGEST_SERVER_KEYS, REMOTE_SINK_KEYS,
                                     SERVICE_KEYS)
from tests.test_tracer import FakeClock

REF = types.SimpleNamespace(core=J_core, fleet=J_fleet, session_kw={},
                            device_kw={})
PORT = types.SimpleNamespace(core=T_core, fleet=T_fleet,
                             session_kw={"fold_backend": "numpy"},
                             device_kw={"device": "cpu"})
PKGS = {"ref": REF, "port": PORT}


def _wait_hosts(server, n, timeout=10.0):
    src = server.source
    with src.cond:
        assert src.cond.wait_for(lambda: len(src.hosts) >= n,
                                 timeout=timeout), len(src.hosts)


def _run_fleet(producer, consumer, fleet_dir=None, spans=60,
               consumer_kw=None):
    """Two producer hosts of package ``producer`` stream into an ingest
    server and fleet session of package ``consumer``.  Returns the sealed
    fleet session (the server is closed)."""
    kw = dict(consumer.session_kw if consumer_kw is None else consumer_kw)
    server = consumer.fleet.IngestServer(fleet_dir=fleet_dir,
                                         **consumer.device_kw)
    server.start()
    fleet = consumer.core.ProfileSession(server.source, n_min=2.0, **kw)
    fleet.start()
    try:
        prods = []
        for hi in range(2):
            clk = FakeClock()
            clk.t = hi * 137
            s = producer.core.ProfileSession(
                n_min=2.0, clock=clk, drain_interval=0.001,
                **producer.session_kw, **producer.device_kw)
            wids = [s.register_worker(f"t{i}") for i in range(2)]
            sink = producer.fleet.attach_remote(
                s, server.address, host_id=f"host{hi}", clock_offset_ns=0)
            prods.append((s, wids, clk, sink))
            _wait_hosts(server, hi + 1)     # pins the hosts' order
        for s, wids, clk, sink in prods:
            with s.running():
                for _ in range(spans):
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
            assert not sink.failed and sink.dropped_chunks == 0
            assert set(sink.stats()) == REMOTE_SINK_KEYS
        assert server.wait_idle(10), server.stats()
        fleet.result()
        assert set(server.stats()) == INGEST_SERVER_KEYS
        assert server.stats()["proto_errors"] == 0
    finally:
        fleet.stop()
        server.close()
    return fleet


@pytest.fixture(scope="module")
def reference_fleet(tmp_path_factory):
    """The all-reference run, with its durable fleet_dir."""
    d = str(tmp_path_factory.mktemp("ref_fleet") / "fleet")
    return _run_fleet(REF, REF, fleet_dir=d), d


# ---------------------------------------------------------------------------
# wire interop
# ---------------------------------------------------------------------------

def _frames(wire):
    rng = np.random.default_rng(0)
    n = 129
    cols = (rng.integers(0, 2**62, n).astype(np.int64),
            rng.integers(0, 64, n).astype(np.int32),
            rng.choice([-1, 1], n).astype(np.int8),
            rng.integers(-1, 100, n).astype(np.int32),
            rng.integers(-1, 50, n).astype(np.int32))
    return {
        "chunk-raw": wire.encode_chunk(3, wire.MERGED_SHARD, 7, 42, *cols),
        "chunk-zlib": wire.encode_chunk(1, 0, 2, 9, *cols, codec=wire.ZLIB),
        "hello": wire.encode_hello("h", 2, ["a", "b"], 123, None, "nonce"),
        "welcome": wire.encode_welcome(1, 2, -5, ack_seq=4,
                                       codec=wire.ZLIB, tags_seen=3),
        "heartbeat": wire.encode_heartbeat(77),
        "tags": wire.encode_tags([(0, "step", "app.py:1")]),
        "stacks": wire.encode_stacks([(0, (0, 1))]),
        "bye": wire.encode_bye(129, 1),
    }


@pytest.mark.parametrize("kind", sorted(_frames(J_wire)))
@pytest.mark.parametrize("writer,reader", [(J_wire, T_wire),
                                           (T_wire, J_wire)],
                         ids=["ref->port", "port->ref"])
def test_wire_frames_cross_both_ways(kind, writer, reader):
    raw = _frames(writer)[kind]
    assert raw == _frames(reader)[kind]           # the same bytes
    got_kind, payload = reader.read_frame(io.BytesIO(raw))
    want_kind, want_payload = writer.read_frame(io.BytesIO(raw))
    assert (got_kind, payload) == (want_kind, want_payload)
    if kind.startswith("chunk"):
        a, b = reader.decode_chunk(payload), writer.decode_chunk(payload)
        assert (a.host_index, a.shard_id, a.epoch, a.seq) == (
            b.host_index, b.shard_id, b.epoch, b.seq)
        for x, y in zip(a.columns, b.columns):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    else:
        assert reader.decode_json(payload) == writer.decode_json(payload)
    assert T_wire.COL_DTYPES == J_wire.COL_DTYPES


# ---------------------------------------------------------------------------
# sink -> server across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("producer,consumer", [("ref", "port"),
                                               ("port", "ref")],
                         ids=["ref-sinks->port-server",
                              "port-sinks->ref-server"])
def test_remote_sinks_feed_the_other_package_server(reference_fleet,
                                                    producer, consumer):
    ref_sess, _ = reference_fleet
    sess = _run_fleet(PKGS[producer], PKGS[consumer])
    assert sess.export("json") == ref_sess.export("json")
    np.testing.assert_array_equal(sess.snapshot().per_worker,
                                  ref_sess.snapshot().per_worker)
    assert sess.snapshot().worker_hosts == ["host0", "host0", "host1",
                                            "host1"]


def test_from_fleet_dir_written_by_the_reference(reference_fleet):
    ref_sess, fleet_dir = reference_fleet
    jsrc = J_fleet.FleetSource.from_fleet_dir(fleet_dir)
    tsrc = T_fleet.FleetSource.from_fleet_dir(fleet_dir, device="cpu")
    assert tsrc.device == torch.device("cpu")
    assert [h.host_id for h in tsrc.hosts] == [h.host_id for h in jsrc.hosts]
    a = J_core.ProfileSession(jsrc, n_min=2.0).result()
    sess = T_core.ProfileSession(tsrc, n_min=2.0, fold_backend="numpy")
    b = sess.result()
    assert sess.device == torch.device("cpu")
    np.testing.assert_array_equal(b.per_worker, a.per_worker)
    assert T_core.export(b, "json") == J_core.export(a, "json")
    assert sess.export("json") == ref_sess.export("json")
    jl = J_fleet.FleetSource.from_fleet_dir(fleet_dir).full_log()
    tl = T_fleet.FleetSource.from_fleet_dir(fleet_dir,
                                            device="cpu").full_log()
    for col in ("times", "workers", "deltas", "tags", "stacks"):
        np.testing.assert_array_equal(getattr(tl, col), getattr(jl, col),
                                      err_msg=col)


# ---------------------------------------------------------------------------
# the HTTP service
# ---------------------------------------------------------------------------

def _get(svc, path, timeout=10):
    url = "http://%s:%d%s" % (svc.address[0], svc.address[1], path)
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.read()


def test_service_report_and_whatif_byte_equal_to_the_exports(tmp_path):
    """The port end to end on its default fused backend (plain versions on
    the CPU): port sinks → port server with a fleet_dir → fleet session →
    ``serve()``; then the service over the fleet_dir answers what-ifs."""
    fleet_dir = str(tmp_path / "fleet")
    port_fused = types.SimpleNamespace(core=T_core, fleet=T_fleet,
                                       session_kw={},
                                       device_kw={"device": "cpu"})
    sess = _run_fleet(port_fused, port_fused, fleet_dir=fleet_dir,
                      consumer_kw={})
    assert sess.fold_backend == "fused"
    svc = sess.serve(server=None)
    try:
        assert svc.device == torch.device("cpu")
        status, body = _get(svc, "/api/report")
        assert status == 200
        assert body == sess.export("json").encode("utf-8")
        assert set(svc.stats()) == SERVICE_KEYS
    finally:
        svc.close()
    off = T_fleet.ProfilerService.from_fleet_dir(fleet_dir, n_min=2.0,
                                                 device="cpu").start()
    try:
        assert off.session.device == torch.device("cpu")
        status, body = _get(off, "/api/whatif?tag=io&shrink=0")
        assert status == 200
        status, report = _get(off, "/api/report")
    finally:
        off.close()
    offline = T_core.ProfileSession(
        T_fleet.FleetSource.from_fleet_dir(fleet_dir, device="cpu"),
        n_min=2.0).result()
    assert body == offline.what_if("io", shrink=0.0).to_json().encode(
        "utf-8")
    assert report == T_core.export(offline, "json").encode("utf-8")
    assert json.loads(body)["selection"]["kind"] == "tag"


def test_remote_exporter_attaches_a_port_sink():
    """``session.export("remote", ...)`` resolves through the lazy
    registry to the port's transport and attaches a working sink."""
    assert "subscription" in T_core.get_exporter("remote").capabilities
    server = T_fleet.IngestServer(device="cpu")
    server.start()
    try:
        clk = FakeClock()
        s = T_core.ProfileSession(n_min=1.0, clock=clk, device="cpu",
                                  drain_interval=0.001)
        w = s.register_worker("w")
        with pytest.raises(ValueError):
            s.export("remote")          # no addr
        sink = s.export("remote", addr=server.address, host_id="solo",
                        clock_offset_ns=0)
        assert isinstance(sink, T_fleet.RemoteSink) and sink in s.tracer.sinks
        for _ in range(20):
            s.begin(w, "x")
            clk.advance(1000)
            s.end(w)
            clk.advance(500)
        s.result()                      # close() flushes attached sinks
        sink.close()
        assert sink.rows_sent == 40
        assert server.wait_idle(10), server.stats()
        assert server.source.stats()["rows_in"] == 40
    finally:
        server.close()


def test_fleet_objects_need_a_card_unless_told_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        T_fleet.FleetSource()
    with pytest.raises(RuntimeError, match="CUDA"):
        T_fleet.IngestServer()
    sess = T_core.ProfileSession(T_fleet.FleetSource(device="cpu"),
                                 n_min=2.0)
    assert sess.device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        T_fleet.ProfilerService(sess, device="cuda")
    svc = T_fleet.ProfilerService(sess)
    try:
        assert svc.device == torch.device("cpu")
    finally:
        svc.close()
