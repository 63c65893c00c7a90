"""Continuous-profiling service: the fleet's live HTTP query surface.

:class:`ProfilerService` turns a running :class:`ProfileSession` (most
usefully one reading an :class:`~repro_torch.fleet.transport.IngestServer`'s
FleetSource) into an always-on observability endpoint — the "point a
browser at a running fleet" product shape over everything the durable
``fleet_dir`` already records:

* ``GET /``            — no-dependency HTML dashboard (inline JS);
* ``GET /api/report``  — the live snapshot as schema-versioned JSON,
  byte-identical to ``session.export("json")``;
* ``GET /api/top?n=&window=`` — ranked bottlenecks with deltas vs the
  previous poll; ``window=<seconds>`` answers from an incremental
  re-fold of only the journal blocks whose capture-time bounds intersect
  the window (the SpillStore block index — never a full history read);
* ``GET /api/whatif?tag=&shrink=`` — causal what-if: a counterfactual
  re-fold with the selected target's critical slices shrunk/removed
  (``host=`` / ``worker=`` / ``path=<rank>`` select too), byte-identical
  to ``report.what_if(...).to_json()`` on the same capture;
* ``GET /api/hosts`` / ``GET /api/hosts/<id>`` — per-host lanes from
  ``BottleneckReport.per_host()`` plus stream/journal/ingest health;
* ``GET /api/stream`` — chunked JSON-lines push of the same payload the
  ``watch`` exporter delivers (one builder: :mod:`repro_torch.obs.payload`);
* ``GET /metrics``     — Prometheus text exposition of the profiler's
  self-telemetry (fold rate, snapshot latency, queue depths, shed/lost/
  duplicate chunks, journal bytes).

Like the ingest side, the server is ONE selector thread — the handler
must never block on disk or the session's locks longer than a snapshot
takes, and the loop-blocking lint walks every handler from the
``# lint: event-loop`` root to keep it that way.  Retention is the one
deliberately-blocking job (segment unlinks are disk metadata I/O), so it
runs on its own sweeper thread, driven by :class:`RetentionPolicy`
against the same ``retain_blocks``/ack-floor pruning primitives the
journals already expose.

Wiring::

    server = IngestServer(fleet_dir="fleet/")          # producers connect
    sess = ProfileSession(server.source, n_min=2.0)
    sess.start()
    svc = sess.serve(("0.0.0.0", 9100), server=server,
                     retention=RetentionPolicy(max_age_s=3600))
    ...
    svc.close()

Offline, over a finished fleet_dir::

    svc = ProfilerService.from_fleet_dir("fleet/", ("127.0.0.1", 9100))
"""
from __future__ import annotations

import dataclasses
import glob as glob_lib
import json
import os
import selectors
import socket
import threading
import time

from repro_torch import device as device_lib
from repro_torch.core.report import path_entries
from repro_torch.core.session import ProfileSession
from repro_torch.core.spill import SpillStore
from repro_torch.fleet.aggregate import (FleetSource, fleet_dir_time_span,
                                   journal_on_disk, load_json)
from repro_torch.obs import http
from repro_torch.obs import payload as payload_lib
from repro_torch.obs import prom
from repro_torch.obs.dashboard import DASHBOARD_HTML

#: /api/top responses and /api/stream frames share the payload schema
#: version from :mod:`repro_torch.obs.payload`.
TOP_SCHEMA_VERSION = 1


@dataclasses.dataclass
class RetentionPolicy:
    """Wall-clock age budget driving journal pruning.

    Every ``sweep_interval_s`` the service walks the fleet journals and
    calls :meth:`SpillStore.prune_before_time` with ``newest event time −
    max_age_s`` — whole sealed segments older than the budget are
    deleted; the active file and any block inside the budget survive.

    ``respect_ack=False`` (the default here, unlike the SpillStore
    primitive) because the server-side ``fleet_dir`` journals have no
    acking consumer — the server IS the consumer; flip it on when
    pointing retention at producer journals, where the ack floor marks
    what the aggregator has durably received and an unacked block must
    outlive any age budget.

    ``keep_window_s`` additionally pins every block needed by windowed
    queries up to that span; the service also tracks the largest
    ``window=`` it has actually served and holds retention back by it,
    so an ``/api/top?window=600`` can never have its blocks pruned out
    from under a 300s age budget.
    """
    max_age_s: float
    sweep_interval_s: float = 5.0
    respect_ack: bool = False
    keep_window_s: float | None = None


class _HttpConn:
    """One HTTP connection's event-loop state (loop-thread-owned)."""

    __slots__ = ("sock", "rbuf", "wbuf", "mask", "closed", "last_rx",
                 "responded", "stream_every", "stream_top_n",
                 "stream_next")

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.rbuf = bytearray()
        self.wbuf = bytearray()
        self.mask = selectors.EVENT_READ
        self.closed = False
        self.last_rx = time.monotonic()
        self.responded = False          # a complete response is queued
        self.stream_every: float | None = None  # /api/stream cadence
        self.stream_top_n: int | None = None
        self.stream_next = 0.0

    def fileno(self) -> int:
        return self.sock.fileno()


class ProfilerService:
    """Single-thread selector HTTP server over a :class:`ProfileSession`.

    ``server=`` (an :class:`IngestServer`) unlocks ingest health in
    ``/api/hosts``//``/metrics`` and live journal access; ``fleet_dir=``
    (defaulted from the server's) unlocks time-windowed ``/api/top``
    queries and retention.  Constructing binds the socket (``address``
    is final immediately); :meth:`start` spins the loop.  ``device`` (by
    default the session's) is where the handlers' folds, snapshots and
    replays run; it is resolved here, so CUDA without a card raises.
    """

    #: Idle half-open connections (no complete request) are reaped after
    #: this many seconds.
    CONN_IDLE_S = 30.0

    def __init__(self, session: ProfileSession,
                 addr: tuple[str, int] = ("127.0.0.1", 0), *,
                 server=None, fleet_dir: str | None = None,
                 retention: "RetentionPolicy | float | None" = None,
                 top_n: int | None = None, backlog: int = 16,
                 device=None):
        self.session = session
        # every handler's folds, snapshots and replays run here, on the
        # loop thread as on the caller's (default: the session's device)
        self.device = device_lib.resolve(
            session.device if device is None else device)
        self.server = server
        if fleet_dir is None and server is not None:
            fleet_dir = server.fleet_dir
        self.fleet_dir = str(fleet_dir) if fleet_dir else None
        if isinstance(retention, (int, float)):
            retention = RetentionPolicy(max_age_s=float(retention))
        self.retention = retention
        self.top_n = int(top_n) if top_n is not None else session.top_n
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(tuple(addr))
        self._sock.listen(backlog)
        self._sock.setblocking(False)
        self.address: tuple[str, int] = self._sock.getsockname()[:2]
        self._loop_thread: threading.Thread | None = None
        self._ret_thread: threading.Thread | None = None
        self._sel: selectors.BaseSelector | None = None
        self._wake_r: socket.socket | None = None
        self._wake_w: socket.socket | None = None
        self._shutdown = threading.Event()
        self._conns: set[_HttpConn] = set()     # loop-thread-owned
        # previous /api/top answer per query key and the /metrics fold-
        # rate anchor: only the loop thread touches these
        self._prev_top: dict = {}               # loop-thread-owned
        self._rate_prev = (time.monotonic(), 0)  # loop-thread-owned
        # leaf lock for everything shared with stats()/close()/retention;
        # never held across a session or store call
        self._lock = threading.Lock()
        self._conn_socks: set = set()       # guarded-by: self._lock
        self._requests: dict = {}           # guarded-by: self._lock -- per-route counts
        self._connections = 0               # guarded-by: self._lock
        self._open_conns = 0                # guarded-by: self._lock
        self._http_errors = 0               # guarded-by: self._lock
        self._stream_clients = 0            # guarded-by: self._lock
        self._snap_count = 0                # guarded-by: self._lock
        self._snap_seconds_sum = 0.0        # guarded-by: self._lock
        self._snap_seconds_last = 0.0       # guarded-by: self._lock
        self._window_folds = 0              # guarded-by: self._lock
        self._window_fold_seconds_sum = 0.0  # guarded-by: self._lock
        self._whatif_folds = 0              # guarded-by: self._lock
        self._whatif_fold_seconds_sum = 0.0  # guarded-by: self._lock
        self._max_window_s = 0.0            # guarded-by: self._lock
        self._retention_pruned = 0          # guarded-by: self._lock
        self._retention_errors = 0          # guarded-by: self._lock

    # -- construction helpers ------------------------------------------------
    @classmethod
    def from_fleet_dir(cls, fleet_dir: str,
                       addr: tuple[str, int] = ("127.0.0.1", 0), *,
                       n_min: float | None = None,
                       fold_backend: str = "fused", device=None,
                       **kw) -> "ProfilerService":
        """Post-hoc browsing: fold a finished ``fleet_dir`` once (inline,
        before binding handlers) and serve the sealed report — every
        endpoint works, including windowed ``/api/top`` re-folds over the
        journal history."""
        src = FleetSource.from_fleet_dir(fleet_dir, device=device)
        sess = ProfileSession(src, n_min=n_min, fold_backend=fold_backend)
        sess.result()
        return cls(sess, addr, fleet_dir=fleet_dir, **kw)

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "ProfilerService":
        if self._loop_thread is None:
            self._sel = selectors.DefaultSelector()
            self._wake_r, self._wake_w = socket.socketpair()
            self._wake_r.setblocking(False)
            self._wake_w.setblocking(False)
            self._sel.register(self._sock, selectors.EVENT_READ, "accept")
            self._sel.register(self._wake_r, selectors.EVENT_READ, "wake")
            self._loop_thread = threading.Thread(
                target=self._loop, daemon=True, name="gapp-service")
            self._loop_thread.start()
            if self.retention is not None and self._ret_thread is None:
                self._ret_thread = threading.Thread(
                    target=self._retention_loop, daemon=True,
                    name="gapp-retention")
                self._ret_thread.start()
        return self

    def __enter__(self) -> "ProfilerService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def _wake(self) -> None:
        w = self._wake_w
        if w is not None:
            try:
                w.send(b"x")
            except OSError:
                pass

    def close(self) -> None:
        """Stop serving: join the loop + retention threads, close every
        socket.  The session is NOT touched — it outlives its service."""
        self._shutdown.set()
        self._wake()
        for t in (self._loop_thread, self._ret_thread):
            if t is not None:
                t.join(timeout=5.0)
        self._loop_thread = self._ret_thread = None
        try:
            self._sock.close()
        except OSError:
            pass
        with self._lock:
            socks = list(self._conn_socks)
        for s in socks:
            try:
                s.close()
            except OSError:
                pass
        if self._sel is not None:
            try:
                self._sel.close()
            except OSError:
                pass
            self._sel = None
        for w in (self._wake_r, self._wake_w):
            if w is not None:
                try:
                    w.close()
                except OSError:
                    pass
        self._wake_r = self._wake_w = None

    # -- observability -------------------------------------------------------
    def stats(self) -> dict:
        """Service self-telemetry.  Keys are pinned by
        the port's tests against the JAX package's (the ``/metrics`` names derive
        from them):

        * ``address`` — bound ``[host, port]``;
        * ``requests`` — per-route request counts (route label ->
          count);
        * ``connections`` / ``open_connections`` — accepted ever / now;
        * ``http_errors`` — 4xx/5xx responses sent;
        * ``stream_clients`` — currently-attached ``/api/stream``
          subscribers;
        * ``snapshot_count`` / ``snapshot_seconds_sum`` /
          ``snapshot_seconds_last`` — report-building latency (the
          ``/metrics`` "snapshot latency" series);
        * ``window_folds`` / ``window_fold_seconds_sum`` — windowed
          ``/api/top`` incremental re-folds;
        * ``whatif_folds`` / ``whatif_fold_seconds_sum`` —
          counterfactual ``/api/whatif`` re-folds;
        * ``max_window_s`` — largest window ever served (retention holds
          at least this much history);
        * ``retention_pruned_blocks`` / ``retention_errors`` — age-based
          pruning outcomes.
        """
        with self._lock:
            return {
                "address": list(self.address),
                "requests": dict(self._requests),
                "connections": self._connections,
                "open_connections": self._open_conns,
                "http_errors": self._http_errors,
                "stream_clients": self._stream_clients,
                "snapshot_count": self._snap_count,
                "snapshot_seconds_sum": self._snap_seconds_sum,
                "snapshot_seconds_last": self._snap_seconds_last,
                "window_folds": self._window_folds,
                "window_fold_seconds_sum": self._window_fold_seconds_sum,
                "whatif_folds": self._whatif_folds,
                "whatif_fold_seconds_sum": self._whatif_fold_seconds_sum,
                "max_window_s": self._max_window_s,
                "retention_pruned_blocks": self._retention_pruned,
                "retention_errors": self._retention_errors,
            }

    # -- event loop ----------------------------------------------------------
    def _loop(self) -> None:  # lint: event-loop
        """The selector loop: accept, read, route, write, stream sweep —
        one thread serves every client."""
        while not self._shutdown.is_set():
            try:
                events = self._sel.select(0.05)
            except OSError:
                return
            for key, mask in events:
                data = key.data
                if data == "accept":
                    self._do_accept()
                elif data == "wake":
                    try:
                        while self._wake_r.recv(4096):
                            pass
                    except (BlockingIOError, OSError):
                        pass
                else:
                    conn = data
                    if mask & selectors.EVENT_WRITE and not conn.closed:
                        self._flush_wbuf(conn)
                    if mask & selectors.EVENT_READ and not conn.closed:
                        self._do_read(conn)
            self._sweep(time.monotonic())

    def _do_accept(self) -> None:
        while True:
            try:
                s, _ = self._sock.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return
            s.setblocking(False)
            conn = _HttpConn(s)
            self._conns.add(conn)
            self._sel.register(s, selectors.EVENT_READ, conn)
            with self._lock:
                self._connections += 1
                self._open_conns += 1
                self._conn_socks.add(s)

    def _do_read(self, conn: _HttpConn) -> None:
        try:
            data = conn.sock.recv(1 << 16)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._close_conn(conn)
            return
        if not data:
            self._close_conn(conn)
            return
        conn.rbuf += data
        conn.last_rx = time.monotonic()
        if conn.responded:
            return                      # pipelined extras are ignored
        try:
            got = http.parse_request(bytes(conn.rbuf))
        except http.HttpError as e:
            self._count_error()
            self._respond(conn, http.error_response(e.status, e.message))
            return
        if got is None:
            return
        req, consumed = got
        del conn.rbuf[:consumed]
        self._dispatch(conn, req)

    def _dispatch(self, conn: _HttpConn, req: http.Request) -> None:
        label = self._route_label(req)
        with self._lock:
            self._requests[label] = self._requests.get(label, 0) + 1
        try:
            with device_lib.use_device(self.device):
                out = self._route(req)
        except http.HttpError as e:
            self._count_error()
            self._respond(conn, http.error_response(e.status, e.message))
            return
        except Exception as e:  # noqa: BLE001 — a handler bug must 500, not kill the loop
            self._count_error()
            self._respond(conn, http.error_response(
                500, f"{type(e).__name__}: {e}"))
            return
        if out == "stream":
            conn.stream_every = min(max(
                req.query_float("every", 0.5) or 0.5, 0.05), 60.0)
            conn.stream_top_n = req.query_int("n", self.top_n, lo=1,
                                              hi=1000)
            conn.stream_next = 0.0      # first frame on the next sweep
            with self._lock:
                self._stream_clients += 1
            self._send_conn(conn, http.stream_head())
        else:
            self._respond(conn, out)

    @staticmethod
    def _route_label(req: http.Request) -> str:
        path = req.path.rstrip("/") or "/"
        if path.startswith("/api/hosts/"):
            return "/api/hosts/<id>"
        if path in ("/", "/api/report", "/api/top", "/api/whatif",
                    "/api/hosts", "/api/stream", "/metrics"):
            return path
        return "<other>"

    def _route(self, req: http.Request):
        if req.method != "GET":
            raise http.HttpError(405, f"{req.method} not supported "
                                 "(GET-only service)")
        path = req.path.rstrip("/") or "/"
        if path == "/":
            return http.response(200, DASHBOARD_HTML,
                                 "text/html; charset=utf-8")
        if path == "/api/report":
            return http.response(200, self._report_json())
        if path == "/api/top":
            return http.json_response(200, self._top_doc(req))
        if path == "/api/whatif":
            return http.json_response(200, self._whatif_doc(req))
        if path == "/api/hosts":
            return http.json_response(200, self._hosts_doc())
        if path.startswith("/api/hosts/"):
            return http.json_response(
                200, self._host_doc(path[len("/api/hosts/"):]))
        if path == "/metrics":
            return http.response(
                200, self._metrics_text(),
                "text/plain; version=0.0.4; charset=utf-8")
        if path == "/api/stream":
            return "stream"
        raise http.HttpError(404, f"no route {req.path!r}")

    # -- write side ----------------------------------------------------------
    def _respond(self, conn: _HttpConn, data: bytes) -> None:
        conn.responded = True
        self._send_conn(conn, data)

    def _send_conn(self, conn: _HttpConn, data: bytes) -> None:
        conn.wbuf += data
        self._flush_wbuf(conn)

    def _flush_wbuf(self, conn: _HttpConn) -> None:
        if conn.wbuf and not conn.closed:
            try:
                n = conn.sock.send(conn.wbuf)
                del conn.wbuf[:n]
            except (BlockingIOError, InterruptedError):
                pass
            except OSError:
                self._close_conn(conn)
                return
        if not conn.wbuf and conn.responded \
                and conn.stream_every is None:
            self._close_conn(conn)      # Connection: close, drained
            return
        self._update_interest(conn)

    def _update_interest(self, conn: _HttpConn) -> None:
        if conn.closed:
            return
        mask = selectors.EVENT_READ     # always read: detect client EOF
        if conn.wbuf:
            mask |= selectors.EVENT_WRITE
        if mask == conn.mask:
            return
        try:
            self._sel.modify(conn.sock, mask, conn)
        except (KeyError, ValueError, OSError):
            self._close_conn(conn)
            return
        conn.mask = mask

    def _close_conn(self, conn: _HttpConn) -> None:
        if conn.closed:
            return
        conn.closed = True
        try:
            self._sel.unregister(conn.sock)
        except (KeyError, ValueError, OSError):
            pass
        conn.mask = 0
        try:
            conn.sock.close()
        except OSError:
            pass
        self._conns.discard(conn)
        with self._lock:
            self._open_conns -= 1
            self._conn_socks.discard(conn.sock)
            if conn.stream_every is not None:
                self._stream_clients -= 1

    def _sweep(self, now: float) -> None:
        """Per-iteration housekeeping: push due stream frames (one
        payload build per distinct ``n`` per tick, shared across
        subscribers) and reap idle half-open connections."""
        cache: dict = {}
        for conn in list(self._conns):
            if conn.closed:
                continue
            if conn.stream_every is not None:
                if now < conn.stream_next:
                    continue
                conn.stream_next = now + conn.stream_every
                key = conn.stream_top_n
                line = cache.get(key)
                if line is None:
                    try:
                        rep = self._snapshot_timed(key)
                        doc = payload_lib.build_watch_payload(
                            self.session, rep, key)
                        line = json.dumps(doc) + "\n"
                    except Exception:  # noqa: BLE001 — a bad tick skips a frame, not the client
                        line = ""
                    cache[key] = line
                if line:
                    self._send_conn(conn, http.chunk(line))
            elif not conn.responded \
                    and now - conn.last_rx > self.CONN_IDLE_S:
                self._close_conn(conn)

    def _count_error(self) -> None:
        with self._lock:
            self._http_errors += 1

    # -- report building -----------------------------------------------------
    def _snapshot_timed(self, top_n: int | None):
        t0 = time.perf_counter()
        with device_lib.use_device(self.device):
            rep = self.session.snapshot(top_n)
        dt = time.perf_counter() - t0
        with self._lock:
            self._snap_count += 1
            self._snap_seconds_sum += dt
            self._snap_seconds_last = dt
        return rep

    def _report_json(self) -> bytes:
        """The ``/api/report`` body — literally ``session.export("json")``
        (same exporter, same snapshot path), so byte-equality with the
        pull API is structural, not aspirational."""
        t0 = time.perf_counter()
        body = self.session.export("json").encode("utf-8")
        dt = time.perf_counter() - t0
        with self._lock:
            self._snap_count += 1
            self._snap_seconds_sum += dt
            self._snap_seconds_last = dt
        return body

    def _top_doc(self, req: http.Request) -> dict:
        n = req.query_int("n", self.top_n, lo=1, hi=1000)
        window_s = req.query_float("window")
        window_ns = None
        if window_s is None:
            key = "full"
            rep = self._snapshot_timed(n)
        else:
            if window_s <= 0:
                raise http.HttpError(400, "window must be > 0 seconds")
            if not self.fleet_dir:
                raise http.HttpError(
                    400, "window queries need durable journals "
                    "(IngestServer(fleet_dir=...) or from_fleet_dir)")
            key = f"w:{window_s:g}"
            span = fleet_dir_time_span(self.fleet_dir)
            if span is None:
                return {"schema_version": TOP_SCHEMA_VERSION, "n": n,
                        "window_s": window_s, "window_ns": None,
                        "baseline": False, "entries": []}
            hi = span[1]
            lo = hi - int(window_s * 1e9)
            window_ns = [lo, hi]
            with self._lock:
                self._max_window_s = max(self._max_window_s, window_s)
            rep = self._windowed_report(lo, hi, n)
        entries = path_entries(rep, n)
        prev = self._prev_top.get(key)
        for e in entries:
            got = prev.get(e["path"]) if prev else None
            e["delta_cmetric_s"] = (e["cmetric_s"] - got[0]
                                    if got else None)
            e["prev_rank"] = got[1] if got else None
        self._prev_top[key] = {e["path"]: (e["cmetric_s"], e["rank"])
                               for e in entries}
        return {"schema_version": TOP_SCHEMA_VERSION, "n": n,
                "window_s": window_s, "window_ns": window_ns,
                "baseline": prev is not None, "entries": entries}

    def _windowed_report(self, lo: int, hi: int, top_n: int):
        """Incremental re-fold of exactly the journal blocks intersecting
        ``[lo, hi]`` (fleet time): a fresh FleetSource over the fleet_dir
        with ``window_ns`` set folds through a throwaway offline session
        — same merge, same fold, same detector as the live path."""
        t0 = time.perf_counter()
        src = FleetSource.from_fleet_dir(
            self.fleet_dir, window_ns=(lo, hi),
            chunk_events=self.session.chunk_events, device=self.device)
        sub = ProfileSession(src, n_min=self.session._resolved_n_min(),
                             fold_backend=self.session.fold_backend,
                             top_n=top_n)
        rep = sub.result(top_n)
        dt = time.perf_counter() - t0
        with self._lock:
            self._window_folds += 1
            self._window_fold_seconds_sum += dt
        return rep

    def _whatif_doc(self, req: http.Request) -> dict:
        """``GET /api/whatif?tag=&shrink=`` (or ``host=`` / ``worker=`` /
        ``path=<rank>``): one counterfactual re-fold over the session's
        capture.  The body is exactly ``report.what_if(...).to_doc()``
        through the same ``json.dumps(doc, indent=2)`` as the offline
        ``to_json()``, so the wire bytes match an offline what-if on the
        same fleet_dir byte-for-byte."""
        shrink = req.query_float("shrink", 0.0)
        if shrink is None or not 0.0 <= shrink <= 1.0:
            raise http.HttpError(400, "shrink must be in [0, 1]")
        tag = req.query.get("tag")
        host = req.query.get("host")
        worker = req.query.get("worker")
        path_rank = req.query_int("path")
        if sum(v is not None for v in (tag, host, worker, path_rank)) != 1:
            raise http.HttpError(
                400, "select exactly one target: tag=, host=, worker= "
                "or path=<rank>")
        top_n = req.query_int("n", self.top_n, lo=1, hi=1000)
        rep = self._snapshot_timed(None)
        t0 = time.perf_counter()
        try:
            wi = rep.what_if(tag, shrink=shrink, host=host, worker=worker,
                             path=path_rank, top_n=top_n)
        except ValueError as e:
            raise http.HttpError(404, str(e)) from None
        except RuntimeError as e:
            raise http.HttpError(400, str(e)) from None
        dt = time.perf_counter() - t0
        with self._lock:
            self._whatif_folds += 1
            self._whatif_fold_seconds_sum += dt
        return wi.to_doc()

    def _hosts_doc(self) -> dict:
        rep = self._snapshot_timed(None)
        p = payload_lib.build_watch_payload(self.session, rep)
        doc = {
            "schema_version": payload_lib.PAYLOAD_SCHEMA_VERSION,
            "mode": p["mode"],
            "events_folded": p["events_folded"],
            "worker_hosts": p["worker_hosts"],
            "health": p["health"],
            "hosts": p["per_host"],
        }
        if self.server is not None:
            doc["ingest"] = self.server.stats()
        return doc

    def _host_doc(self, host_id: str) -> dict:
        rep = self._snapshot_timed(None)
        if not rep.worker_hosts:
            raise http.HttpError(
                404, "no host lanes (single-host session)")
        per = rep.per_host()
        if host_id not in per:
            raise http.HttpError(404, f"unknown host {host_id!r}")
        doc = {"schema_version": payload_lib.PAYLOAD_SCHEMA_VERSION,
               "host_id": host_id, **per[host_id]}
        doc["worker_lanes"] = [
            {"name": rep.worker_names[i],
             "cmetric_s": float(rep.per_worker[i])}
            for i, h in enumerate(rep.worker_hosts) if h == host_id
        ]
        src = self.session.source
        if isinstance(src, FleetSource):
            with src.cond:
                h = next((h for h in src.hosts
                          if h.host_id == host_id), None)
                if h is not None:
                    doc["stream"] = {
                        "rows_in": h.rows_in,
                        "chunks_in": h.chunks_in,
                        "buffered_rows": h.buffered_rows,
                        "finished": h.finished,
                        "idle_exempt": h.idle_exempt,
                        "clock_offset_ns": h.clock_offset_ns,
                        "last_seen_ns": h.last_seen_ns,
                    }
        store = self._journal_stores().get(host_id)
        if store is not None:
            tb = store.time_bounds()
            doc["journal"] = {
                "blocks": store.blocks,
                "first_block": store.first_block,
                "segments": store.segments,
                "rows_on_disk": store.rows_on_disk,
                "bytes": store.spilled_nbytes,
                "pruned_blocks": store.pruned_blocks,
                "time_bounds_ns": list(tb) if tb else None,
            }
        return doc

    def _metrics_text(self) -> str:
        samples: list = []
        svc = self.stats()
        svc.pop("address", None)
        for route, count in sorted(svc.pop("requests", {}).items()):
            samples.append(("gapp_service_requests", {"route": route},
                            float(count)))
        samples.extend(prom.flatten_stats("gapp_service", svc))
        st = self.session.stats()
        source = st.pop("source", None)
        sinks = st.pop("sinks", None)
        samples.extend(prom.flatten_stats("gapp_session", st))
        if isinstance(source, dict):
            samples.extend(prom.flatten_stats("gapp_fleet", source))
        for s in sinks or []:
            samples.extend(prom.flatten_stats(
                "gapp_sink", s, {"host": str(s.get("host_id", "?"))}))
        if self.server is not None:
            srv = self.server.stats()
            if isinstance(source, dict):
                for k in list(srv):
                    if k in source:
                        srv.pop(k)      # already exported as gapp_fleet_*
            samples.extend(prom.flatten_stats("gapp_ingest", srv))
        for hid, store in self._journal_stores().items():
            labels = {"host": hid}
            samples.append(("gapp_journal_bytes", labels,
                            float(store.spilled_nbytes)))
            samples.append(("gapp_journal_blocks", labels,
                            float(store.blocks)))
            samples.append(("gapp_journal_segments", labels,
                            float(store.segments)))
            samples.append(("gapp_journal_pruned_blocks", labels,
                            float(store.pruned_blocks)))
        # fold rate across scrapes (loop-thread-owned anchor)
        now = time.monotonic()
        folded = int(st.get("events_folded", 0))
        prev_t, prev_f = self._rate_prev
        rate = (folded - prev_f) / (now - prev_t) if now > prev_t else 0.0
        self._rate_prev = (now, folded)
        samples.append(("gapp_service_fold_events_per_s", None,
                        max(rate, 0.0)))
        return prom.render_metrics(samples, help_text={
            "gapp_service_fold_events_per_s":
                "events folded per second since the previous scrape",
            "gapp_service_snapshot_seconds_last":
                "latency of the most recent report snapshot",
            "gapp_journal_bytes":
                "durable journal bytes on disk per host",
        })

    # -- retention -----------------------------------------------------------
    def _journal_stores(self) -> dict:
        """host_id -> journal SpillStore: the live server's open journals
        when attached, else read-only opens over the fleet_dir."""
        if self.server is not None:
            return self.server.host_journals()
        if not self.fleet_dir:
            return {}
        out: dict = {}
        for mp in sorted(glob_lib.glob(os.path.join(self.fleet_dir,
                                                    "*.meta.json"))):
            m = load_json(mp)
            if not m or not m.get("journal"):
                continue
            jp = os.path.join(os.path.dirname(mp), m["journal"])
            if journal_on_disk(jp):
                out[str(m.get("host_id", mp))] = \
                    SpillStore.open_readonly(jp)
        return out

    def _retention_loop(self) -> None:
        interval = max(float(self.retention.sweep_interval_s), 0.05)
        while not self._shutdown.wait(interval):
            try:
                self.retention_sweep()
            except Exception:  # noqa: BLE001 — sweeper must survive transient fs races
                with self._lock:
                    self._retention_errors += 1

    def retention_sweep(self) -> int:
        """One retention pass (also callable directly, e.g. from tests or
        a cron shell): for every journal, prune sealed segments older
        than ``max_age_s`` — measured against that journal's NEWEST
        event, so a quiet fleet never prunes on wall-clock drift alone —
        while always keeping at least the largest query window served
        (and ``keep_window_s``).  Returns blocks pruned."""
        pol = self.retention
        if pol is None:
            return 0
        with self._lock:
            guard_s = max(self._max_window_s, pol.keep_window_s or 0.0)
        hold_ns = int(max(float(pol.max_age_s), guard_s) * 1e9)
        pruned = 0
        for store in self._journal_stores().values():
            tb = store.time_bounds()
            if tb is None:
                continue
            pruned += store.prune_before_time(
                tb[1] - hold_ns, respect_ack=pol.respect_ack)
        if pruned:
            with self._lock:
                self._retention_pruned += pruned
        return pruned
