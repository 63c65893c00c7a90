"""Live dashboard quickstart: continuous profiling over HTTP.

A two-host fleet — one ingest server, two
producer "hosts", one of which serializes on a shared lock — but instead
of a one-shot text report the fleet session *serves* its state live:

    service = fleet.serve()         # ProfilerService on 127.0.0.1:<port>

While the workload streams in, the script queries the running service
the way a dashboard or ``curl`` would:

* ``GET /``                 no-dependency HTML dashboard (open in a browser);
* ``GET /api/report``       the full report, byte-equal to ``export("json")``;
* ``GET /api/top?n=3&window=0.5``  top bottlenecks over the last 0.5 s,
  re-folded incrementally from the durable fleet_dir journals;
* ``GET /api/hosts``        per-host drill-down + transport health;
* ``GET /metrics``          Prometheus text exposition for scraping.

Every session folds on the card (the ``fused`` backend) unless
``--device cpu`` asks for the kernels' plain PyTorch versions on the CPU.

Run:  PYTHONPATH=src python -m repro_torch.examples.fleet_dashboard [--device cpu]
"""
import argparse
import json
import tempfile
import threading
import time
import urllib.request

from repro_torch.core import ProfileSession
from repro_torch.fleet import IngestServer, attach_remote


def run_host(host_id: str, server_addr, serial: bool, device) -> None:
    s = ProfileSession(n_min=None, dt=0.001, device=device)
    lock = threading.Lock()
    wids = [s.register_worker(f"worker{i}") for i in range(4)]
    sink = attach_remote(s, server_addr, host_id=host_id, clock_offset_ns=0)

    def worker(i):
        for _ in range(8):
            with s.span(wids[i], "parallel_compute"):
                time.sleep(0.003)
            if serial and i == 0:
                with s.span(wids[i], "commit_txn"):
                    with lock:
                        time.sleep(0.010)

    with s.running():
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    s.result()
    sink.close()


def get(addr, path):
    with urllib.request.urlopen(
            f"http://{addr[0]}:{addr[1]}{path}", timeout=5) as r:
        return r.read()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the sessions fold (cuda or cpu)")
    args = ap.parse_args(argv)
    fleet_dir = tempfile.mkdtemp(prefix="gapp-dash-")
    # durable journals; a session over server.source folds on its device
    server = IngestServer(fleet_dir=fleet_dir, device=args.device)
    server.start()
    fleet = ProfileSession(server.source, n_min=2.0)
    fleet.start()
    service = fleet.serve(server=server)         # HTTP API, ephemeral port
    addr = service.address
    print(f"dashboard:  http://{addr[0]}:{addr[1]}/")
    print(f"fleet_dir:  {fleet_dir}\n")

    hosts = [threading.Thread(target=run_host,
                              args=(name, server.address, name == "db-1",
                                    args.device))
             for name in ("web-0", "db-1")]
    for t in hosts:
        t.start()
    for t in hosts:
        t.join()
    assert server.wait_idle(10.0), server.stats()

    # -- query the LIVE service, as a dashboard would -------------------
    report = json.loads(get(addr, "/api/report"))
    assert report == json.loads(fleet.export("json"))
    print(f"live report: {report['total_slices']} slices, "
          f"critical_ratio={report['critical_ratio']:.2f}, "
          f"hosts={sorted(report['per_host'])}")

    top = json.loads(get(addr, "/api/top?n=3&window=0.5"))
    print("top bottlenecks (last 0.5 s of fleet time):")
    for e in top["entries"]:
        print(f"  {e['path']:40s} cmetric={e['cmetric_s']:.4f}s "
              f"slices={e['slices']}")
    assert any("commit_txn" in e["path"] for e in top["entries"])

    drill = json.loads(get(addr, "/api/hosts/db-1"))
    print(f"db-1 drill-down: {drill['workers']} workers, "
          f"journal blocks={drill['journal']['blocks']}")

    metrics = get(addr, "/metrics").decode()
    line = next(ln for ln in metrics.splitlines()
                if ln.startswith("gapp_session_events_folded"))
    print(f"prometheus:  {line}")

    service.close()
    fleet.stop()
    server.close()


if __name__ == "__main__":
    main()
