"""Fleet profiling quickstart: one ingest server + two hosts on localhost.

Two "hosts" (processes in real deployments; sessions here) run the same
4-worker workload, but on host ``db-1`` one worker also serializes on a
shared lock.  Each host attaches a ``RemoteSink`` so its drained events
stream over a real socket into one ``IngestServer``; a single
``ProfileSession`` over the server's ``FleetSource`` folds the merged
fleet stream and reports the bottleneck with host provenance — the text
profile gains per-host lanes, and the critical path points at the serial
section on ``db-1`` without instrumenting the lock.

Every session folds on the card unless ``--device cpu`` asks for the
kernels' plain PyTorch versions on the CPU.

Run:  PYTHONPATH=src python -m repro_torch.examples.fleet_profile [--device cpu]
"""
import argparse
import threading
import time

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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where every session folds (cuda or cpu)")
    args = ap.parse_args(argv)
    server = IngestServer(device=args.device)   # 127.0.0.1:<ephemeral>
    server.start()
    fleet = ProfileSession(server.source, n_min=2.0)
    fleet.start()

    hosts = [threading.Thread(target=run_host,
                              args=(name, server.address, name == "db-1",
                                    args.device))
             for name in ("web-0", "db-1")]
    for t in hosts:
        t.start()
    for t in hosts:
        t.join()
    assert server.wait_idle(10.0), server.stats()

    rep = fleet.result()
    server.close()
    print(fleet.export("text", max_paths=3))
    print(f"hosts ingested: {rep.hosts}")
    per_host = rep.per_host()
    worst = max(per_host, key=lambda h: per_host[h]["critical_cm_s"])
    top = rep.path_str(rep.paths[0]) if rep.paths else "<none>"
    assert rep.hosts == ["web-0", "db-1"] or rep.hosts == ["db-1", "web-0"]
    print(f"\n=> most critical host: {worst}; top path: {top}")
    assert "commit_txn" in top, top


if __name__ == "__main__":
    main()
