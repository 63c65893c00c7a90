"""Quickstart: profile a multithreaded workload 'out of the box'.

Four worker threads do parallel work, but every iteration one of them also
holds a shared resource (a lock-protected section) three times longer than
the parallel phase — a synthetic Bodytrack (paper §5.2).  GAPP needs no
instrumentation of the lock itself: the streaming ``ProfileSession`` drains
and folds events in the background *while the threads run*, pushes live
top-1 updates through ``watch()``, and the final report ranks the serial
section first with the sampling probe attributing it.

The session folds on the card (the ``fused`` backend: the chunked fold's
prefix on the ``carry_cumsum`` kernel, the report's histogram on
``tag_hist``) unless ``--device cpu`` asks for the kernels' plain PyTorch
versions on the CPU.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse
import threading
import time

from repro_torch.core import ProfileSession


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the session folds (cuda or cpu)")
    args = ap.parse_args(argv)
    # n_min defaults to workers/2
    s = ProfileSession(n_min=None, dt=0.001, device=args.device)
    lock = threading.Lock()
    n_threads = 4
    wids = [s.register_worker(f"worker{i}") for i in range(n_threads)]

    # live push: the background drain worker delivers an incremental report
    # every 50 ms without stopping the workload
    updates = []
    s.watch(lambda rep: updates.append(
        rep.path_str(rep.paths[0]) if rep.paths else "<warming up>"),
        every=0.05, top_n=1)

    def worker(i):
        for it in range(10):
            with s.span(wids[i], "parallel_compute"):
                time.sleep(0.004)
            # only worker 0 writes the shared output file (the bottleneck)
            if i == 0:
                with s.span(wids[i], "write_output"):
                    with lock:
                        time.sleep(0.012)

    with s.running():
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        mid = s.snapshot()          # incremental report, capture still live

    rep = s.result()
    print(s.export("text", max_paths=3))
    print(f"live updates pushed while running: {len(updates)} "
          f"(last: {updates[-1] if updates else '-'})")
    print(f"mid-capture snapshot already saw {mid.total_slices} slices")
    top = rep.path_str(rep.paths[0])
    assert "write_output" in top, f"expected write_output, got {top}"
    print("\n=> GAPP pinpointed the serial section:", top)


if __name__ == "__main__":
    main()
