"""Fault tolerance: straggler detection + checkpoint/restart driver.

The straggler monitor closes the loop between the paper's profiler and the
fleet: per-host step heartbeats are ingested as worker spans, per-host
CMetric is maintained online, and a host whose criticality share exceeds
``zmax`` standard deviations is flagged (the DP all-reduce makes every other
host wait for it, which is precisely the low-parallelism signature CMetric
amplifies).  ``run_with_restarts`` provides crash-looping around the train
loop with restore-from-latest-checkpoint — node failures at scale become a
resume, not a lost run.

The monitor's session folds on ``device`` with ``fold_backend`` (the
port's defaults: the fused backend on CUDA), resolved once when the
monitor is built, so the session's drain thread folds where it was told.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np

from repro_torch.core.report import imbalance_stats
from repro_torch.core.session import ProfileSession


@dataclasses.dataclass
class StragglerVerdict:
    host: int
    cv: float
    max_over_mean: float
    is_straggler: bool


class StragglerMonitor:
    """Consumes per-host step busy intervals; flags criticality outliers."""

    def __init__(self, num_hosts: int, zmax: float = 3.0,
                 n_min: float | None = None, *, fold_backend: str = "fused",
                 device=None):
        self.num_hosts = num_hosts
        self.zmax = zmax
        self.session = ProfileSession(
            n_min=n_min if n_min is not None else num_hosts / 2,
            fold_backend=fold_backend, device=device)
        # Back-compat alias: pre-session call sites read ``monitor.gapp``.
        self.gapp = self.session
        self.wids = [self.session.register_worker(f"host{i}", "host")
                     for i in range(num_hosts)]

    def record_step(self, host: int, t_start_ns: int, t_end_ns: int,
                    tag: str = "train_step") -> None:
        self.session.ingest(t_start_ns, self.wids[host], +1, tag)
        self.session.ingest(t_end_ns, self.wids[host], -1, tag)

    def verdict(self) -> StragglerVerdict:
        pw = self.session.tracer.per_worker_cm()
        stats = imbalance_stats(pw)
        mean, std = stats["mean"], stats["std"]
        worst = int(np.argmax(pw))
        z = (pw[worst] - mean) / std if std > 0 else 0.0
        return StragglerVerdict(
            host=worst, cv=stats["cv"],
            max_over_mean=stats["max_over_mean"],
            is_straggler=bool(z > self.zmax and stats["max_over_mean"] > 1.2))


def run_with_restarts(train_fn: Callable[[int], int], max_restarts: int = 3,
                      on_restart: Callable[[int, BaseException], None]
                      | None = None) -> int:
    """``train_fn(start_step) -> final_step`` with crash-restart semantics.

    ``train_fn`` is responsible for restoring from the latest checkpoint
    when ``start_step`` is -1 (see ``train.trainer.Trainer.run``).
    Returns the final step.
    """
    attempt = 0
    step = 0
    while True:
        try:
            return train_fn(step)
        except KeyboardInterrupt:
            raise
        except Exception as e:          # noqa: BLE001 — restart scope
            attempt += 1
            if attempt > max_restarts:
                raise
            if on_restart is not None:
                on_restart(attempt, e)
            time.sleep(0.01)
            # next attempt resumes from whatever checkpoint exists
            step = -1                    # sentinel: restore latest
