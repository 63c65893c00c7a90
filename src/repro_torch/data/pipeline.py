"""Data pipeline: synthetic LM token stream with background prefetch.

Per-host sharded generation (each host materialises only its slice of the
global batch), a bounded prefetch queue running in a worker thread, and —
because the input pipeline is a classic fleet serialization bottleneck —
first-class GAPP instrumentation: the loader thread is a registered worker
whose spans ("data/generate", "data/wait_queue") show up in the profile
when the pipeline can't keep up with the step loop.

Batches are numpy arrays drawn from ``np.random.default_rng`` on the
loader's thread, so they equal the JAX package's bit for bit; the consumer
(the trainer) moves each batch to its device.
"""
from __future__ import annotations

import queue
import threading

import numpy as np

from repro_torch.core.session import ProfileSession


class SyntheticLM:
    """Deterministic synthetic token batches (zipfian unigram + markov-ish
    mixing so the loss actually decreases during the e2e example)."""

    def __init__(self, vocab_size: int, seq_len: int, batch_per_host: int,
                 seed: int = 0, frontend_shape: tuple | None = None):
        self.vocab = vocab_size
        self.seq = seq_len
        self.batch = batch_per_host
        self.frontend_shape = frontend_shape
        self._rng = np.random.default_rng(seed)
        ranks = np.arange(1, min(vocab_size, 4096) + 1, dtype=np.float64)
        self._probs = (1.0 / ranks) / np.sum(1.0 / ranks)
        self._support = min(vocab_size, 4096)

    def next_batch(self) -> dict:
        base = self._rng.choice(self._support, size=(self.batch, self.seq),
                                p=self._probs)
        # inject learnable structure: token t+1 correlates with token t
        shifted = (base + 1) % self._support
        mix = self._rng.random((self.batch, self.seq)) < 0.5
        tokens = np.where(mix, np.roll(shifted, 1, axis=1), base)
        out = {"tokens": tokens.astype(np.int32)}
        if self.frontend_shape is not None:
            out["frontend"] = self._rng.standard_normal(
                (self.batch,) + self.frontend_shape).astype(np.float32)
        return out


class PrefetchLoader:
    """Bounded-queue background prefetch around any ``next_batch`` source."""

    def __init__(self, source, depth: int = 2,
                 gapp: ProfileSession | None = None, delay_s: float = 0.0):
        self.source = source
        self.queue: queue.Queue = queue.Queue(maxsize=depth)
        self.gapp = gapp
        self.delay_s = delay_s          # artificial slowness (benchmarks)
        self._stop = threading.Event()
        self._wid = gapp.register_worker("data_loader", "thread") \
            if gapp else None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="data-loader")
        self._thread.start()

    def _run(self):
        import time
        while not self._stop.is_set():
            if self.gapp is not None:
                self.gapp.begin(self._wid, "data/generate")
            batch = self.source.next_batch()
            if self.delay_s:
                time.sleep(self.delay_s)
            if self.gapp is not None:
                self.gapp.end(self._wid)
            while not self._stop.is_set():
                try:
                    self.queue.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def get(self) -> dict:
        return self.queue.get()

    def stop(self):
        self._stop.set()
        try:
            self.queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
