"""Trainer: the instrumented host loop tying every substrate together.

The host itself is a set of GAPP workers: the step dispatcher, the data
loader (inside PrefetchLoader), and the checkpoint writer.  Any of them
stalling the others produces exactly the reduced-parallelism slices the
profiler ranks — profile a run, read the top call path, fix that.  This is
the paper's workflow (§5) transplanted onto a training job.

The model trains on ``device`` (the port's default device, CUDA, unless
the caller passes ``device=``), resolved once when the trainer is built;
the default session folds there too.  The step's span ends after the
step's device work: the host reads the step's loss, which waits for it,
before ``train/step`` ends, so a slow step is not credited to the loader.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Callable

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.ckpt import checkpoint
from repro_torch.core.session import ProfileSession
from repro_torch.data.pipeline import PrefetchLoader, SyntheticLM
from repro_torch.models import init_lm
from repro_torch.models.common import ModelConfig
from repro_torch.optim import adamw
from repro_torch.train.step import make_train_step


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_every: int = 50             # <= 0: no checkpoint, not even a final one
    ckpt_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_ckpt"))
    ckpt_async: bool = True
    batch_per_host: int = 8
    seq_len: int = 128
    seed: int = 0
    log_every: int = 10
    profile: bool = True
    loader_delay_s: float = 0.0      # inject data bottleneck (benchmarks)


class Trainer:
    def __init__(self, cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                 tcfg: TrainerConfig, gapp: ProfileSession | None = None,
                 step_fn: Callable | None = None, *, device=None):
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.tcfg = tcfg
        self.device = device_lib.resolve(device)
        # ``gapp`` accepts a ProfileSession or the deprecated Gapp facade
        # (both expose the same span/lifecycle surface).
        self.gapp = gapp if gapp is not None else (
            ProfileSession(dt=0.002, device=self.device)
            if tcfg.profile else None)
        self.step_fn = step_fn or make_train_step(cfg, opt_cfg)
        front = None
        if cfg.enc_layers:
            front = (tcfg.seq_len // 2, cfg.frontend_dim)
        elif cfg.frontend_dim:
            front = (cfg.num_prefix, cfg.frontend_dim)
        self.source = SyntheticLM(cfg.vocab_size, tcfg.seq_len,
                                  tcfg.batch_per_host, tcfg.seed,
                                  frontend_shape=front)
        self.loader = PrefetchLoader(self.source, depth=2, gapp=self.gapp,
                                     delay_s=tcfg.loader_delay_s)
        self.w_train = self.gapp.register_worker("trainer", "host") \
            if self.gapp else None
        self.w_ckpt = self.gapp.register_worker("ckpt_writer", "thread") \
            if self.gapp else None
        self.history: list[dict] = []
        self._ckpt_thread = None

    def init_state(self, gen: torch.Generator | None = None):
        """Parameters drawn from ``gen`` (a generator on the trainer's
        device seeded with ``tcfg.seed`` when None) and zeroed moments."""
        if gen is None:
            gen = torch.Generator(self.device).manual_seed(self.tcfg.seed)
        params = init_lm(gen, self.cfg, device=self.device)
        opt_state = adamw.init(params)
        return params, opt_state

    def restore_or_init(self):
        step = checkpoint.latest_step(self.tcfg.ckpt_dir)
        params, opt_state = self.init_state()
        if step is not None:
            tree = checkpoint.restore(self.tcfg.ckpt_dir, step,
                                      {"params": params, "opt": opt_state},
                                      device=self.device)
            return tree["params"], tree["opt"], step
        return params, opt_state, 0

    def _maybe_ckpt(self, step: int, params, opt_state, final=False):
        if self.tcfg.ckpt_every <= 0:
            return
        if step % self.tcfg.ckpt_every and not final:
            return
        if self._ckpt_thread is not None:
            self._ckpt_thread.join()
        tree = {"params": params, "opt": opt_state}
        self._ckpt_thread = checkpoint.save(
            self.tcfg.ckpt_dir, step, tree,
            blocking=not self.tcfg.ckpt_async,
            gapp=self.gapp, wid=self.w_ckpt)

    def run(self, start_step: int | None = None):
        if start_step in (None, 0):
            params, opt_state = self.init_state()
            step0 = 0
        else:
            params, opt_state, step0 = self.restore_or_init()
        err = None
        g = self.gapp
        if g:
            g.start()
        try:
            for step in range(step0, self.tcfg.steps):
                # blocking wait: the trainer is INACTIVE here (paper
                # semantics — a blocked thread leaves TASK_RUNNING), so a
                # slow loader runs alone and its data/generate slices are
                # the ones that turn critical
                batch = self.loader.get()
                if g:
                    g.begin(self.w_train, "train/step")
                batch = {k: torch.from_numpy(v).to(self.device)
                         for k, v in batch.items()}
                params, opt_state, metrics, err = self.step_fn(
                    params, opt_state, batch, err)
                float(metrics["loss"])      # waits for the step's work
                if g:
                    g.end(self.w_train)
                self.history.append(
                    {k: float(v) for k, v in metrics.items()
                     if v is not None and np.ndim(v) == 0})
                if step % self.tcfg.log_every == 0:
                    print(f"step {step:5d} loss {self.history[-1]['loss']:.4f}"
                          f" gnorm {self.history[-1].get('grad_norm', 0):.3f}",
                          flush=True)
                self._maybe_ckpt(step + 1, params, opt_state)
            self._maybe_ckpt(self.tcfg.steps, params, opt_state, final=True)
            if self._ckpt_thread is not None:
                self._ckpt_thread.join()
        finally:
            if g:
                g.stop()
            self.loader.stop()
        return params, opt_state

    def profile_report(self, top_n: int = 10):
        assert self.gapp is not None
        if hasattr(self.gapp, "snapshot"):          # ProfileSession
            return self.gapp.snapshot(top_n)
        return self.gapp.report(top_n=top_n)        # deprecated Gapp
