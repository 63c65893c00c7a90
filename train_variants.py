#!/usr/bin/env python3
"""Where the eager training step's time goes, on one NVIDIA GPU.

    python3 train_variants.py

The step is ``chip_smoke.py`` phase 8's: ``make_train_step`` at gemma3-1b's
full published width (999,811,584 parameters, float32 masters drawn on the
card from the seed, bf16 compute), B = 4, S = 1,024, run by a ``Trainer``
(no checkpoint) for 4 steps a run.  Variants, for ``cfg.remat`` on (the
config's own setting) and off:

* ``none``: no GAPP session;
* ``2ms``: the trainer's default session (probe and drain every 2 ms);
* ``20ms``: the same session with probe and drain every 20 ms;
* ``spans``: a session whose probe and drain threads never wake during
  the run (only the trainer's and the loader's begin/end calls remain).

Every variant runs twice, in turns, after one warm-up run; each prints
its median host time a step to the end of the step's device work, and
each remat setting its mean per variant against ``none`` and the peak
device memory.  Then ``chip_smoke.train_breakdown`` over 2 steps of each
remat setting without a session: the device's busy time and kernels a
step, the heaviest kernels and the host's heaviest operators.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

#: variant -> the session's (probe dt, drain interval), None for no session
SESSIONS = {"none": None, "2ms": (0.002, 0.002), "20ms": (0.02, 0.02),
            "spans": (3600.0, 3600.0)}
STEPS = 4


def median_step_ms(cfg, opt_cfg, step_fn, dev, variant: str,
                   steps: int = STEPS) -> float:
    import numpy as np
    from chip_smoke import timed_step
    from repro_torch.core import ProfileSession
    from repro_torch.train.trainer import Trainer, TrainerConfig
    times: list[float] = []
    every = SESSIONS[variant]
    sess = None if every is None else ProfileSession(
        dt=every[0], drain_interval=every[1], device=dev)
    tcfg = TrainerConfig(steps=steps, batch_per_host=4, seq_len=1024,
                         ckpt_every=0, log_every=10**6,
                         profile=sess is not None)
    Trainer(cfg, opt_cfg, tcfg, gapp=sess,
            step_fn=timed_step(step_fn, times), device=dev).run()
    return 1e3 * float(np.median(times))


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("train_variants: needs one NVIDIA GPU", file=sys.stderr)
        return 2
    from chip_smoke import train_breakdown
    from repro_torch import configs
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_step
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[setup] card: {card}")
    dev = torch.device("cuda")
    opt_cfg = adamw.AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=16)
    for remat in (True, False):
        cfg = dataclasses.replace(configs.get_config("gemma3-1b"),
                                  remat=remat)
        step_fn = make_train_step(cfg, opt_cfg)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        median_step_ms(cfg, opt_cfg, step_fn, dev, "none", 2)
        res: dict[str, list[float]] = {}
        for _ in range(2):
            for variant in SESSIONS:
                ms = median_step_ms(cfg, opt_cfg, step_fn, dev, variant)
                res.setdefault(variant, []).append(ms)
                print(f"[step] remat {remat}, session {variant}: {ms:.3f} ms "
                      f"a step (median of {STEPS})", flush=True)
        base = float(np.mean(res["none"]))
        print(f"[step] remat {remat}: " + "; ".join(
            f"{k} {np.mean(v):.3f} ms ({np.mean(v) / base:.4f}x)"
            for k, v in res.items())
            + f"; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        print(f"[profile] remat {remat}:")
        train_breakdown(cfg, step_fn, dev, steps=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
