"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

Runs use the tiny config unless ``--full`` asks for the published one.
``--resume`` restores the latest checkpoint; ``--restarts N`` wraps the
loop in crash-restart (ft/monitor).  The GAPP profile is printed at the
end of every run — the profiler is on by default, as in the paper ("works
out of the box").  The model trains on the card unless ``--device cpu``
asks for the CPU; the step runs eagerly (``make_train_step``).
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch import configs
from repro_torch.ft.monitor import run_with_restarts
from repro_torch.optim import adamw
from repro_torch.train.step import make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig


def build_trainer(arch: str, *, tiny: bool = True, steps: int = 50,
                  batch: int = 8, seq: int = 128, ckpt_dir: str | None = None,
                  loader_delay_s: float = 0.0, profile: bool = True,
                  compress: str = "none", device=None) -> Trainer:
    """A :class:`Trainer` for ``arch`` on ``device`` (the port's default
    device, CUDA, when None); checkpoints go under the temporary
    directory unless ``ckpt_dir`` is given."""
    cfg = configs.get_tiny(arch) if tiny else configs.get_config(arch)
    tcfg = TrainerConfig(
        steps=steps, batch_per_host=batch, seq_len=seq,
        ckpt_dir=ckpt_dir or os.path.join(tempfile.gettempdir(),
                                          f"repro_ckpt_{arch}"),
        ckpt_every=max(steps // 2, 1), profile=profile,
        loader_delay_s=loader_delay_s)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=steps)
    step_fn = make_train_step(cfg, opt_cfg, compress=compress)
    return Trainer(cfg, opt_cfg, tcfg, step_fn=step_fn, device=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b", choices=configs.ARCHS)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true",
                    help="full published config (the tiny one otherwise)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--restarts", type=int, default=0)
    ap.add_argument("--compress", default="none",
                    choices=["none", "int8", "topk"])
    ap.add_argument("--loader-delay", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="where the model trains and the session folds "
                    "(cuda or cpu)")
    args = ap.parse_args(argv)

    trainer = build_trainer(args.arch, tiny=not args.full, steps=args.steps,
                            batch=args.batch, seq=args.seq,
                            loader_delay_s=args.loader_delay,
                            compress=args.compress, device=args.device)

    def attempt(start_step: int) -> int:
        trainer.run(start_step=None if (start_step == 0 and not args.resume)
                    else -1)
        return trainer.tcfg.steps

    if args.restarts:
        run_with_restarts(attempt, max_restarts=args.restarts)
    else:
        attempt(0)

    if trainer.gapp is not None:
        from repro_torch.core.report import render_text
        print(render_text(trainer.profile_report(), max_paths=5))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
