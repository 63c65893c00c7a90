"""End-to-end driver: train a ~100M-param LM with the profiler attached.

Phase 1 trains normally; phase 2 injects a slow data loader (the classic
fleet bottleneck).  The GAPP profile shifts: phase-2 critical paths move
from compute spans to ``data/generate``, and the per-worker chart shows
the loader dominating — the paper's workflow ("rank, read the top path,
fix that") on a real training loop with checkpointing and prefetch.

The model trains on the card and the sessions fold there too, unless
``--device cpu`` asks for both on the CPU.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300]
      [--dmodel 768] [--device cpu]
(defaults produce a ~110M-param llama-style model; use --steps 40
--dmodel 256 for a quick pass on a small CPU.)
"""
import argparse
import os
import tempfile

from repro_torch import device as device_lib
from repro_torch.core import ProfileSession, render_text
from repro_torch.models.common import ModelConfig
from repro_torch.optim import adamw
from repro_torch.train.step import make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig


def build_cfg(d_model: int) -> ModelConfig:
    return ModelConfig(
        name=f"lm-{d_model}", family="dense",
        num_layers=12, d_model=d_model, num_heads=d_model // 64,
        num_kv_heads=d_model // 64, d_ff=4 * d_model, vocab_size=32000,
        block_pattern=("dense",),
    )


def train_phase(cfg, opt_cfg, tcfg, step_fn, device):
    """One phase: a trainer under its own GAPP session (probe every 2 ms,
    on ``device``), run to ``tcfg.steps``; returns the trainer and the
    parameters and optimizer state it ended with."""
    gapp = ProfileSession(dt=0.002, device=device)
    tr = Trainer(cfg, opt_cfg, tcfg, gapp=gapp, step_fn=step_fn,
                 device=device)
    params, opt_state = tr.run()
    return tr, params, opt_state


def loader_delay(tr: Trainer) -> tuple[float, float]:
    """``(stall, step)`` seconds: the stall phase 2 injects is 1.5x phase
    1's mean step (the trainer's CMetric over its steps), so the demo
    works on any host speed."""
    step_s = tr.gapp.tracer.per_worker_cm()[tr.w_train] \
        / max(len(tr.history), 1)
    return max(1.5 * step_s, 0.05), step_s


def data_bound(rep) -> bool:
    """Whether a path holding ``data/generate`` is among the top two."""
    return any("data/generate" in rep.path_str(p) for p in rep.paths[:2])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--dmodel", type=int, default=768)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--device", default="cuda",
                    help="where the model trains and the sessions fold "
                    "(cuda or cpu)")
    args = ap.parse_args(argv)
    dev = device_lib.resolve(args.device)

    cfg = build_cfg(args.dmodel)
    n_params = cfg.param_count()
    print(f"model: {cfg.name}, ~{n_params / 1e6:.0f}M params")

    opt_cfg = adamw.AdamWConfig(lr=3e-4, warmup_steps=20,
                                total_steps=args.steps)
    half = args.steps // 2
    ckpt_root = tempfile.gettempdir()
    tcfg = TrainerConfig(steps=half, batch_per_host=args.batch,
                         seq_len=args.seq, ckpt_every=max(half // 2, 1),
                         ckpt_dir=os.path.join(ckpt_root,
                                               "repro_example_ckpt"),
                         log_every=20)
    step_fn = make_train_step(cfg, opt_cfg)

    print("== phase 1: healthy pipeline ==")
    t1, _, _ = train_phase(cfg, opt_cfg, tcfg, step_fn, dev)
    rep1 = t1.profile_report()
    print(render_text(rep1, max_paths=3))

    delay, step_s = loader_delay(t1)
    print(f"== phase 2: slow data loader injected ({delay * 1e3:.0f}ms/batch,"
          f" 1.5x the {step_s * 1e3:.0f}ms phase-1 step) ==")
    tcfg2 = TrainerConfig(steps=half, batch_per_host=args.batch,
                          seq_len=args.seq, ckpt_every=max(half // 2, 1),
                          ckpt_dir=os.path.join(ckpt_root,
                                                "repro_example_ckpt2"),
                          log_every=20, loader_delay_s=delay)
    t2, _, _ = train_phase(cfg, opt_cfg, tcfg2, step_fn, dev)
    rep2 = t2.profile_report()
    print(render_text(rep2, max_paths=3))

    losses = [h["loss"] for h in t1.history]
    print(f"loss: start {losses[0]:.3f} -> end {losses[-1]:.3f} "
          f"(decreased: {losses[-1] < losses[0]})")
    top2 = rep2.path_str(rep2.paths[0]) if rep2.paths else "?"
    print(f"phase-2 top bottleneck path: {top2}")
    print("=> GAPP attributed the slowdown to the data pipeline:",
          data_bound(rep2))


if __name__ == "__main__":
    main()
