"""The training entry: ``train.Trainer`` as the ``train_lm`` example runs
it (bf16 over float32 masters, remat, AdamW, a prefetching loader), with
or without a GAPP session, and no checkpoint.

Set-up builds one trainer, hands it the benchmark's weights (through its
``init_state``) and the benchmark's batch source (the ``SyntheticLM`` name
the trainer builds its source from, for the duration of the build), and
starts ``Trainer.run``.  The step function the trainer calls is the
port's ``make_train_step`` wrapped by the harness: its first
``check_steps`` calls are set-up and are what the check reads (the losses,
the first gradient as the optimizer's moments hold it after step one,
the parameters' change after the last); the window opens at the next
call and closes at the first call after ``seconds`` have passed, which
raises :class:`WindowClosed` out of ``Trainer.run``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import time

import numpy as np
import torch

from gappbench import cell as cell_lib
from gappbench import gapp_check, weights, yardstick
from gappbench.reference import adamw as ref_adamw
from gappbench.reference import model as ref
from gappbench.traffic import generate


class WindowClosed(Exception):
    """Raised by the wrapped step to end ``Trainer.run`` at the window's
    close."""


@dataclasses.dataclass
class Live:
    trainer: object
    session: object
    shape: object                 # the family's Shape
    seed: int
    device: torch.device
    check_steps: int
    real_step: object = None
    seconds: float = 0.0
    calls: int = 0
    losses: list = dataclasses.field(default_factory=list)
    grad_norms: list | None = None
    change_norms: list | None = None
    t_open: float | None = None
    t_close: float | None = None
    entries: list = dataclasses.field(default_factory=list)
    issue_s: list = dataclasses.field(default_factory=list)
    wait_s: list = dataclasses.field(default_factory=list)
    drain_s: list = dataclasses.field(default_factory=list)
    mark: object = None
    setup_done: object = None     # called once set-up is over


def _leaf_norms(tree, s) -> list[float]:
    return [float(weights.get(tree, path).float().norm())
            for path, _, _ in weights.leaf_specs(s)]


def _change_norms(live: Live, params) -> list[float]:
    """Each leaf's distance from where it started (drawn again)."""
    out = []
    for i, (path, shape, scale) in enumerate(weights.leaf_specs(live.shape)):
        p0 = weights.draw_leaf(live.seed, i, shape, scale, torch.float32,
                               live.device)
        out.append(float((weights.get(params, path) - p0).norm()))
        del p0
    return out


def _step(live: Live, b1: float, params, opt_state, batch, err):
    live.calls += 1
    n = live.calls
    if n == 2:
        live.grad_norms = [x / (1 - b1)
                           for x in _leaf_norms(opt_state["mu"], live.shape)]
    if n == live.check_steps + 1:
        live.change_norms = _change_norms(live, params)
        live.losses = [float(x) for x in live.losses]
        if live.device.type == "cuda":
            torch.cuda.synchronize(live.device)
        live.setup_done()
        live.t_open = time.perf_counter()
        live.wait_s.clear()
        live.drain_s.clear()
    now = time.perf_counter()
    if live.t_open is not None:
        live.entries.append(now)
        if now - live.t_open >= live.seconds:
            live.t_close = now
            raise WindowClosed
    ctx = live.mark("gappbench/train.step") if live.mark is not None \
        and live.t_open is not None else contextlib.nullcontext()
    with ctx:
        out = live.real_step(params, opt_state, batch, err)
    if live.t_open is not None:
        live.issue_s.append(time.perf_counter() - now)
    if n <= live.check_steps:
        live.losses.append(out[2]["loss"].detach())
    return out


def setup(cell, seed: int, device, setup_done) -> Live:
    """The trainer, built and ready; ``run(live, seconds)`` starts it."""
    from repro_torch.core import ProfileSession
    from repro_torch.optim import adamw
    from repro_torch.train import trainer as trainer_mod
    from repro_torch.train.step import make_train_step
    mix, s = cell.traffic, cell.shape
    cfg = cell_lib.model_config(s, cell.config_name)
    opt_cfg = adamw.AdamWConfig(**mix["adamw"])
    session = None
    if mix.get("gapp"):
        if device.type == "cuda":
            from repro_torch.kernels import build
            build.build_all()
        session = ProfileSession(dt=mix["gapp"]["dt"], device=device)
    live = Live(None, session, s, seed, device, mix["check_steps"],
                setup_done=setup_done)
    live.real_step = make_train_step(cfg, opt_cfg)
    tcfg = trainer_mod.TrainerConfig(
        steps=1 << 40, ckpt_every=0, batch_per_host=mix["batch"],
        seq_len=mix["seq_len"], seed=seed, log_every=1 << 40,
        profile=session is not None)
    source = functools.partial(generate.BatchSource, keep=mix["check_steps"])
    saved = trainer_mod.SyntheticLM
    trainer_mod.SyntheticLM = source
    try:
        tr = trainer_mod.Trainer(
            cfg, opt_cfg, tcfg, gapp=session, device=device,
            step_fn=functools.partial(_step, live, opt_cfg.b1))
    finally:
        trainer_mod.SyntheticLM = saved
    params = weights.make_params(s, seed, torch.float32, device)
    tr.init_state = lambda gen=None: (params, adamw.init(params))
    real_get = tr.loader.get

    def get():
        t = time.perf_counter()
        out = real_get()
        live.wait_s.append(time.perf_counter() - t)
        return out
    tr.loader.get = get
    live.trainer = tr
    if session is not None:
        gapp_check.time_drains(session, live.drain_s)
    return live


def run(live: Live, seconds: float, mark=None) -> dict:
    """Set-up's checked steps, then the window; its record."""
    live.seconds = seconds
    live.mark = mark
    try:
        live.trainer.run()
    except WindowClosed:
        pass
    if live.t_close is None:
        raise RuntimeError("the trainer stopped before the window closed")
    tr = live.trainer
    steps = len(live.entries) - 1
    positions = yardstick.train_step(live.shape, tr.tcfg.batch_per_host,
                                     tr.tcfg.seq_len)["positions"]
    losses = [h["loss"] for h in tr.history[live.check_steps:]]
    return {"entry": "train", "window_s": live.t_close - live.t_open,
            "steps": steps, "positions": positions,
            "batch": tr.tcfg.batch_per_host, "seq": tr.tcfg.seq_len,
            "issue_s": list(live.issue_s),
            "loader_wait_s": list(live.wait_s),
            "drain_s": list(live.drain_s),
            "attempted": steps,
            "failed": sum(not np.isfinite(x) for x in losses)}


def close(live: Live) -> dict:
    """What the check reads from the program; its state is dropped."""
    out = {"losses": list(live.losses), "grad_norms": live.grad_norms,
           "change_norms": live.change_norms,
           "batches": list(live.trainer.source.kept), "gapp": None}
    if live.session is not None:
        cap = gapp_check.capture(live.session)
        steps = len(live.trainer.history)
        why = gapp_check.capture_complete(cap, steps, steps)
        out["gapp"] = (cap, why)
    live.trainer = live.session = live.real_step = None
    return out


def reference(cell, seed: int, device, batches: list, mm=ref.plain_mm,
              keep_rows=None) -> dict:
    """The float32 reference's first ``len(batches)`` steps from the same
    weights and batches: losses, the first step's clipped gradient by
    leaf (from its first moment) and each leaf's change after the last."""
    ref.no_tf32()
    s = cell.shape
    specs = weights.leaf_specs(s)
    params = weights.make_params(s, seed, torch.float32, device)
    leaves = [weights.get(params, path) for path, _, _ in specs]
    mu = [torch.zeros_like(p) for p in leaves]
    nu = [torch.zeros_like(p) for p in leaves]
    cfg = cell.traffic["adamw"]
    losses, grad_norms = [], None
    for t, b in enumerate(batches, start=1):
        tokens = torch.from_numpy(b["tokens"]).to(device)
        front = torch.from_numpy(b["frontend"]).to(device) \
            if "frontend" in b else None
        for p in leaves:
            p.requires_grad_(True)
        loss = ref.lm_loss(params, tokens, front, s, mm=mm,
                           keep_rows=keep_rows)
        grads = torch.autograd.grad(loss, leaves)
        for p in leaves:
            p.requires_grad_(False)
        losses.append(float(loss.detach()))
        ref_adamw.step(cfg, t, leaves, list(grads), mu, nu)
        del grads, loss
        if t == 1:
            grad_norms = [float(m.norm()) / (1 - cfg["b1"]) for m in mu]
    del mu, nu
    change = []
    for i, (path, shape, scale) in enumerate(specs):
        p0 = weights.draw_leaf(seed, i, shape, scale, torch.float32, device)
        change.append(float((leaves[i] - p0).norm()))
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change}


def gaps(prog: dict, refr: dict) -> dict:
    """The three compared numbers: the losses' widest relative gap, and
    the worst leaf's gap of gradient norms and of change norms, each over
    the larger of the reference's norm of that leaf and of the median
    leaf.  Leaves whose reference gradient is under a thousandth of the
    median leaf's move by round-off alone and are left out of the
    change."""
    loss = max(abs(a - b) / abs(b) for a, b in
               zip(prog["losses"], refr["losses"], strict=True))
    g_p, g_r = np.asarray(prog["grad_norms"]), np.asarray(refr["grad_norms"])
    c_p = np.asarray(prog["change_norms"])
    c_r = np.asarray(refr["change_norms"])
    gmed = float(np.median(g_r))
    grad = float(np.max(np.abs(g_p - g_r) / np.maximum(g_r, gmed)))
    moved = g_r >= 1e-3 * gmed
    cmed = float(np.median(c_r[moved]))
    change = float(np.max(np.abs(c_p - c_r)[moved]
                          / np.maximum(c_r[moved], cmed)))
    return {"loss_gap": loss, "grad_gap": grad, "update_gap": change}
