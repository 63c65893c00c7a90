"""Plain AdamW as the training cells' configuration states it: clipping
by the global gradient norm, linear warm-up then cosine decay, bias
correction, decoupled weight decay on matrices only, float32 moments."""
from __future__ import annotations

import math

import torch


def learning_rate(cfg: dict, step: int) -> float:
    warm = min(step / max(cfg["warmup_steps"], 1), 1.0)
    frac = min(max((step - cfg["warmup_steps"])
                   / max(cfg["total_steps"] - cfg["warmup_steps"], 1), 0.0),
               1.0)
    ratio = cfg["min_lr_ratio"]
    return cfg["lr"] * warm * (ratio + (1 - ratio) * 0.5
                               * (1 + math.cos(math.pi * frac)))


@torch.no_grad()
def step(cfg: dict, t: int, params: list, grads: list, mu: list,
         nu: list) -> None:
    """Step ``t`` (1-based) over the leaves, in place."""
    gnorm = math.sqrt(sum(float(g.double().pow(2).sum()) for g in grads))
    clip = min(1.0, cfg["clip_norm"] / max(gnorm, 1e-12)) \
        if cfg["clip_norm"] > 0 else 1.0
    b1, b2 = cfg["b1"], cfg["b2"]
    lr = learning_rate(cfg, t)
    c1, c2 = 1 - b1 ** t, 1 - b2 ** t
    for p, g, m, v in zip(params, grads, mu, nu, strict=True):
        g = g * clip
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).add_(g * g, alpha=1 - b2)
        u = (m / c1) / (torch.sqrt(v / c2) + cfg["eps"])
        if p.ndim >= 2:
            u.add_(p, alpha=cfg["weight_decay"])
        p.sub_(u, alpha=lr)
