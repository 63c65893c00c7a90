"""AdamW with global-norm clipping and schedules (plain functions on trees).

The JAX package's pure pytree functions, on trees of tensors, with its
arithmetic: clip by the global norm, linear warmup then cosine decay, bias
correction from a float32 step, decoupled weight decay on tensors of rank
>= 2 only, float32 moments and an int32 step.  ``torch.optim.AdamW`` is
not used: its schedule, clipping and decay mask differ.

:func:`update` writes the new parameters and moments into the tensors it
is given, as the reference's jitted step updates its donated buffers
(``donate_argnums=(0, 1)``), and it may overwrite ``grads``.  It runs as a
few ``torch._foreach_*`` calls over all leaves, each of which launches a
handful of multi-tensor kernels, instead of about ten launches a leaf.
Every scalar (the step, the norm, the learning rate, the corrections) is
a 0-d tensor on the parameters' device, so the step never waits for the
host.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models.common import tree_items, tree_map
from repro_torch.sharding.api import narrow_to
from repro_torch.spans import span


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def schedule(cfg: AdamWConfig, step):
    """Linear warmup, cosine decay; ``step`` a tensor or a number, the
    result a float32 tensor."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 \
        * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def _leaves(tree) -> list:
    """The leaves in the reference's order (sorted dict keys)."""
    return [leaf for _, leaf in tree_items(tree)]


def init(params) -> dict:
    """Zeroed float32 moments shaped like ``params`` and an int32 step,
    all on the parameters' device."""
    dev = _leaves(params)[0].device

    def zeros(p):
        return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                              device=x.device), p)
    return {"mu": zeros(params), "nu": zeros(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    """The float32 2-norm of all leaves together."""
    norms = torch._foreach_norm([x.float() for x in _leaves(tree)])
    return torch.sqrt(torch.sum(torch.square(torch.stack(norms))))


def update(cfg: AdamWConfig, grads, state, params):
    """Returns (new_params, new_state, metrics): ``params``, ``state["mu"]``
    and ``state["nu"]`` hold the new values (written in place), the step
    is a new tensor, and ``metrics`` holds ``grad_norm`` and ``lr``."""
    flat_p = _leaves(params)
    flat_m = _leaves(state["mu"])
    flat_v = _leaves(state["nu"])
    flat_g = _leaves(grads)
    if not (len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v)):
        raise ValueError("update: grads, moments and params differ in "
                         "structure")
    with torch.no_grad(), span("optim/adamw"):
        step = state["step"] + 1
        gnorm = global_norm(grads)
        lr = schedule(cfg, step)
        sf = step.float()
        c1 = 1 - cfg.b1 ** sf
        c2 = 1 - cfg.b2 ** sf
        # each gradient as its moment is placed (ZeRO-1 shards the moments
        # further over the data axes): this rank's rows, one view each
        g = [narrow_to(x.float(), m) for x, m in zip(flat_g, flat_m)]
        if cfg.clip_norm > 0:
            torch._foreach_mul_(g, torch.clamp(
                cfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0))
        # m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g^2
        torch._foreach_mul_(flat_m, cfg.b1)
        torch._foreach_add_(flat_m, torch._foreach_mul(g, 1 - cfg.b1))
        torch._foreach_mul_(g, g)
        torch._foreach_mul_(g, 1 - cfg.b2)
        torch._foreach_mul_(flat_v, cfg.b2)
        torch._foreach_add_(flat_v, g)
        del g
        # u = (m / c1) / (sqrt(v / c2) + eps)
        den = torch._foreach_div(flat_v, c2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, cfg.eps)
        u = torch._foreach_div(flat_m, c1)
        torch._foreach_div_(u, den)
        del den
        p32 = [x.float() for x in flat_p]
        mats = [i for i, x in enumerate(flat_p) if x.ndim >= 2]
        if mats:      # decoupled weight decay on matrices only
            decay = torch._foreach_mul([narrow_to(p32[i], u[i])
                                        for i in mats], cfg.weight_decay)
            torch._foreach_add_([u[i] for i in mats], decay)
            del decay
        torch._foreach_mul_(u, lr)
        torch._foreach_sub_(p32, u)
        for p, q in zip(flat_p, p32):
            if q is not p:
                p.copy_(q)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, {"mu": state["mu"], "nu": state["nu"], "step": step}, \
        metrics
