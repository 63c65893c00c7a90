"""Train / eval step builders.

``make_train_step`` returns a function
``(params, opt_state, batch, err) -> (params, opt_state, metrics, err)``,
the JAX package's signature.  The step runs eagerly (the reference's
``jax.jit`` has no counterpart here): ``torch.autograd.grad`` of
``lm_loss`` with respect to every parameter leaf, then
:func:`~repro_torch.optim.adamw.update`, which writes the new parameters
and moments into the tensors of ``params`` and ``opt_state`` (the
reference's donated buffers).  The batch's tensors must lie on the
parameters' device.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models import lm_loss
from repro_torch.models.common import ModelConfig, tree_from_items, tree_items
from repro_torch.optim import adamw, compression
from repro_torch.sharding.api import constrain


def make_loss_fn(cfg: ModelConfig, **fw_kwargs) -> Callable:
    def loss_fn(params, batch):
        return lm_loss(params, batch, cfg, **fw_kwargs)
    return loss_fn


def _value_and_grad(loss_fn: Callable, params, batch):
    """``((loss, metrics), grads)`` of ``loss_fn`` at ``params``, as
    ``jax.value_and_grad(..., has_aux=True)`` gives them: each gradient
    in its parameter's dtype (float32 for the float32 masters), zeros for
    a leaf the loss does not reach."""
    items = tree_items(params)
    live = [p.detach().requires_grad_(True) for _, p in items]
    with torch.enable_grad():
        loss, metrics = loss_fn(tree_from_items(params, live), batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(live, grads)]
    # a DTensor gradient comes back Partial over the batch's mesh axes; it
    # is reduced to its parameter's placements here, as the reference's
    # gradients take their parameters' shardings (torch 2.11's AdamW
    # update on Partial gradients gives NaN at the second step)
    grads = [g.redistribute(p.device_mesh, p.placements)
             if isinstance(g, DTensor) else g for p, g in zip(live, grads)]
    metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
               for k, v in metrics.items()}
    return (loss.detach(), metrics), tree_from_items(params, grads)


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    compress: str = "none", microbatch: int | None = None,
                    **fw_kwargs) -> Callable:
    """Builds the step.  ``microbatch`` splits the per-step batch into
    gradient-accumulation chunks (sequential, remat-friendly)."""
    loss_fn = make_loss_fn(cfg, **fw_kwargs)

    def grad_fn(params, batch):
        (loss, metrics), grads = _value_and_grad(loss_fn, params, batch)
        return grads, {**metrics, "loss": loss}

    cgrad = compression.wrap_grad_fn(grad_fn, compress)

    def train_step(params, opt_state, batch, err):
        batch = {k: constrain(v, "batch") for k, v in batch.items()}
        if microbatch and microbatch > 1:
            # the reference's lax.scan over microbatches, as a loop that
            # adds each chunk's float32 gradients and loss
            acc = loss_sum = None
            n = next(iter(batch.values())).shape[0] // microbatch
            for i in range(microbatch):
                mb = {k: v.reshape((microbatch, n) + tuple(v.shape[1:]))[i]
                      for k, v in batch.items()}
                g, aux = grad_fn(params, mb)
                g = [x.float() for _, x in tree_items(g)]
                if acc is None:
                    acc, loss_sum = g, aux["loss"].float()
                else:
                    torch._foreach_add_(acc, g)
                    loss_sum = loss_sum + aux["loss"]
            torch._foreach_div_(acc, microbatch)
            grads = tree_from_items(params, acc)
            metrics = {"loss": loss_sum / microbatch}
            new_err = err
        else:
            grads, metrics, new_err = cgrad(params, batch, err)
            metrics = {"loss": metrics["loss"]}
        params, opt_state, opt_metrics = adamw.update(opt_cfg, grads,
                                                      opt_state, params)
        return params, opt_state, {**metrics, **opt_metrics}, new_err

    return train_step


def make_eval_step(cfg: ModelConfig, **fw_kwargs) -> Callable:
    loss_fn = make_loss_fn(cfg, **fw_kwargs)

    def eval_step(params, batch):
        with torch.no_grad():
            loss, metrics = loss_fn(params, batch)
        return metrics
    return eval_step
