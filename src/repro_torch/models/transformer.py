"""Model assembly: decoder-only LM, encoder-decoder, and VLM wrappers.

Layers run as a Python loop over ``num_groups`` pattern groups.
``scan_layers=True`` (a ``lax.scan`` over stacked group params in the JAX
package) runs the same loop and gives equal results.  ``cfg.remat`` (the
reference's ``jax.checkpoint`` around each group and the tail) wraps each
group in ``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``
while grad is enabled: the backward pass recomputes a group's activations
instead of keeping them.  Without grad (serving) it changes nothing.

:func:`decode_step` writes each layer's new K/V into the cache tensors of
``state`` in place (see
:func:`~repro_torch.models.attention.decode_attention`).
"""
from __future__ import annotations

import contextlib
import functools
from typing import Any

import torch
import torch.utils.checkpoint
from torch.distributed.tensor import DTensor, Replicate

from repro_torch import device as device_lib
from repro_torch.models import blocks as blk
from repro_torch.models.common import (ModelConfig, dense_init, rms_norm,
                                       softcap)
from repro_torch.sharding.api import (constrain, current_binding,
                                      replicated, use_mesh)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_lm(gen: torch.Generator, cfg: ModelConfig, *, device=None) -> dict:
    """Random parameters drawn from ``gen`` on ``device`` (the port's
    default device when None; ``gen`` must live there: a CUDA generator
    draws on the card).  The tree has the reference's structure and keys."""
    dev = device_lib.resolve(device)
    if gen.device.type != dev.type:
        raise ValueError(f"init_lm: generator on {gen.device}, parameters "
                         f"asked for on {dev}")
    pdt = cfg.param_dtype

    def init(shape, in_axis=0):
        return dense_init(gen, shape, in_axis, dtype=pdt, device=dev)

    params: dict[str, Any] = {
        "embed": init((cfg.vocab_size, cfg.d_model), in_axis=1),
        "final_norm": torch.zeros((cfg.d_model,), dtype=pdt, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init((cfg.d_model, cfg.vocab_size))
    params["groups"] = [
        {f"b{i}": blk.init_block(gen, cfg, kind, device=dev)
         for i, kind in enumerate(cfg.block_pattern)}
        for _ in range(cfg.num_groups)]
    if cfg.tail_pattern:
        params["tail"] = {f"b{i}": blk.init_block(gen, cfg, kind, device=dev)
                          for i, kind in enumerate(cfg.tail_pattern)}
    if cfg.enc_layers:
        params["enc_frontend"] = init((cfg.frontend_dim, cfg.d_model))
        params["encoder"] = [blk.init_block(gen, cfg, "encoder", device=dev)
                             for _ in range(cfg.enc_layers)]
        params["enc_norm"] = torch.zeros((cfg.d_model,), dtype=pdt,
                                         device=dev)
    elif cfg.frontend_dim:      # vlm: patch-embedding projector
        params["frontend"] = init((cfg.frontend_dim, cfg.d_model))
    return params


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _embed_scale(x, cfg: ModelConfig):
    if cfg.tie_embeddings:
        x = x * torch.sqrt(torch.tensor(cfg.d_model, dtype=cfg.compute_dtype,
                                        device=x.device))
    return x


def _lookup(table, ids):
    return table[ids]


def _embed(params, tokens, cfg: ModelConfig):
    # aten.index_put (the lookup's backward): torch 2.11's DTensor rule
    # fails on batch-sharded ids, so on a mesh each rank looks up its own
    # batch rows in the whole table
    x = replicated(_lookup, batched=(1,))(params["embed"], tokens) \
        .to(cfg.compute_dtype)
    return constrain(_embed_scale(x, cfg), "batch", "seq", "embed")


def _unembed(params, x, cfg: ModelConfig):
    x = rms_norm(x, params["final_norm"])
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x @ head.to(cfg.compute_dtype)
    logits = softcap(logits.float(), cfg.logits_softcap)
    return constrain(logits, "batch", "seq", "vocab")


def _add_aux(total, aux):
    if not aux:
        return total
    return dict(aux) if total is None else {k: total[k] + aux[k]
                                            for k in total}


def _group_fn(gparams, x, positions, cfg: ModelConfig, *, memory=None,
              memory_positions=None, local_impl="mask", pattern=None):
    aux_sum = None
    for i, kind in enumerate(pattern or cfg.block_pattern):
        x, aux = blk.apply_block(
            gparams[f"b{i}"], x, positions, cfg, kind, memory=memory,
            memory_positions=memory_positions, local_impl=local_impl)
        aux_sum = _add_aux(aux_sum, aux)
    return x, aux_sum


def _positions(s: int, device):
    """The positions 0..s-1 of every row, as one row (1, s) that
    broadcasts over the batch, as the reference's ``broadcast_to`` costs
    nothing in XLA.  A (b, s) tensor would be a constant of the whole
    batch on every rank under a mesh binding, and DTensor would split the
    rotary tables and masks made from it to each rank's rows, a copy a
    mesh dimension."""
    return torch.arange(s, device=device)[None]


def encode(params, frontend_feats, cfg: ModelConfig):
    """Encoder stack over precomputed (stubbed) frontend embeddings."""
    cdt = cfg.compute_dtype
    x = frontend_feats.to(cdt) @ params["enc_frontend"].to(cdt)
    x = constrain(x, "batch", "seq", "embed")
    positions = _positions(x.shape[1], x.device)
    for p in params["encoder"]:
        x, _ = blk.apply_block(p, x, positions, cfg, "encoder")
    return rms_norm(x, params["enc_norm"])


def _remat_contexts():
    """The contexts of a remat group's forward and of its recompute.  The
    recompute runs in the backward pass, for CUDA tensors on autograd's
    device thread, where the forward thread's mesh binding (thread-local,
    as DTensor's implicit replication is) is not set: it runs under the
    binding the forward saw."""
    binding = current_binding()
    return contextlib.nullcontext(), (
        use_mesh(*binding) if binding is not None
        else contextlib.nullcontext())


def forward(params, batch: dict, cfg: ModelConfig, *, scan_layers=False,
            local_impl="mask"):
    """Full-sequence forward -> (logits, aux).

    batch keys: "tokens" (B,S) int; optional "frontend" (B,Sf,frontend_dim)
    (audio frames / vision patches, precomputed per the assignment stub);
    optional "positions".  ``scan_layers`` selects nothing here: the scan
    and the unrolled loop are one loop in the port.
    """
    del scan_layers
    tokens = batch["tokens"]
    s = tokens.shape[1]
    x = _embed(params, tokens, cfg)
    memory = memory_positions = None
    if cfg.enc_layers:
        memory = encode(params, batch["frontend"], cfg)
        memory_positions = _positions(memory.shape[1], x.device)
    elif cfg.frontend_dim:
        cdt = cfg.compute_dtype
        prefix = batch["frontend"].to(cdt) @ params["frontend"].to(cdt)
        x = torch.cat([prefix, x], dim=1)
        s = x.shape[1]
    positions = batch.get("positions")
    if positions is None:
        positions = _positions(s, x.device)

    aux_total = None
    groups = [(g, None) for g in params["groups"]]
    if cfg.tail_pattern:
        groups.append((params["tail"], cfg.tail_pattern))
    remat = cfg.remat and torch.is_grad_enabled()
    for gparams, pattern in groups:
        gfn = functools.partial(_group_fn, cfg=cfg, memory=memory,
                                memory_positions=memory_positions,
                                local_impl=local_impl, pattern=pattern)
        if remat:
            x, aux = torch.utils.checkpoint.checkpoint(
                gfn, gparams, x, positions, use_reentrant=False,
                context_fn=_remat_contexts)
        else:
            x, aux = gfn(gparams, x, positions)
        aux_total = _add_aux(aux_total, aux)
    logits = _unembed(params, x, cfg)
    return logits, (aux_total or {})


def _target_logits(logits, targets):
    return torch.take_along_dim(
        logits, torch.clamp(targets, min=0)[..., None].long(), dim=-1)[..., 0]


def lm_loss(params, batch: dict, cfg: ModelConfig, **fw_kwargs):
    """Next-token cross entropy (mean over non-pad tokens) + MoE aux loss.

    Differentiable: ``torch.autograd.grad`` of the loss gives each float32
    master's gradient in float32 (the ``.to(cdt)`` casts carry it back), as
    ``jax.grad`` of the reference's does (see ``train.step``)."""
    logits, aux = forward(params, batch, cfg, **fw_kwargs)
    tokens = batch["tokens"]
    if cfg.frontend_dim and not cfg.enc_layers:    # vlm: skip patch prefix
        logits = logits[:, -tokens.shape[1]:]
    # aten.constant_pad_nd: torch 2.11's DTensor rule gives its output one
    # placement on a 2-D mesh, so the shifted targets are a cat
    targets = torch.cat([tokens[:, 1:], torch.full_like(tokens[:, :1], -1)],
                        dim=1)
    mask = (targets >= 0) & (batch.get("mask", torch.ones_like(tokens)) > 0)
    logz = torch.logsumexp(logits, dim=-1)
    # aten.gather over vocab-sharded logits: DTensor's vocab-parallel rule
    # fails to reduce it, and its backward makes zeros of the logits'
    # global shape on every rank, then splits them to the rank's rows a
    # mesh dimension at a time; so each rank gathers its own batch rows
    # of the logits, the vocab dimension gathered first
    tgt = replicated(_target_logits, batched=(0, 1))(logits, targets)
    nll = (logz - tgt) * mask
    loss = torch.sum(nll) / torch.clamp(torch.sum(mask), min=1)
    metrics = {"loss": loss, "tokens": torch.sum(mask)}
    if "aux_loss" in aux:
        loss = loss + aux["aux_loss"]
        metrics["moe_aux"] = aux["aux_loss"]
        metrics["moe_dropped"] = aux.get("dropped", 0)
        metrics["expert_load"] = aux.get("expert_load")
    return loss, metrics


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_decode_state(cfg: ModelConfig, batch: int, cache_len: int, *,
                      device=None) -> list:
    """Zeroed per-block decode state (K/V caches) on ``device`` (the port's
    default device when None)."""
    dev = device_lib.resolve(device)
    patterns = [cfg.block_pattern] * cfg.num_groups
    if cfg.tail_pattern:
        patterns.append(cfg.tail_pattern)
    return [{f"b{i}": blk.init_block_state(cfg, kind, batch, cache_len,
                                           device=dev)
             for i, kind in enumerate(pattern)} for pattern in patterns]


def decode_step(params, tokens, pos, state, cfg: ModelConfig, *,
                memory=None):
    """One token for every sequence.  tokens: int[B]; pos: i32[B].

    Returns (logits f32[B,V], new_state): ``new_state`` holds the same K/V
    cache tensors as ``state``, written in place.  ``memory``: the
    (encoder output, positions) pair of :func:`cross_memory` for enc-dec
    cross attention (projected per block on the fly).
    """
    table = params["embed"]
    if isinstance(table, DTensor):
        # aten.index: DTensor gathers a vocab-sharded table whole for it;
        # aten.embedding's rule looks each id up in the rank's own rows
        # and sums over the vocab's shards, here at once (torch 2.11
        # cannot reduce that masked partial sum after other ops)
        x = torch.nn.functional.embedding(tokens[:, None], table)
        x = x.redistribute(x.device_mesh, [
            Replicate() if p.is_partial() else p for p in x.placements])
    else:
        x = table[tokens[:, None]]
    x = x.to(cfg.compute_dtype)
    x = constrain(_embed_scale(x, cfg), "batch", None, "embed")
    new_state = []
    group_list = [(gp, cfg.block_pattern) for gp in params["groups"]]
    if cfg.tail_pattern:
        group_list.append((params["tail"], cfg.tail_pattern))
    for g, (gparams, pattern) in enumerate(group_list):
        gs = dict(state[g])
        for i, kind in enumerate(pattern):
            mem = memory if kind == "cross" else None
            x, gs[f"b{i}"] = blk.step_block(gparams[f"b{i}"], x, pos,
                                            state[g][f"b{i}"], cfg, kind,
                                            memory=mem)
        new_state.append(gs)
    logits = _unembed(params, x, cfg)
    return logits[:, 0], new_state


def cross_memory(params, cfg: ModelConfig, frontend_feats):
    """Precompute encoder memory K/V inputs for enc-dec decode."""
    mem = encode(params, frontend_feats, cfg)
    return mem, _positions(mem.shape[1], mem.device)
