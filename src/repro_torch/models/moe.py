"""Mixture-of-Experts FFN: top-k routing with capacity, cumsum dispatch.

Covers grok-1 (8 experts, top-2) and arctic (128 experts, top-2 **plus** a
dense residual MLP in parallel).

Dispatch is sort-free: position-in-expert comes from a cumsum over the
token-choice one-hot (GShard style), tokens beyond capacity are dropped
(and counted), and combine gathers each kept token's expert output back,
weighted by its router probability.  An auxiliary load-balance loss
(Switch §2.2) is returned beside the routing stats — expert imbalance is
one of the serialization bottlenecks the GAPP profiler is pointed at (a hot
expert serializes the all-to-all).

The dispatch is a scatter-add (``index_put_(accumulate=True)``) into a
zeroed (B, E, C, D) buffer.  A dropped token adds ±0.0 into slot C-1, as
in the reference, so every slot receives at most one non-zero term and the
order of the adds (atomics on CUDA) cannot change a value.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import ModelConfig, dense_init
from repro_torch.sharding.api import constrain, replicated


def init_moe(gen, cfg: ModelConfig, *, device=None) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    pdt = cfg.param_dtype
    p = {
        "router": dense_init(gen, (d, e), dtype=torch.float32,
                             device=device),
        "we_gate": dense_init(gen, (e, d, f), in_axis=1, dtype=pdt,
                              device=device),
        "we_up": dense_init(gen, (e, d, f), in_axis=1, dtype=pdt,
                            device=device),
        "we_down": dense_init(gen, (e, f, d), in_axis=1, dtype=pdt,
                              device=device),
    }
    if cfg.dense_residual:
        p["dense_gate"] = dense_init(gen, (d, f), dtype=pdt, device=device)
        p["dense_up"] = dense_init(gen, (d, f), dtype=pdt, device=device)
        p["dense_down"] = dense_init(gen, (f, d), dtype=pdt, device=device)
    return p


def _capacity(cfg: ModelConfig, tokens_per_group: int) -> int:
    c = int(cfg.capacity_factor * cfg.top_k * tokens_per_group
            / max(cfg.num_experts, 1))
    return max(4, -(-c // 4) * 4)            # round up to a multiple of 4


def _route(x, router):
    """The router's float32 logits: (B,S,D) -> (B,S,E)."""
    return x.float() @ router


def _dispatch(x, top_e, keep, pos, e: int, cap: int, cdt):
    """(B,S,k) scatter-add of the kept choices -> (B,E,C,D)."""
    b, s, k = top_e.shape
    d = x.shape[-1]
    idx_b = torch.arange(b, device=x.device)[:, None].expand(b, s * k)
    idx_e = top_e.reshape(b, s * k)
    idx_c = torch.where(keep, pos, cap).reshape(b, s * k).clamp(max=cap - 1)
    src = x[:, :, None].expand(b, s, k, d).reshape(b, s * k, d).to(cdt)
    src = src * keep.reshape(b, s * k, 1)
    expert_in = torch.zeros((b, e, cap, d), dtype=cdt, device=x.device)
    expert_in.index_put_((idx_b, idx_e, idx_c.long()), src, accumulate=True)
    return expert_in


def _experts(expert_in, wg, wu, wd):
    """The experts' SwiGLU: (B,E,C,D) -> (B,E,C,D)."""
    h = F.silu(torch.einsum("becd,edf->becf", expert_in, wg)) \
        * torch.einsum("becd,edf->becf", expert_in, wu)
    # as in the reference; on a mesh this runs unbound (replicated), and
    # the constraint passes h through
    h = constrain(h, "batch", "experts_act", None, "expert_mlp")
    return torch.einsum("becf,efd->becd", h, wd)


def _combine(expert_out, top_e, keep, pos, top_p, cdt):
    """(B,E,C,D) -> (B,S,D): each kept choice's expert output gathered
    back, weighted by its router probability."""
    b, s, k = top_e.shape
    d = expert_out.shape[-1]
    idx_b = torch.arange(b, device=expert_out.device)[:, None].expand(
        b, s * k)
    idx_e = top_e.reshape(b, s * k)
    gather_c = torch.where(keep, pos, 0).reshape(b, s * k).long()
    src = expert_out[idx_b, idx_e, gather_c]               # (B,S*k,D)
    wgt = (keep.reshape(b, s * k, 1) * top_p.reshape(b, s * k, 1)).to(cdt)
    return torch.sum((src * wgt).reshape(b, s, k, d), dim=2)


def moe_ffn(p, x, cfg: ModelConfig):
    """x: (B, S, D) -> (B, S, D), aux metrics dict.

    Groups are batch rows (B groups of S tokens): routing, capacity and the
    dispatch/combine are per group.  ``aux`` holds ``aux_loss`` (float32),
    ``expert_load`` (int32[E], choices per expert) and ``dropped`` (the
    number of choices beyond capacity), each a tensor.
    """
    b, s, _ = x.shape
    e, k = cfg.num_experts, cfg.top_k
    cdt = cfg.compute_dtype
    cap = _capacity(cfg, s)

    # router: aten.mm in the weight's backward over the flattened tokens,
    # whose gradient DTensor (torch 2.13) places as a _StridedShard that
    # its propagation resolves with a data-dependent op (fake tensors
    # refuse it), so on a mesh the product runs on each rank's batch rows
    logits = replicated(_route, batched=(0,))(x, p["router"])  # (B,S,E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1)            # (B,S,k)
    top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)

    # position-in-expert via cumsum over the flattened (S*k) choice sequence,
    # k-th choices ranked after all (k-1)-th choices (GShard ordering).
    choice_eh = F.one_hot(top_e, e).to(torch.int32)        # (B,S,k,E)
    flat = choice_eh.permute(0, 2, 1, 3).reshape(b, s * k, e)
    pos = torch.cumsum(flat, dim=1, dtype=torch.int32) - 1  # (B,S*k,E)
    pos = torch.sum(pos * flat, dim=-1, dtype=torch.int32) \
        .reshape(b, k, s).permute(0, 2, 1)                 # (B,S,k)
    keep = pos < cap                                       # (B,S,k)
    dropped = torch.sum(~keep)

    # dispatch: aten.index_put_ has no DTensor rule, so on a mesh it runs
    # on each rank's batch rows, whole in every other dimension
    expert_in = replicated(_dispatch, batched=(0, 1, 2, 3))(
        x, top_e, keep, pos, e, cap, cdt)
    expert_in = constrain(expert_in, "batch", "experts_act", None, "embed")

    # expert FFN (SwiGLU): aten.view in the expert einsums' backward fails
    # on DTensor's sharding of their grads, so on a mesh they run on each
    # rank's batch rows with every expert's weights whole
    expert_out = replicated(_experts, batched=(0,))(
        expert_in, p["we_gate"].to(cdt), p["we_up"].to(cdt),
        p["we_down"].to(cdt))
    expert_out = constrain(expert_out, "batch", "experts_act", None, "embed")

    # combine: aten.index_put in the gather's backward (torch 2.11's
    # DTensor rule fails on the batch-sharded values), so on a mesh it too
    # runs on each rank's batch rows
    y = replicated(_combine, batched=(0, 1, 2, 3, 4))(
        expert_out, top_e, keep, pos, top_p, cdt)
    y = constrain(y, "batch", "seq", "embed")

    if cfg.dense_residual:
        # x @ w.astype(cdt) in the reference promotes a wider x (a float32
        # input) over the rounded weights; torch needs that written out
        rdt = torch.promote_types(x.dtype, cdt)

        def dense(name):
            return p[name].to(cdt).to(rdt)
        hd_ = F.silu(x @ dense("dense_gate")) * (x @ dense("dense_up"))
        hd_ = constrain(hd_, "batch", "seq", "mlp")
        y = y + hd_ @ dense("dense_down")

    # Switch-style load-balance auxiliary loss + routing stats
    frac_tokens = torch.mean(F.one_hot(top_e[..., 0], e).float(),
                             dim=(0, 1))
    frac_probs = torch.mean(probs, dim=(0, 1))
    aux = {
        "aux_loss": cfg.router_aux_weight * e
        * torch.sum(frac_tokens * frac_probs),
        "expert_load": torch.sum(
            torch.sum(choice_eh, dim=2).reshape(-1, e), dim=0,
            dtype=torch.int32),
        "dropped": dropped,
    }
    return y, aux
