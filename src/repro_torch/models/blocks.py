"""Block assembly: one residual block per ``block_pattern`` entry.

Block types:
  "dense"  — pre-norm GQA attention + SwiGLU MLP (llama family)
  "local"  — same with sliding-window attention (gemma3, recurrentgemma)
  "moe"    — attention + top-k MoE FFN (grok; arctic via dense_residual)
  "rglru"  — RG-LRU temporal mix + SwiGLU MLP (recurrentgemma)
  "rwkv"   — RWKV-6 time mix + channel mix
  "cross"  — self-attention + cross-attention + MLP (enc-dec decoder)
  "encoder"— bidirectional attention + MLP (enc-dec encoder)

Every block exposes init / apply (full sequence) / step (one-token decode
with explicit state) so the same definitions serve prefill and decode.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import recurrent as rec_lib
from repro_torch.models.common import ModelConfig, dense_init, rms_norm
from repro_torch.sharding.api import constrain
from repro_torch.spans import span


def init_mlp(gen, cfg: ModelConfig, *, device=None) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    pdt = cfg.param_dtype
    return {
        "gate": dense_init(gen, (d, f), dtype=pdt, device=device),
        "up": dense_init(gen, (d, f), dtype=pdt, device=device),
        "down": dense_init(gen, (f, d), dtype=pdt, device=device),
    }


def mlp(p, x, cfg: ModelConfig):
    cdt = cfg.compute_dtype
    h = F.silu(x @ p["gate"].to(cdt)) * (x @ p["up"].to(cdt))
    h = constrain(h, "batch", "seq", "mlp")
    return constrain(h @ p["down"].to(cdt), "batch", "seq", "embed")


def init_block(gen, cfg: ModelConfig, kind: str, *, device=None) -> dict:
    pdt = cfg.param_dtype
    d = cfg.d_model
    dev = gen.device if device is None else device
    p = {"ln1": torch.zeros((d,), dtype=pdt, device=dev),
         "ln2": torch.zeros((d,), dtype=pdt, device=dev)}
    if kind in ("dense", "local", "moe", "encoder"):
        p["attn"] = attn_lib.init_attention(gen, cfg, device=device)
        p["ffn"] = moe_lib.init_moe(gen, cfg, device=device) \
            if kind == "moe" else init_mlp(gen, cfg, device=device)
    elif kind == "cross":
        p["attn"] = attn_lib.init_attention(gen, cfg, device=device)
        p["xattn"] = attn_lib.init_attention(gen, cfg, device=device)
        p["ln_x"] = torch.zeros((d,), dtype=pdt, device=dev)
        p["ffn"] = init_mlp(gen, cfg, device=device)
    elif kind == "rglru":
        p["mix"] = rec_lib.init_rglru(gen, cfg, device=device)
        p["ffn"] = init_mlp(gen, cfg, device=device)
    elif kind == "rwkv":
        # unused except layer 0 by convention; kept for the tree's keys
        p["ln0"] = torch.zeros((d,), dtype=pdt, device=dev)
        p["mix"] = rec_lib.init_rwkv_tmix(gen, cfg, device=device)
        p["ffn"] = rec_lib.init_rwkv_cmix(gen, cfg, device=device)
    else:
        raise ValueError(kind)
    return p


def _self_attention(p, h, positions, cfg: ModelConfig, kind: str,
                    local_impl: str):
    """The attention entry a block of ``kind`` runs over the sequence."""
    s = h.shape[1]
    if kind in ("dense", "moe"):
        if cfg.attn_qchunk and s > cfg.attn_qchunk:
            return attn_lib.attention_blockwise(p, h, positions, cfg,
                                                q_chunk=cfg.attn_qchunk)
        return attn_lib.attention(p, h, positions, cfg, window=None)
    if kind == "local":
        if local_impl == "chunked" and s % cfg.window == 0 \
                and s >= 2 * cfg.window:
            return attn_lib.attention_chunked_local(p, h, positions, cfg,
                                                    window=cfg.window)
        return attn_lib.attention(p, h, positions, cfg, window=cfg.window)
    return attn_lib.attention(p, h, positions, cfg, window=None,
                              causal=kind != "encoder")


def apply_block(p, x, positions, cfg: ModelConfig, kind: str, *,
                memory=None, memory_positions=None, local_impl: str = "mask"):
    """Full-sequence forward.  Returns (y, aux).  Each attention call is
    the span ``model/attention`` (:mod:`repro_torch.spans`)."""
    aux = {}
    x = constrain(x, "batch", "resid_seq", "embed")
    h = constrain(rms_norm(x, p["ln1"]), "batch", "resid_seq", "embed")
    if kind in ("dense", "moe", "local", "encoder", "cross"):
        with span("model/attention"):
            a = _self_attention(p["attn"], h, positions, cfg, kind,
                                local_impl)
    elif kind == "rglru":
        a, _ = rec_lib.rglru_block(p["mix"], h, cfg)
    elif kind == "rwkv":
        a, _ = rec_lib.rwkv_tmix(p["mix"], h, cfg)
    else:
        raise ValueError(kind)
    x = x + a
    if kind == "cross":
        hx = rms_norm(x, p["ln_x"])
        with span("model/attention"):
            y = attn_lib.attention(p["xattn"], hx, positions, cfg,
                                   window=None, kv_x=memory,
                                   kv_positions=memory_positions)
        x = x + y
    h2 = constrain(rms_norm(x, p["ln2"]), "batch", "resid_seq", "embed")
    if kind == "moe":
        f, aux = moe_lib.moe_ffn(p["ffn"], h2, cfg)
    elif kind == "rwkv":
        f, _ = rec_lib.rwkv_cmix(p["ffn"], h2, cfg)
    else:
        f = mlp(p["ffn"], h2, cfg)
    return constrain(x + f, "batch", "resid_seq", "embed"), aux


# ---------------------------------------------------------------------------
# decode: explicit per-block state
# ---------------------------------------------------------------------------

def init_block_state(cfg: ModelConfig, kind: str, batch: int,
                     cache_len: int, *, device=None) -> dict:
    if kind in ("dense", "moe", "encoder", "cross"):
        return {"kv": attn_lib.init_kv_cache(cfg, batch, cache_len,
                                             device=device)}
    if kind == "local":
        return {"kv": attn_lib.init_kv_cache(cfg, batch,
                                             min(cfg.window, cache_len),
                                             device=device)}
    if kind == "rglru":
        return {"rec": rec_lib.init_rglru_state(cfg, batch, device=device)}
    if kind == "rwkv":
        return {"rec": rec_lib.init_rwkv_state(cfg, batch, device=device),
                "cmix_prev": torch.zeros((batch, 1, cfg.d_model),
                                         dtype=cfg.compute_dtype,
                                         device=device)}
    raise ValueError(kind)


def step_block(p, x, pos, state, cfg: ModelConfig, kind: str, *,
               memory=None):
    """One-token decode.  x: (B,1,D), pos: i32[B].  Returns (y, new_state);
    the K/V cache in ``state`` is written in place (see
    :func:`~repro_torch.models.attention.decode_attention`); a recurrent
    block's state comes back as new tensors."""
    h = rms_norm(x, p["ln1"])
    new_state = dict(state)
    if kind in ("dense", "moe", "encoder", "cross", "local"):
        with span("model/attention"):
            a, new_state["kv"] = attn_lib.decode_attention(
                p["attn"], h, pos, state["kv"], cfg,
                window=cfg.window if kind == "local" else None)
    elif kind == "rglru":
        a, new_state["rec"] = rec_lib.rglru_step(p["mix"], h, state["rec"],
                                                 cfg)
    elif kind == "rwkv":
        a, new_state["rec"] = rec_lib.rwkv_tmix_step(p["mix"], h,
                                                     state["rec"], cfg)
    else:
        raise ValueError(kind)
    x = x + a
    if kind == "cross":
        hx = rms_norm(x, p["ln_x"])
        mem_x, mem_pos = memory
        with span("model/attention"):
            kv = attn_lib._project_kv(p["xattn"], mem_x, cfg, mem_pos)
            y, _ = attn_lib.decode_attention(p["xattn"], hx, pos,
                                             state["kv"], cfg, window=None,
                                             kv_memory=kv)
        x = x + y
    h2 = rms_norm(x, p["ln2"])
    if kind == "moe":
        f, _ = moe_lib.moe_ffn(p["ffn"], h2, cfg)
    elif kind == "rwkv":
        f, new_state["cmix_prev"] = rec_lib.rwkv_cmix(
            p["ffn"], h2, cfg, prev=state["cmix_prev"])
    else:
        f = mlp(p["ffn"], h2, cfg)
    return x + f, new_state
