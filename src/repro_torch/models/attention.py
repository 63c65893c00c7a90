"""Attention substrate: GQA with RoPE, qk-norm, bias, local windows, caches.

Covers every assigned attention variant:
  * MHA / GQA with arbitrary kv_heads (deepseek 32, qwen1.5 20, qwen3 8, ...)
  * qk_norm (qwen3), QKV bias (qwen1.5), logit softcap (grok)
  * sliding-window ("local") attention with either a banded mask (baseline)
    or exact chunked evaluation (optimised path for long prefill)
  * bidirectional encoder attention and cross attention (seamless enc-dec)
  * decode against a KV cache.

Attention is plain tensor code, as in the JAX package (no kernel): the
scores are float32 products of the compute-dtype q and k, the softmax is
float32, and the probabilities go back to the compute dtype before the
product with v.  :func:`decode_attention` writes the new K/V into the
cache in place (see its docstring).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import (ModelConfig, dense_init, rms_norm,
                                       rope, softcap)
from repro_torch.sharding.api import constrain

NEG_INF = -2.3819763e38


def init_attention(gen, cfg: ModelConfig, *, device=None) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    pdt = cfg.param_dtype
    p = {
        "wq": dense_init(gen, (d, h * hd), dtype=pdt, device=device),
        "wk": dense_init(gen, (d, kv * hd), dtype=pdt, device=device),
        "wv": dense_init(gen, (d, kv * hd), dtype=pdt, device=device),
        "wo": dense_init(gen, (h * hd, d), dtype=pdt, device=device),
    }
    dev = p["wq"].device
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h * hd,), dtype=pdt, device=dev)
        p["bk"] = torch.zeros((kv * hd,), dtype=pdt, device=dev)
        p["bv"] = torch.zeros((kv * hd,), dtype=pdt, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((hd,), dtype=pdt, device=dev)
        p["k_norm"] = torch.zeros((hd,), dtype=pdt, device=dev)
    return p


def _project_q(p, x, cfg: ModelConfig, positions):
    b, s, _ = x.shape
    cdt = cfg.compute_dtype
    q = x @ p["wq"].to(cdt)
    if cfg.qkv_bias:
        q = q + p["bq"].to(cdt)
    q = q.reshape(b, s, cfg.num_heads, cfg.hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
    q = rope(q, positions, cfg.rope_theta)
    return constrain(q, "batch", "seq", "heads", "head_dim")


def _project_kv(p, x, cfg: ModelConfig, positions):
    b, s, _ = x.shape
    cdt = cfg.compute_dtype
    k = x @ p["wk"].to(cdt)
    v = x @ p["wv"].to(cdt)
    if cfg.qkv_bias:
        k = k + p["bk"].to(cdt)
        v = v + p["bv"].to(cdt)
    k = k.reshape(b, s, cfg.num_kv_heads, cfg.hd)
    v = v.reshape(b, s, cfg.num_kv_heads, cfg.hd)
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm"])
    if positions is not None:
        k = rope(k, positions, cfg.rope_theta)
    k = constrain(k, "batch", "seq", "kv_heads", "head_dim")
    v = constrain(v, "batch", "seq", "kv_heads", "head_dim")
    return k, v


def _sdpa(q, k, v, mask, cfg: ModelConfig):
    """Grouped scaled dot-product attention.

    q: (B, Sq, H, hd); k/v: (B, Sk, KV, hd); mask: broadcastable to
    (B, KV, G, Sq, Sk) or None.

    q is scaled in its own dtype, then q and k go to float32 for the score
    product (the reference's ``preferred_element_type=float32``); the
    float32 softmax returns to q's dtype before the product with v.

    opt_level>=1 switches to the repeated-KV layout: scores carry the full
    H head dim.  The repeat costs O(S·H·hd) extra KV bytes.
    """
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    if cfg.opt_level >= 1:
        if g > 1:
            k = torch.repeat_interleave(k, g, dim=2)
            v = torch.repeat_interleave(v, g, dim=2)
        q = q * (hd ** -0.5)
        scores = torch.einsum("bqhd,bshd->bhqs", q.float(), k.float())
        scores = softcap(scores, cfg.logits_softcap)
        if mask is not None:
            if tuple(mask.shape[1:3]) != (1, 1):
                m = mask.expand((b, kv, g) + tuple(scores.shape[-2:])) \
                    .reshape(b, h, *scores.shape[-2:])
            else:
                m = mask.reshape(mask.shape[0], 1, *mask.shape[-2:])
            scores = torch.where(m, scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        return torch.einsum("bhqs,bshd->bqhd", probs, v)
    q = q.reshape(b, sq, kv, g, hd) * (hd ** -0.5)
    scores = torch.einsum("bqkgh,bskh->bkgqs", q.float(), k.float())
    scores = softcap(scores, cfg.logits_softcap)
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v)
    return out.reshape(b, sq, h, hd)


def _band_mask(q_pos, k_pos, window: int | None, causal: bool):
    """(B?, Sq, Sk) boolean mask; window is the local-attention band."""
    qp, kp = q_pos[..., :, None], k_pos[..., None, :]
    m = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                   dtype=torch.bool, device=q_pos.device)
    if causal:
        m &= qp >= kp
    if window is not None:
        m &= qp - kp < window
    return m


def attention(p, x, positions, cfg: ModelConfig, *, window: int | None,
              causal: bool = True, kv_x=None, kv_positions=None):
    """Full-sequence attention (training / prefill).  ``kv_x`` switches to
    cross attention (keys/values from encoder memory, no causal mask)."""
    q = _project_q(p, x, cfg, positions)
    if kv_x is None:
        k, v = _project_kv(p, x, cfg, positions)
        mask = _band_mask(positions, positions, window, causal)
    else:
        k, v = _project_kv(p, kv_x, cfg, kv_positions)
        mask = None
    if mask is not None:
        mask = mask[:, None, None]            # (B, 1, 1, Sq, Sk)
    out = _sdpa(q, k, v, mask, cfg)
    out = constrain(out, "batch", "seq", "heads", "head_dim")
    b, s, _, _ = out.shape
    y = out.reshape(b, s, -1) @ p["wo"].to(cfg.compute_dtype)
    return constrain(y, "batch", "seq", "embed")


def attention_blockwise(p, x, positions, cfg: ModelConfig, *,
                        q_chunk: int, window: int | None = None,
                        causal: bool = True):
    """Exact full attention evaluated per q-chunk.

    The (Sq, Sk) score matrix is never materialised whole, only
    (q_chunk, Sk) slabs.  Causal chunks additionally skip keys beyond the
    chunk's last query."""
    b, s, _ = x.shape
    q = _project_q(p, x, cfg, positions)
    k, v = _project_kv(p, x, cfg, positions)
    nq = -(-s // q_chunk)
    outs = []
    for i in range(nq):
        lo, hi = i * q_chunk, min((i + 1) * q_chunk, s)
        qp = positions[:, lo:hi]
        k_hi = hi if causal else s      # causal: keys beyond hi are masked
        mask = _band_mask(qp, positions[:, :k_hi], window, causal)
        outs.append(_sdpa(q[:, lo:hi], k[:, :k_hi], v[:, :k_hi],
                          mask[:, None, None], cfg))
    out = torch.cat(outs, dim=1)
    out = constrain(out, "batch", "seq", "heads", "head_dim")
    y = out.reshape(b, s, -1) @ p["wo"].to(cfg.compute_dtype)
    return constrain(y, "batch", "seq", "embed")


def attention_chunked_local(p, x, positions, cfg: ModelConfig, *,
                            window: int):
    """Exact sliding-window attention in O(S·w) instead of O(S²).

    The sequence is cut into chunks of length ``window``; each chunk attends
    to itself and its predecessor under the banded mask — exact for causal
    windows ≤ chunk length."""
    b, s, d = x.shape
    w = window
    if s % w or s < 2 * w:
        raise ValueError(f"chunked local attention needs S a multiple of "
                         f"the window and S >= 2 windows: S={s}, w={w}")
    q = _project_q(p, x, cfg, positions)
    k, v = _project_kv(p, x, cfg, positions)
    nc = s // w
    # (B, nc, w, H, hd); keys get a 2-window tail: [prev chunk | this chunk]
    qc = q.reshape(b, nc, w, cfg.num_heads, cfg.hd)
    kc = k.reshape(b, nc, w, cfg.num_kv_heads, cfg.hd)
    vc = v.reshape(b, nc, w, cfg.num_kv_heads, cfg.hd)
    # pad one chunk in front of dim 1 (F.pad lists dims from the last)
    k2 = torch.cat([F.pad(kc[:, :-1], (0, 0, 0, 0, 0, 0, 1, 0)), kc], dim=2)
    v2 = torch.cat([F.pad(vc[:, :-1], (0, 0, 0, 0, 0, 0, 1, 0)), vc], dim=2)
    pc = positions.reshape(b, nc, w)
    p2 = torch.cat([F.pad(pc[:, :-1], (0, 0, 1, 0), value=-10**9), pc],
                   dim=2)
    mask = _band_mask(pc, p2, w, causal=True)[:, :, None, None]  # B,nc,1,1,w,2w
    bn = b * nc
    out = _sdpa(qc.reshape(bn, w, cfg.num_heads, cfg.hd),
                k2.reshape(bn, 2 * w, cfg.num_kv_heads, cfg.hd),
                v2.reshape(bn, 2 * w, cfg.num_kv_heads, cfg.hd),
                mask.reshape(bn, 1, 1, w, 2 * w), cfg)
    y = out.reshape(b, s, cfg.num_heads * cfg.hd) @ p["wo"].to(
        cfg.compute_dtype)
    return constrain(y, "batch", "seq", "embed")


# ---------------------------------------------------------------------------
# decode (one new token against a cache)
# ---------------------------------------------------------------------------

def init_kv_cache(cfg: ModelConfig, batch: int, length: int,
                  dtype=None, *, device=None) -> dict:
    dtype = dtype or cfg.compute_dtype
    shape = (batch, length, cfg.num_kv_heads, cfg.hd)
    return {
        "k": constrain(torch.zeros(shape, dtype=dtype, device=device),
                       "batch", "cache_seq", "kv_heads", "head_dim"),
        "v": constrain(torch.zeros(shape, dtype=dtype, device=device),
                       "batch", "cache_seq", "kv_heads", "head_dim"),
    }


def decode_attention(p, x, pos, cache, cfg: ModelConfig, *,
                     window: int | None, kv_memory=None) -> tuple:
    """One-token decode step.  ``pos``: i32[B] absolute positions.

    The new (k, v) is written at ``pos % cache_len`` (ring semantics for
    local windows, linear for full caches — callers size the cache
    accordingly).  Attention itself runs over the full cache with a validity
    mask, so the same code serves both layouts.

    Unlike the reference, which returns an updated copy, the write goes
    into ``cache``'s tensors in place, and ``cache`` itself is returned:
    a copy per layer per step would move the whole cache each step.
    Callers that pass the returned state forward see the same values."""
    b = x.shape[0]
    positions = pos[:, None]                     # (B, 1)
    q = _project_q(p, x, cfg, positions)
    if kv_memory is not None:                    # cross attention: no cache
        k, v = kv_memory
        out = _sdpa(q, k, v, None, cfg)
        y = out.reshape(b, 1, -1) @ p["wo"].to(cfg.compute_dtype)
        return constrain(y, "batch", None, "embed"), cache
    k_new, v_new = _project_kv(p, x, cfg, positions)
    k, v = cache["k"], cache["v"]
    length = k.shape[1]
    slot = (pos % length).long()                 # (B,)
    rows = torch.arange(b, device=x.device)
    k[rows, slot] = k_new[:, 0].to(k.dtype)
    v[rows, slot] = v_new[:, 0].to(v.dtype)
    # validity: linear-fill semantics, as in the reference (a ring that
    # wrapped counts every slot as written)
    slots = torch.arange(length, device=x.device)[None, :]   # (1, L)
    written = slots <= pos[:, None]
    if window is not None:
        written &= slots > pos[:, None] - window
    mask = written[:, None, None, None, :]       # (B,1,1,1,L)
    out = _sdpa(q, k, v, mask, cfg)
    y = out.reshape(b, 1, -1) @ p["wo"].to(cfg.compute_dtype)
    y = constrain(y, "batch", None, "embed")
    return y, cache
