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
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.models.common import (ModelConfig, dense_init, rms_norm,
                                       rope, softcap)
from repro_torch.sharding.api import constrain, grad_as_value

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


def _split_heads(t, n: int):
    """(B, S, n * hd) -> (B, S, n, hd).

    aten.view: DTensor cannot split a sharded dimension whose leading
    factor ``n`` the shard count does not divide (gemma3's 4 heads on a
    16-way ``model`` axis), so such a projection is gathered over those
    mesh dimensions first; the heads then stay whole, as the filtered
    ``constrain`` after the split leaves them."""
    if isinstance(t, DTensor):
        split = [isinstance(p, Shard) and p.dim == 2 for p in t.placements]
        count = 1
        for size, on in zip(t.device_mesh.shape, split):
            count *= size if on else 1
        if n % count:
            t = t.redistribute(t.device_mesh, [
                Replicate() if on else p
                for p, on in zip(t.placements, split)])
    b, s, _ = t.shape
    return t.reshape(b, s, n, -1)


def _merge_heads(t):
    """(B, S, n, hd) -> (B, S, n * hd).

    aten.view in the backward: where the heads stay whole in the forward
    (a head count the shard count does not divide, as in
    :func:`_split_heads`), the gradient may still come back from the
    output projection sharded over the n * hd columns (torch 2.11, which
    then cannot split them into heads: arctic's 56 heads on a 16-way
    ``model`` axis) or partial (2.13, whose score products' backward then
    places the heads as a ``_StridedShard`` it cannot propagate), so it
    is placed as the forward's value before the view."""
    b, s, n, _ = t.shape
    out = t.reshape(b, s, -1)
    if isinstance(out, DTensor) and not any(
            isinstance(p, Shard) and p.dim == 2 for p in out.placements):
        out = grad_as_value(out)
    return out


def _project_q(p, x, cfg: ModelConfig, positions):
    cdt = cfg.compute_dtype
    q = x @ p["wq"].to(cdt)
    if cfg.qkv_bias:
        q = q + p["bq"].to(cdt)
    q = _split_heads(q, cfg.num_heads)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
    q = rope(q, positions, cfg.rope_theta)
    return constrain(q, "batch", "seq", "heads", "head_dim")


def _project_kv(p, x, cfg: ModelConfig, positions):
    cdt = cfg.compute_dtype
    k = x @ p["wk"].to(cdt)
    v = x @ p["wv"].to(cdt)
    if cfg.qkv_bias:
        k = k + p["bk"].to(cdt)
        v = v + p["bv"].to(cdt)
    k = _split_heads(k, cfg.num_kv_heads)
    v = _split_heads(v, cfg.num_kv_heads)
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm"])
    if positions is not None:
        k = rope(k, positions, cfg.rope_theta)
    k = constrain(k, "batch", "seq", "kv_heads", "head_dim")
    v = constrain(v, "batch", "seq", "kv_heads", "head_dim")
    return k, v


def _sdpa(q, k, v, mask, cfg: ModelConfig, kv_seq: str = "seq"):
    """Grouped scaled dot-product attention.

    q: (B, Sq, H, hd); k/v: (B, Sk, KV, hd); mask: broadcastable to
    (B, KV, G, Sq, Sk) or None.  ``kv_seq``: the logical axis of k's and
    v's sequence (``cache_seq`` for a decode cache).

    q is scaled in its own dtype, then q and k go to float32 for the score
    product (the reference's ``preferred_element_type=float32``); the
    float32 softmax returns to q's dtype before the product with v.

    opt_level>=1 switches to the repeated-KV layout: scores carry the full
    H head dim.  The repeat costs O(S·H·hd) extra KV bytes.
    """
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    # aten._unsafe_view: DTensor (torch 2.11) cannot flatten the score
    # einsums' batch and head dimensions when both carry a shard, so on a
    # mesh the heads are gathered first (a no-op elsewhere)
    q = constrain(q, "batch", "seq", None, "head_dim")
    k = constrain(k, "batch", kv_seq, None, "head_dim")
    v = constrain(v, "batch", kv_seq, None, "head_dim")
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
    y = _merge_heads(out) @ p["wo"].to(cfg.compute_dtype)
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
    # one chunk in front of dim 1, as a cat (aten.constant_pad_nd: torch
    # 2.11's DTensor rule gives its output one placement on a 2-D mesh)
    def prev(t, fill):
        return torch.cat([torch.full_like(t[:, :1], fill), t[:, :-1]], dim=1)
    k2 = torch.cat([prev(kc, 0), kc], dim=2)
    v2 = torch.cat([prev(vc, 0), vc], dim=2)
    pc = positions.expand(b, s).reshape(b, nc, w)
    p2 = torch.cat([prev(pc, -10**9), pc], dim=2)
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


def _write_shards(cache, slot, new) -> None:
    """``cache[b, slot[b]] = new[b]`` for every row ``b``, in place, on a
    DTensor cache: each rank writes the rows of its own shard.

    aten.index_put_: DTensor has no in-place rule for a cache sharded
    over the batch and the cache sequence (the ``decode`` rules), so each
    rank takes its batch rows of ``slot`` and ``new``, and writes the
    slots that fall in its span of the sequence into its local shard; a
    row whose slot lies on another rank writes back what it holds."""
    mesh, placements = cache.device_mesh, cache.placements
    local = cache.to_local()
    span = local.shape[1]
    # this rank's first slot: its index among the sequence's shards (the
    # first mesh dimension the major), times the shard's length
    first = 0
    for size, coord, p in zip(mesh.shape, mesh.get_coordinate(),
                              placements):
        if isinstance(p, Shard) and p.dim == 1:
            first = first * size + coord
    first *= span
    # the new row's dimension d is the cache's d + 1 past the batch
    row_pl = tuple(p if isinstance(p, Shard) and p.dim == 0 else
                   Shard(p.dim - 1) if isinstance(p, Shard) and p.dim > 1
                   else Replicate() for p in placements)
    slot_pl = tuple(p if isinstance(p, Shard) and p.dim == 0 else
                    Replicate() for p in placements)
    new = new.redistribute(mesh, row_pl).to_local().to(local.dtype)
    at = slot.redistribute(mesh, slot_pl).to_local() - first
    mine = (at >= 0) & (at < span)
    at = at.clamp(0, span - 1)
    rows = torch.arange(local.shape[0], device=local.device)
    keep = (slice(None),) + (None,) * (new.ndim - 1)
    local[rows, at] = torch.where(mine[keep], new, local[rows, at])


def _project_out(out, p, cfg: ModelConfig):
    """A decode step's heads (B, 1, H, hd) through ``wo``: (B, 1, D), as
    one (B, H*hd) product.  ``matmul`` of the (B, 1, H*hd) view folds it
    so only when the view's strides allow, and a DTensor's global strides
    on a mesh with the batch over two dimensions do not: it then expands
    ``wo`` over the batch and splits that copy to each rank's rows."""
    b = out.shape[0]
    return (out.reshape(b, -1) @ p["wo"].to(cfg.compute_dtype)).unsqueeze(1)


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
        y = _project_out(out, p, cfg)
        return constrain(y, "batch", None, "embed"), cache
    k_new, v_new = _project_kv(p, x, cfg, positions)
    k, v = cache["k"], cache["v"]
    length = k.shape[1]
    slot = (pos % length).long()                 # (B,)
    if isinstance(k, DTensor):
        _write_shards(k, slot, k_new[:, 0])
        _write_shards(v, slot, v_new[:, 0])
    else:
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
    # the cache keeps its sequence shard: the scores come out sharded
    # over it, DTensor gathers them for the softmax, and the product with
    # v sums each rank's slots (no rank gathers the cache)
    out = _sdpa(q, k, v, mask, cfg, kv_seq="cache_seq")
    y = constrain(_project_out(out, p, cfg), "batch", None, "embed")
    return y, cache
