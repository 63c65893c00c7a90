"""Attention substrate: GQA with RoPE, qk-norm, bias, local windows, caches.

Covers every assigned attention variant:
  * MHA / GQA with arbitrary kv_heads (deepseek 32, qwen1.5 20, qwen3 8, ...)
  * qk_norm (qwen3), QKV bias (qwen1.5), logit softcap (grok)
  * sliding-window ("local") attention with either a banded mask (baseline)
    or exact chunked evaluation (optimised path for long prefill)
  * bidirectional encoder attention and cross attention (seamless enc-dec)
  * decode against a KV cache.

Training, prefill, cross attention and the sharded decode are plain tensor
code, as in the JAX package: the scores are float32 products of the
compute-dtype q and k, the softmax is float32, and the probabilities go
back to the compute dtype before the product with v.  The single-card
decode step's attention over its cache goes through
:func:`repro_torch.kernels.ops.decode_attention`: on the card a
hand-written kernel (one pass over each slot's written rows, the weights
kept in float32), on the CPU its plain version (this arithmetic over those
rows).  :func:`decode_attention` writes the new K/V into the cache in
place (see its docstring).
"""
from __future__ import annotations

import functools
import math

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.common import (ModelConfig, dense_init, rms_norm,
                                       rope, softcap)
from repro_torch.sharding.api import (axis_sizes, constrain,
                                      current_binding, filter_spec,
                                      grad_as_value, local_block)

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


_Q_AXES = ("batch", "seq", "heads", "head_dim")
_KV_AXES = ("batch", "seq", "kv_heads", "head_dim")
_MASK_AXES = ("batch", None, None, None, None)


def _sdpa(q, k, v, mask, cfg: ModelConfig, kv_seq: str = "seq"):
    """Grouped scaled dot-product attention.

    q: (B, Sq, H, hd); k/v: (B, Sk, KV, hd); mask: broadcastable to
    (B, KV, G, Sq, Sk) or None.  ``kv_seq``: the logical axis of k's and
    v's sequence (``cache_seq`` for a decode cache).

    On a mesh that shards the heads (and not the sequence), each rank
    computes its own heads, as the reference's constraints place them
    (:func:`_sdpa_heads`).  On a mesh that shards a decode cache's
    sequence, each rank attends over its slice of the cache and the
    slices are combined as flash-decode combines them
    (:func:`_sdpa_cache_slice`), where GSPMD splits the reference's
    softmax reductions so.  Elsewhere the heads are whole: on a mesh, q
    is placed so, and so are k and v (a no-op but where the rules shard
    them).
    """
    if kv_seq == "seq" and _heads_sharded(q):
        return local_block(
            functools.partial(_sdpa_heads, cfg=cfg),
            (_Q_AXES, _KV_AXES, _KV_AXES, _MASK_AXES), _Q_AXES,
            offsets=True)(q, k, v, mask)
    group = _group(k, _CACHE_AXES, 1) if kv_seq == "cache_seq" else None
    if group is not None:
        return local_block(
            functools.partial(_sdpa_cache_slice, cfg=cfg, group=group,
                              heads=_group(q, _Q_AXES, 2)),
            (_Q_AXES, _CACHE_AXES, _CACHE_AXES, _MASK_AXES),
            _Q_WHOLE_AXES, offsets=True)(q, k, v, mask)
    # aten._unsafe_view: DTensor (torch 2.11) cannot flatten the score
    # einsums' batch and head dimensions when both carry a shard, so q's
    # heads are gathered; passed on unnamed, so that no placed copy
    # outlives its use
    return _sdpa_math(constrain(q, "batch", "seq", None, "head_dim"),
                      constrain(k, "batch", kv_seq, None, "head_dim"),
                      constrain(v, "batch", kv_seq, None, "head_dim"),
                      mask, cfg)


_Q_WHOLE_AXES = ("batch", "seq", None, "head_dim")
_CACHE_AXES = ("batch", "cache_seq", "kv_heads", "head_dim")


def _group(t, axes: tuple, dim: int):
    """The process group of the mesh axes that the active binding shards
    the DTensor ``t``'s dimension ``dim`` over, ``t`` named by the logical
    ``axes`` (None where it is not a DTensor, or the axes hold one
    rank)."""
    b = current_binding()
    if b is None or not isinstance(t, DTensor):
        return None
    mesh, rules = b
    entry = filter_spec(tuple(t.shape), rules.spec(*axes), mesh)[dim]
    names = () if entry is None else \
        entry if isinstance(entry, tuple) else (entry,)
    if math.prod(axis_sizes(mesh)[a] for a in names) < 2:
        return None
    if len(names) == 1:
        return mesh.get_group(names[0])
    # make_mesh gives every run of adjacent dimensions its group
    return mesh[names]._flatten().get_group()


def _heads_sharded(q) -> bool:
    """True where the active binding shards q's heads and not its
    sequence (a head count the shard count does not divide stays whole,
    as the reference's filtered constraint leaves it)."""
    b = current_binding()
    if b is None or not isinstance(q, DTensor):
        return False
    mesh, rules = b
    spec = filter_spec(tuple(q.shape), rules.spec(*_Q_AXES), mesh)
    return spec[2] is not None and spec[1] is None


def _sdpa_heads(q, k, v, mask, *, cfg: ModelConfig, offsets):
    """One rank's block of :func:`_sdpa`: its q heads against the kv heads
    of their groups, taken from the rank's k and v (whole in heads unless
    the rules shard them)."""
    h0, hl = offsets[0][2], q.shape[2]
    g = cfg.num_heads // cfg.num_kv_heads
    lo, hi = h0 // g, (h0 + hl - 1) // g + 1
    k = k[:, :, lo - offsets[1][2]:hi - offsets[1][2]]
    v = v[:, :, lo - offsets[2][2]:hi - offsets[2][2]]
    if hi - lo > 1 and (h0 % g or hl % g):
        # the heads do not split into whole groups: a kv head each
        k = k.repeat_interleave(g, dim=2)[:, :, h0 - lo * g:][:, :, :hl]
        v = v.repeat_interleave(g, dim=2)[:, :, h0 - lo * g:][:, :, :hl]
    return _sdpa_math(q, k, v, mask, cfg)


def _sdpa_math(q, k, v, mask, cfg: ModelConfig):
    """:func:`_sdpa` on the tensors as they are.

    q is scaled in its own dtype, then q and k go to float32 for the score
    product (the reference's ``preferred_element_type=float32``); the
    float32 softmax returns to q's dtype before the product with v.

    opt_level>=1 switches to the repeated-KV layout: scores carry the full
    H head dim.  The repeat costs O(S·H·hd) extra KV bytes.
    """
    scores, v = _scores(q, k, v, mask, cfg)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    if scores.ndim == 4:
        return torch.einsum("bhqs,bshd->bqhd", probs, v)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v)
    return out.reshape(q.shape)


def _scores(q, k, v, mask, cfg: ModelConfig):
    """The masked float32 scores of :func:`_sdpa_math`, (B, H, Sq, Sk) at
    ``opt_level >= 1`` (k and v repeated to H heads) or (B, KV, G, Sq,
    Sk), and the v they meet."""
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
        return scores, v
    q = q.reshape(b, sq, kv, g, hd) * (hd ** -0.5)
    scores = torch.einsum("bqkgh,bskh->bkgqs", q.float(), k.float())
    scores = softcap(scores, cfg.logits_softcap)
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    return scores, v


def _sdpa_cache_slice(q, k, v, mask, *, cfg: ModelConfig, group, heads,
                      offsets):
    """One rank's part of :func:`_sdpa` over a cache whose sequence is
    sharded over ``group``: q, its heads gathered over ``heads`` (None:
    whole already), against the rank's slice of k and v and its slots of
    the mask, the scores as :func:`_sdpa_math` makes them (softcap, the
    mask, both layouts), and the slices' softmaxes combined by
    :func:`flash_combine`.  Returns (B, Sq, H, hd), the same on every rank
    of ``group``.  The gathered q and the mask's slots are made here, and
    the gathered q is passed on unnamed, so that neither outlives its use
    (a rank's placed arguments live until the block returns).  No
    gradient crosses the collectives: this serves decode, which runs
    without one."""
    b, sq, _, hd = q.shape
    dtype, shape = q.dtype, (b, sq, cfg.num_heads, hd)
    if mask is not None:
        s0 = offsets[1][1]
        mask = mask[..., s0:s0 + k.shape[1]]
    scores, v = _scores(q if heads is None else _all_gather(q, 2, heads),
                        k, v, mask, cfg)
    m, l, w = flash_partials(scores)
    if scores.ndim == 4:
        o = torch.einsum("bhqs,bshd->bhqd", w.to(dtype), v).float()
        return flash_combine(m, l, o, group).to(dtype).transpose(1, 2)
    o = torch.einsum("bkgqs,bskh->bkgqh", w.to(dtype), v).float()
    out = flash_combine(m, l, o, group).to(dtype)
    return out.permute(0, 3, 1, 2, 4).reshape(shape)


def flash_partials(scores):
    """A slice's part of the softmax over the last dimension of the
    float32 ``scores``: its max ``m``, its sum of exps ``l`` (both with
    that dimension kept, of size 1) and the weights ``exp(scores - m)``.
    A masked score (-inf, or the finite ``NEG_INF``) weighs 0 beside any
    unmasked one.  A wholly masked slice's weights never reach the result
    (:func:`flash_combine` scales them by 0), and where its max is -inf
    they are taken against 0, so that -inf gives no NaN."""
    m = torch.amax(scores, dim=-1, keepdim=True)
    w = torch.exp(scores - torch.where(torch.isfinite(m), m, 0.0))
    return m, torch.sum(w, dim=-1, keepdim=True), w


def flash_combine(m, l, o, group):
    """The softmax-weighted sum over the slices of ``group``'s ranks from
    each rank's :func:`flash_partials` ``m`` and ``l`` and its weighted
    sum ``o`` of the values (all float32), by flash-decode's two-pass
    rule: the all-reduced max ``M``, then the all-reduced sums of
    ``exp(m - M) * l`` and ``exp(m - M) * o``, then their quotient.  A
    slice whose max is -inf scales by 0; where every score of a row is
    -inf the row is 0.  Three functional all-reduces (the collectives
    DTensor issues, which the dry-run's tracer counts), the same result
    on every rank."""
    top = _all_reduce(m, "max", group)
    scale = torch.exp(torch.where(torch.isfinite(m), m - top, -torch.inf))
    l = _all_reduce(l * scale, "sum", group)
    o = _all_reduce(o * scale, "sum", group)
    return o / torch.clamp(l, min=1e-30)


def _all_gather(t, dim: int, group):
    """``t`` gathered along ``dim`` over ``group`` by ``torch.distributed``'s
    functional collective (stacked on the first dimension, then put in
    place), waited on."""
    ops = torch.ops._c10d_functional
    n = group.size()
    out = ops.wait_tensor(ops.all_gather_into_tensor(t.contiguous(), n,
                                                     group.group_name))
    return torch.cat(torch.chunk(out, n, dim=0), dim=dim)


def _all_reduce(t, op: str, group):
    """``t`` all-reduced by ``op`` ("max" or "sum") over ``group``,
    through ``torch.distributed``'s functional collective, waited on."""
    from torch.distributed._functional_collectives import (
        AsyncCollectiveTensor, all_reduce)
    out = all_reduce(t, op, group)
    return out.wait() if isinstance(out, AsyncCollectiveTensor) else out


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
    accordingly).  Attention attends the rows the reference's validity mask
    keeps (linear-fill semantics: a ring that wrapped counts every slot as
    written), so the same code serves both layouts: over a DTensor cache
    as masked scores of the whole cache, elsewhere on the ``decode_attn``
    kernel, which reads only those rows.

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
    if not isinstance(k, DTensor):
        rows = torch.arange(b, device=x.device)
        k[rows, slot] = k_new[:, 0].to(k.dtype)
        v[rows, slot] = v_new[:, 0].to(v.dtype)
        out = kernel_ops.decode_attention(
            q, k, v, pos.to(torch.int32), window=window,
            softcap=cfg.logits_softcap)
        return _project_out(out, p, cfg), cache
    _write_shards(k, slot, k_new[:, 0])
    _write_shards(v, slot, v_new[:, 0])
    # validity: linear-fill semantics, as in the reference (a ring that
    # wrapped counts every slot as written)
    slots = torch.arange(length, device=x.device)[None, :]   # (1, L)
    written = slots <= pos[:, None]
    if window is not None:
        written &= slots > pos[:, None] - window
    mask = written[:, None, None, None, :]       # (B,1,1,1,L)
    # the cache keeps its sequence shard: each rank attends over its
    # slots and the slices' softmaxes are combined (no rank gathers the
    # cache or the scores)
    out = _sdpa(q, k, v, mask, cfg, kv_seq="cache_seq")
    y = constrain(_project_out(out, p, cfg), "batch", None, "embed")
    return y, cache
