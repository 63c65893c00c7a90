"""CUDA kernel: decode attention over a KV cache, split over the cache's rows.

Replaces no TPU kernel: the JAX package leaves decode attention to XLA, and
the port's plain form (``models/attention.py::_sdpa_math`` over a validity
mask of the whole cache) cast the whole cache to float32 and made permuted
copies of k and v for the score products.  This is the single-card decode
step's attention (``models/attention.py::decode_attention`` on a cache
that is not a DTensor).

For each slot ``b`` and query head ``h`` it computes the softmax of
``softcap(q_h . k_r)`` over the slot's written interval of cache rows,
``[max(0, pos - window + 1), min(L - 1, pos)]``, weighted over ``v_r``.
Every other row's score is the mask's ``NEG_INF`` in the plain form, whose
weight is exactly 0 in float32, so it is not read.  An empty interval (pos
a window past the end of a ring, or negative) masks every row, which the
plain softmax weighs uniformly: the mean of v over all L rows.

Arithmetic: q scaled by ``hd ** -0.5`` in its own dtype; q . k as float32
products of the stored values, summed in float32; softcap and softmax in
float32.  The kernel keeps the weights in float32 against v and rounds the
weighted sum to the cache's dtype once; the plain version rounds the
normalised weights to the dtype before the product with v, as
``_sdpa_math`` and the JAX package do, so the CPU path keeps their
numbers.  The two differ by that rounding of the weights alone.

Design (``csrc/decode_attn.cu``): two launches.  Phase 1 runs a block per
(kv head and chunk of its query heads, split of the cache rows, slot); a
block whose split misses the slot's interval exits at once (pos is read on
the device: no host sync).  Lanes share a row through 16-byte loads and
keep a running max, sum and weighted V sum per query head; each block
writes one float32 partial (m, l, o[hd]) per query head.  Phase 2 combines
the splits by flash-decode's two-pass rule (:func:`flash_combine`'s
arithmetic, without the collectives).  :func:`plan` picks the split length
and head chunk from the shapes.

Bound: memory, each slot's written K and V rows once (2 x rows x KV x hd x
itemsize bytes), beside which q, the partials and the output are small.

The wrapper checks device, dtype, shape and contiguity and counts its
kernel launches (two a call) in :data:`LAUNCHES`.  On a CPU tensor it runs
the plain version :func:`decode_attn_ref`; on a CUDA tensor it launches the
kernel or raises.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.cmetric_fold import (check_device, raise_on_error,
                                              vec_ok)

#: Kernel launches since the last reset (CPU calls don't count).
LAUNCHES = {"decode_attn": 0}

HEAD_DIMS = (16, 64, 128, 256)
DTYPES = (torch.bfloat16, torch.float32)

#: Query heads one block takes at most (a longer group is cut in chunks,
#: each reading its kv head's rows again).
MAX_CHUNK = 8
#: K and V bytes one block reads at most, and the fewest rows a split
#: holds.
BLOCK_BYTES = 128 * 1024
MIN_SPLIT = 64
#: Blocks a launch should hold at least, per SM, where the cache is whole.
BLOCKS_PER_SM = 4


@dataclasses.dataclass(frozen=True)
class Plan:
    """How :func:`decode_attn` cuts the work: ``chunk`` query heads a block
    (a power of two), ``nchunk`` chunks a kv head, ``split`` cache rows a
    block, ``nsplit`` splits of the cache."""

    chunk: int
    nchunk: int
    split: int
    nsplit: int


@functools.lru_cache(maxsize=256)
def plan(batch: int, length: int, kv_heads: int, heads: int, head_dim: int,
         itemsize: int, sms: int) -> Plan:
    """The launch's shape from the input's: splits of at most
    :data:`BLOCK_BYTES` of K and V, halved (down to :data:`MIN_SPLIT` rows)
    until a whole cache would give :data:`BLOCKS_PER_SM` blocks an SM.
    Cached: a decode loop asks for the same shapes every step."""
    group = heads // kv_heads
    nchunk = -(-group // MAX_CHUNK)
    chunk = 1 << (-(-group // nchunk) - 1).bit_length()
    split = max(MIN_SPLIT, BLOCK_BYTES // (2 * head_dim * itemsize))
    while split > MIN_SPLIT and \
            batch * kv_heads * nchunk * -(-length // split) < \
            BLOCKS_PER_SM * sms:
        split //= 2
    split = min(split, length)
    return Plan(chunk, nchunk, split, -(-length // split))


def written_interval(pos, length: int, window: int | None):
    """Each slot's written rows ``[lo, hi]`` and whether the interval is
    empty (``flat``: then every row, weighed alike)."""
    pos = pos.long()
    lo = torch.clamp(pos - window + 1, min=0) if window is not None \
        else torch.zeros_like(pos)
    hi = torch.clamp(pos, max=length - 1)
    flat = lo > hi
    return (torch.where(flat, 0, lo), torch.where(flat, length - 1, hi),
            flat)


def decode_attn_ref(q, k, v, pos, window: int | None = None,
                    softcap: float = 0.0):
    """The kernel's plain version (see the module docstring): the scores of
    the whole cache, rows outside each slot's interval weighing 0, the
    normalised weights in q's dtype against v."""
    b, _, h, hd = q.shape
    length, kv = k.shape[1], k.shape[2]
    lo, hi, flat = written_interval(pos, length, window)
    qs = (q * (hd ** -0.5)).float().reshape(b, kv, h // kv, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qs, k.float())
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    s = torch.where(flat[:, None, None, None], 0.0, s)
    rows = torch.arange(length, device=q.device)
    keep = (rows >= lo[:, None]) & (rows <= hi[:, None])
    s = s.masked_fill(~keep[:, None, None, :], -math.inf)
    w = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bkgs,bskd->bkgd", w, v).reshape(b, 1, h, hd)


def _check(q, k, v, pos, window) -> None:
    for t, name in ((q, "q"), (k, "k"), (v, "v"), (pos, "pos")):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share one dtype of {DTYPES}, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if pos.dtype != torch.int32:
        raise TypeError(f"pos must be torch.int32, got {pos.dtype}")
    if q.dim() != 4 or q.shape[1] != 1 or k.dim() != 4:
        raise ValueError(f"q must be (B, 1, H, hd) and k (B, L, KV, hd), got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    b, _, h, hd = q.shape
    if v.shape != k.shape or k.shape[0] != b or k.shape[3] != hd \
            or pos.shape != (b,):
        raise ValueError(f"shapes do not match: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, pos "
                         f"{tuple(pos.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} is not one of {HEAD_DIMS}")
    if b < 1 or k.shape[1] < 1 or h % k.shape[2]:
        raise ValueError(f"need B >= 1, L >= 1 and KV dividing H, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    if window is not None and int(window) < 1:
        raise ValueError(f"window must be None or positive, got {window}")


@functools.lru_cache(maxsize=16)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def decode_attn(q, k, v, pos, *, window: int | None = None,
                softcap: float = 0.0):
    """One decode step's attention: q (B, 1, H, hd) against the cache k, v
    (B, L, KV, hd) after this step's row is written, over each slot's
    written rows (``pos``: int32[B]); ``window`` None for a full cache;
    ``softcap`` 0 for none.  Returns (B, 1, H, hd) in q's dtype."""
    _check(q, k, v, pos, window)
    dev = check_device([q, k, v, pos], ["q", "k", "v", "pos"])
    if dev.type == "cpu":
        return decode_attn_ref(q, k, v, pos, window, softcap)
    b, _, h, hd = q.shape
    length, kv = k.shape[1], k.shape[2]
    p = plan(b, length, kv, h, hd, k.element_size(), _sms(
        dev.index if dev.index is not None else torch.cuda.current_device()))
    lib = build.load("decode_attn")
    ml = torch.empty((b, h, p.nsplit, 2), dtype=torch.float32, device=dev)
    po = torch.empty((b, h, p.nsplit, hd), dtype=torch.float32, device=dev)
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.gapp_decode_attn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
            ml.data_ptr(), po.data_ptr(), out.data_ptr(), b, length, kv, h,
            hd, int(q.dtype == torch.float32),
            0 if window is None else int(window), float(softcap),
            hd ** -0.5, p.split, p.nsplit, p.chunk, vec_ok(q, k, v), stream)
    raise_on_error(rc, "gapp_decode_attn")
    LAUNCHES["decode_attn"] += 2
    return out
