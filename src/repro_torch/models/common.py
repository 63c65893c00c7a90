"""Shared model-substrate pieces: config, init helpers, norms, RoPE."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One config covers all ten assigned families; unused fields are inert.

    ``block_pattern`` is the repeating block-type cycle; layers run in
    groups of ``len(block_pattern)`` (e.g. gemma3 = 5×"local"+1×"dense",
    recurrentgemma = 2×"rglru"+1×"local", rwkv6 = 1×"rwkv").
    """

    name: str = "model"
    family: str = "dense"            # dense | moe | hybrid | ssm | encdec | vlm
    num_layers: int = 4
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int | None = None      # default d_model // num_heads
    d_ff: int = 1024
    vocab_size: int = 1024
    block_pattern: tuple[str, ...] = ("dense",)
    window: int = 1024               # local-attention window
    qk_norm: bool = False            # qwen3
    qkv_bias: bool = False           # qwen1.5
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    # MoE
    num_experts: int = 0
    top_k: int = 2
    dense_residual: bool = False     # arctic: dense MLP in parallel with MoE
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # recurrent families
    lru_width: int | None = None     # rg-lru width (default d_model)
    conv_width: int = 4              # rg-lru temporal conv
    rwkv_head_dim: int = 64
    chunk_size: int = 128            # chunked linear-recurrence block length
    # encoder-decoder / multimodal frontends (stubbed per assignment)
    enc_layers: int = 0              # >0 => encoder-decoder
    frontend_dim: int = 0            # precomputed frame/patch embedding width
    num_prefix: int = 0              # vlm: patch-token prefix length
    # numerics / execution
    compute_dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    remat: bool = True               # recompute each layer group in the
                                     # backward pass (torch.utils.checkpoint)
    logits_softcap: float = 0.0      # grok uses 30.0
    # beyond-paper perf levers (0 = paper-faithful baseline)
    opt_level: int = 0               # >=1: repeated-KV attention layout
    attn_qchunk: int = 0             # >0: blockwise causal attention with
                                     # this q-chunk (bounds the S² score set)

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else (
            self.d_model // self.num_heads)

    @property
    def group_size(self) -> int:
        return len(self.block_pattern)

    @property
    def num_groups(self) -> int:
        return self.num_layers // self.group_size

    @property
    def tail_pattern(self) -> tuple[str, ...]:
        """Leftover layers when the pattern doesn't divide num_layers
        (gemma3: 26 = 4×(5L+1G) + 2L; recurrentgemma: 26 = 8×(R,R,A)+R,R)."""
        return self.block_pattern[: self.num_layers % self.group_size]

    @property
    def lru(self) -> int:
        return self.lru_width or self.d_model

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND model-FLOP estimates)."""
        d, f, hd = self.d_model, self.d_ff, self.hd
        per_block = {}
        attn = d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd \
            + self.num_heads * hd * d
        mlp = 3 * d * f
        per_block["dense"] = attn + mlp + 2 * d
        per_block["local"] = per_block["dense"]
        per_block["moe"] = attn + d * self.num_experts \
            + self.num_experts * 3 * d * f + 2 * d \
            + (mlp if self.dense_residual else 0)
        r = self.lru
        per_block["rglru"] = (2 * d * r + self.conv_width * r + 3 * r
                              + r * d) + mlp + 2 * d
        nh = d // self.rwkv_head_dim
        per_block["rwkv"] = (5 * d * d + 2 * d * nh + d) \
            + (2 * d * (f // 1) + d * d) + 2 * d
        per_block["cross"] = 2 * attn + mlp + 3 * d
        n = 0
        for b in (self.block_pattern * self.num_groups + self.tail_pattern):
            n += per_block[b]
        n += self.vocab_size * d  # embedding
        if not self.tie_embeddings:
            n += self.vocab_size * d
        if self.enc_layers:
            n += self.enc_layers * per_block["dense"]
            n += self.frontend_dim * d
        if self.frontend_dim and not self.enc_layers:
            n += self.frontend_dim * d
        return n


def dense_init(gen: torch.Generator, shape, in_axis: int = 0,
               dtype=torch.float32, *, device=None) -> torch.Tensor:
    """Fan-in scaled normal init, drawn from ``gen`` on ``device`` (the
    generator's own device when None)."""
    fan_in = shape[in_axis] if isinstance(in_axis, int) else int(
        np.prod([shape[a] for a in in_axis]))
    scale = 1.0 / np.sqrt(max(fan_in, 1))
    dev = gen.device if device is None else device
    w = torch.randn(tuple(shape), generator=gen, device=dev,
                    dtype=torch.float32)
    return w.mul_(float(scale)).to(dtype)


def rms_norm(x, scale, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(dt)


def rope(x, positions, theta: float):
    """Rotary embedding.  x: (..., S, H, hd), positions: (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    angles = positions[..., None].float() * freq      # (..., S, half)
    angles = angles[..., None, :]                     # (..., S, 1, half)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([
        x1 * cos - x2 * sin,
        x2 * cos + x1 * sin,
    ], dim=-1)
    return out.to(x.dtype)


def softcap(x, cap: float):
    return torch.tanh(x / cap) * cap if cap > 0 else x


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts, lists and tuples (the
    parameter and state trees), with matching trees ``rest`` zipped in."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in :func:`tree_map` order."""
    out: list = []
    tree_map(out.append, tree)
    return out


def tree_items(tree, path: tuple = ()) -> list[tuple[tuple, Any]]:
    """``(path, leaf)`` pairs of ``tree`` in the JAX package's flatten order
    (``jax.tree_util.tree_flatten_with_path``): dict keys sorted, lists and
    tuples by index, ``None`` an empty subtree.  A path holds the dict keys
    and list indices from the root down.  :func:`tree_map` keeps insertion
    order instead, so anything written or summed in the reference's order
    (a checkpoint's leaves, the global gradient norm) goes through here."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in tree_items(tree[k],
                                                              path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in tree_items(v, path + (i,))]
    return [(path, tree)]


def tree_from_items(tree, leaves):
    """``tree`` with its leaves replaced by ``leaves``, given in
    :func:`tree_items` order; the structure and its insertion order are
    kept."""
    by_path = dict(zip((path for path, _ in tree_items(tree)), leaves,
                       strict=True))

    def walk(t, path):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: walk(v, path + (k,)) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v, path + (i,)) for i, v in enumerate(t))
        return by_path[path]
    return walk(tree, ())
