"""Seeded weights, made on the device by the benchmark and handed to both
the program and the reference.

The tree has the port's parameter layout (``init_lm``'s keys), which is
the port's interface.  Each leaf is drawn from its own generator, seeded
from the run's seed and the leaf's index, so any one leaf can be drawn
again alone (the training check regenerates the starting weights leaf by
leaf instead of keeping a copy).  Matrices are fan-in scaled normals;
norm scales are small normals, so that the norms' ``1 + scale`` is
exercised.
"""
from __future__ import annotations

import torch

from gappbench.cell import Shape

_MIX = 0x9E3779B97F4A7C15


def leaf_seed(seed: int, index: int) -> int:
    return (seed * 1_000_003 + index * _MIX + 12_345) % (1 << 63)


def leaf_specs(s: Shape) -> list[tuple[tuple, tuple, float | None]]:
    """``(path, shape, scale)`` of every leaf in a fixed order; ``scale``
    None marks a norm scale (a vector)."""
    d, hd = s.d, s.head_dim
    out = [(("embed",), (s.vocab, d), d ** -0.5),
           (("final_norm",), (d,), None),
           (("lm_head",), (d, s.vocab), d ** -0.5)]
    if s.frontend_dim:
        out.append((("frontend",), (s.frontend_dim, d),
                    s.frontend_dim ** -0.5))
    for layer in range(s.layers):
        g = ("groups", layer, "b0")
        out += [(g + ("ln1",), (d,), None), (g + ("ln2",), (d,), None),
                (g + ("attn", "wq"), (d, s.heads * hd), d ** -0.5),
                (g + ("attn", "wk"), (d, s.kv_heads * hd), d ** -0.5),
                (g + ("attn", "wv"), (d, s.kv_heads * hd), d ** -0.5),
                (g + ("attn", "wo"), (s.heads * hd, d),
                 (s.heads * hd) ** -0.5),
                (g + ("ffn", "gate"), (d, s.d_ff), d ** -0.5),
                (g + ("ffn", "up"), (d, s.d_ff), d ** -0.5),
                (g + ("ffn", "down"), (s.d_ff, d), s.d_ff ** -0.5)]
    return out


def draw_leaf(seed: int, index: int, shape: tuple, scale: float | None,
              dtype, device) -> torch.Tensor:
    gen = torch.Generator(device).manual_seed(leaf_seed(seed, index))
    w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    w.mul_(0.1 if scale is None else scale)
    return w if scale is None else w.to(dtype)


def _put(tree: dict, path: tuple, leaf) -> None:
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(key, int):
            while len(node) <= key:
                node.append({})
            node = node[key]
        else:
            node = node.setdefault(key, [] if isinstance(nxt, int) else {})
    node[path[-1]] = leaf


def make_params(s: Shape, seed: int, dtype, device) -> dict:
    """The whole tree: matrices in ``dtype`` (bf16 for serving, float32
    masters for training), norm scales in float32."""
    tree: dict = {}
    for i, (path, shape, scale) in enumerate(leaf_specs(s)):
        _put(tree, path, draw_leaf(seed, i, shape, scale, dtype, device))
    return tree


def get(tree, path: tuple):
    for key in path:
        tree = tree[key]
    return tree


def make_bank(s: Shape, seed: int, rows: int, device) -> tuple:
    """The decode cells' prompt K/V: per layer ``rows`` bf16 rows of k and
    of v, (layers, rows, kv_heads, head_dim) each, standing for the
    prompts' cache rows that a prefill stage hands the decode engine."""
    gen = torch.Generator(device).manual_seed(leaf_seed(seed, 1 << 20))
    shape = (s.layers, rows, s.kv_heads, s.head_dim)
    k = torch.randn(shape, generator=gen, device=device, dtype=torch.bfloat16)
    v = torch.randn(shape, generator=gen, device=device, dtype=torch.bfloat16)
    return k, v
