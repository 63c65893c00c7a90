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

from gappbench import cell as cell_lib

_MIX = 0x9E3779B97F4A7C15


def leaf_seed(seed: int, index: int) -> int:
    return (seed * 1_000_003 + index * _MIX + 12_345) % (1 << 63)


def leaf_specs(s) -> list[tuple[tuple, tuple, float | None]]:
    """``(path, shape, scale)`` of every leaf in a fixed order, as the
    configuration's family lays them out; ``scale`` None marks a norm
    scale (a vector)."""
    return cell_lib.family_of(s).leaf_specs(s)


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


def make_params(s, seed: int, dtype, device) -> dict:
    """The whole tree: matrices in ``dtype`` (bf16 for serving, float32
    masters for training) but for the family's ``FLOAT32_LEAVES``, norm
    scales in float32."""
    fam = cell_lib.family_of(s)
    tree: dict = {}
    for i, (path, shape, scale) in enumerate(fam.leaf_specs(s)):
        dt = torch.float32 if path[-1] in fam.FLOAT32_LEAVES else dtype
        _put(tree, path, draw_leaf(seed, i, shape, scale, dt, device))
    return tree


def get(tree, path: tuple):
    for key in path:
        tree = tree[key]
    return tree


def make_bank(s, seed: int, rows: int, device) -> tuple:
    """The decode cells' prompt K/V, standing for the prompts' cache rows
    that a prefill stage hands the decode engine: ``(k, v)``, each one
    (rows, kv_heads, head_dim) bf16 tensor a cache layer of the family's
    ``cache_layers(s, rows)``, indexed by the layer (a stacked tensor
    where the family keeps one)."""
    return cell_lib.family_of(s).make_bank(s, seed, rows, device)


def bank_for(layers: list, kv_heads: int, head_dim: int, seed: int,
             device) -> tuple:
    """A bank of each cache layer's own rows (``cell.CacheLayer``): one
    generator from the seed, each layer's k then its v, in layer order."""
    gen = torch.Generator(device).manual_seed(leaf_seed(seed, 1 << 20))
    ks, vs = [], []
    for c in layers:
        shape = (c.rows, kv_heads, head_dim)
        ks.append(torch.randn(shape, generator=gen, device=device,
                              dtype=torch.bfloat16))
        vs.append(torch.randn(shape, generator=gen, device=device,
                              dtype=torch.bfloat16))
    return ks, vs
