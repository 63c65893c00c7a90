"""Parameter partition rules: param-tree paths -> logical axes -> mesh.

Rules are matched on (parent-key, leaf-key) pairs, first match wins.  Axes
whose physical size doesn't divide the dimension are dropped (e.g. grok's
8-expert axis on a 16-way model axis falls back to replication, with the
launcher instead binding ``expert_mlp`` for tensor-parallel experts).

The trees are the port's parameter trees: dicts, with lists for
``groups`` and ``encoder``.  A leaf is anything with a ``shape`` (a tensor,
a fake or ``meta`` one, a DTensor).  :func:`param_shardings` gives each
leaf's DTensor placements, for ``distribute_tensor``.
"""
from __future__ import annotations

import re

from torch.distributed.tensor import distribute_tensor

from repro_torch.sharding.api import (P, ShardingRules, filter_entry,
                                      to_placements)

# ((parent regex, leaf regex), logical axes per dim)
_RULES: list[tuple[tuple[str, str], tuple]] = [
    ((r".*", r"embed"), ("vocab", "embed")),
    ((r".*", r"lm_head"), ("embed", "vocab")),
    ((r".*", r"(enc_)?frontend"), (None, "embed")),
    # attention (parent attn/xattn)
    ((r"attn|xattn", r"wq"), ("embed", "heads_flat")),
    ((r"attn|xattn", r"w[kv]"), ("embed", "kv_flat")),
    ((r"attn|xattn", r"bq"), ("heads_flat",)),
    ((r"attn|xattn", r"b[kv]"), ("kv_flat",)),
    ((r"attn|xattn", r"wo"), ("heads_flat", "embed")),
    ((r"attn|xattn", r"[qk]_norm"), (None,)),
    # MoE (parent ffn)
    ((r"ffn", r"router"), ("embed", "experts")),
    ((r"ffn", r"we_(gate|up)"), ("experts", "expert_in", "expert_mlp")),
    ((r"ffn", r"we_down"), ("experts", "expert_mlp", "expert_in")),
    ((r"ffn", r"dense_(gate|up)"), ("embed", "mlp")),
    ((r"ffn", r"dense_down"), ("mlp", "embed")),
    # dense MLP (parent ffn)
    ((r"ffn", r"(gate|up)"), ("embed", "mlp")),
    ((r"ffn", r"down"), ("mlp", "embed")),
    # RG-LRU (parent mix)
    ((r"mix", r"w[xy]"), ("embed", "lru")),
    ((r"mix", r"conv_w"), (None, "lru")),
    ((r"mix", r"(conv_b|gate_.*|log_lambda)"), ("lru",)),
    # RWKV time mix (parent mix)
    ((r"mix", r"w[rkvg]"), ("embed", "heads_flat")),
    ((r"mix", r"decay_w1"), ("embed", None)),
    ((r"mix", r"decay_w2"), (None, "heads_flat")),
    ((r"mix", r"bonus_u"), ("rwkv_heads", None)),
    ((r"mix", r"(mix_.*|decay_base|ln_x)"), (None,)),
    ((r"mix", r"wo"), ("heads_flat", "embed")),
    # RWKV channel mix (parent ffn)
    ((r"ffn", r"w[k]"), ("embed", "mlp")),
    ((r"ffn", r"wv"), ("mlp", "embed")),
    ((r"ffn", r"wr"), ("embed", None)),
    ((r"ffn", r"mix_.*"), (None,)),
]

PARAM_LOGICAL_EXTRA = {
    "heads_flat": "model",
    "kv_flat": "model",
}


def _path_names(path) -> list[str]:
    """The keys of a tree path as strings (list indices as digits)."""
    return [str(k) for k in path]


def _match(path_names: list[str]) -> tuple | None:
    leaf = path_names[-1]
    parents = path_names[:-1]
    for (pp, lp), axes in _RULES:
        if not re.fullmatch(lp, leaf):
            continue
        if pp == r".*" or any(re.fullmatch(pp, p) for p in parents):
            return axes
    return None


def _map_with_path(fn, tree, path: tuple = ()):
    """``fn(path, leaf)`` over ``tree``, keeping its structure."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _logical(path, leaf) -> tuple:
    axes = _match(_path_names(path))
    if axes is None:
        return (None,) * len(leaf.shape)
    axes = tuple(axes) + (None,) * (len(leaf.shape) - len(axes))
    return axes[: len(leaf.shape)]


def logical_param_specs(shapes, cfg=None):
    """Tree of logical-axis tuples matching a params(-shape) tree."""
    del cfg
    return _map_with_path(_logical, shapes)


def _table(rules: ShardingRules) -> dict:
    table = dict(rules.table)
    table.update({k: v for k, v in PARAM_LOGICAL_EXTRA.items()
                  if k not in table})
    return table


def _physical(path, leaf, table: dict, mesh) -> P:
    spec = []
    used: set = set()
    for dim, name in zip(leaf.shape, _logical(path, leaf)):
        phys = table.get(name) if name else None
        spec.append(filter_entry(dim, phys, mesh, used))
    return P(*spec)


def physical_specs(shapes, mesh, rules: ShardingRules):
    """Tree of :class:`PartitionSpec` with divisibility filtering; ``mesh``
    a :class:`DeviceMesh` or a name-to-size mapping."""
    table = _table(rules)
    return _map_with_path(
        lambda path, leaf: _physical(path, leaf, table, mesh), shapes)


def param_shardings(shapes, mesh, rules: ShardingRules):
    """Tree of each leaf's DTensor placements on ``mesh``, for
    ``distribute_tensor(leaf, mesh, placements)``."""
    table = _table(rules)
    return _map_with_path(lambda path, leaf: to_placements(
        _physical(path, leaf, table, mesh), mesh), shapes)


def distribute_params(params, mesh, rules: ShardingRules):
    """``params`` as DTensors on ``mesh``, each leaf placed by
    :func:`param_shardings` (every rank passes the same full values)."""
    table = _table(rules)
    return _map_with_path(lambda path, leaf: distribute_tensor(
        leaf, mesh, to_placements(_physical(path, leaf, table, mesh), mesh)),
        params)
