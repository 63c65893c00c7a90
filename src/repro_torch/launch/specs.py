"""Input stand-ins + shardings for every (arch × shape).

  * train / prefill: {"tokens": (B,S) i32, "frontend": ... when stubbed}
  * decode: (tokens (B,), pos (B,), decode state tree, [memory])

The stand-ins are tensors on the ``meta`` device (shapes and dtypes, no
storage), where the reference has ``jax.ShapeDtypeStruct``s and
``jax.eval_shape``; the decode state is ``init_decode_state`` run on
``meta``.  A sharding is a :class:`~repro_torch.sharding.api.PartitionSpec`
filtered against the mesh, with its DTensor placements from
:func:`~repro_torch.sharding.api.to_placements`, where the reference has
a ``NamedSharding``.
"""
from __future__ import annotations

import torch

from repro_torch.configs import ShapeSpec
from repro_torch.models import init_decode_state
from repro_torch.models.common import ModelConfig
from repro_torch.sharding.api import (P, ShardingRules, filter_entry,
                                      filter_spec)

ENC_MEMORY_LEN = 1024   # stub encoder-memory length for enc-dec decode


def _sd(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def train_like_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    b, s = shape.global_batch, shape.seq_len
    specs = {}
    if cfg.enc_layers:
        # enc-dec: half the length budget to frames, half to text tokens
        specs["frontend"] = _sd((b, s // 2, cfg.frontend_dim), torch.float32)
        specs["tokens"] = _sd((b, s // 2), torch.int32)
    elif cfg.frontend_dim:
        specs["frontend"] = _sd((b, cfg.num_prefix, cfg.frontend_dim),
                                torch.float32)
        specs["tokens"] = _sd((b, s - cfg.num_prefix), torch.int32)
    else:
        specs["tokens"] = _sd((b, s), torch.int32)
    return specs


def train_like_shardings(cfg: ModelConfig, specs: dict, mesh,
                         rules: ShardingRules) -> dict:
    """Each input's :class:`PartitionSpec`: the batch dimension over the
    axes ``batch`` binds to, where they divide it."""
    out = {}
    for k, v in specs.items():
        axes = ("batch",) + (None,) * (len(v.shape) - 1)
        out[k] = filter_spec(tuple(v.shape), rules.spec(*axes), mesh)
    return out


def decode_state_specs(cfg: ModelConfig, shape: ShapeSpec):
    b = shape.global_batch
    cache_len = shape.seq_len
    state = init_decode_state(cfg, b, cache_len, device="meta")
    tokens = _sd((b,), torch.int32)
    pos = _sd((b,), torch.int32)
    memory = None
    if cfg.enc_layers:
        memory = (_sd((b, ENC_MEMORY_LEN, cfg.d_model), cfg.compute_dtype),
                  _sd((b, ENC_MEMORY_LEN), torch.int32))
    return tokens, pos, state, memory


def _state_logical_axes(path) -> tuple:
    names = [str(k) for k in path]
    leaf = names[-1]
    if leaf in ("k", "v"):
        return ("batch", "cache_seq", "kv_heads", "head_dim")
    if leaf == "s":                       # rwkv state (B,NH,hd,hd)
        return ("batch", "rwkv_heads", None, None)
    if leaf == "h":                       # rglru state (B,R)
        return ("batch", "lru")
    if leaf == "conv":                    # (B,W-1,R)
        return ("batch", None, "lru")
    if leaf in ("prev", "cmix_prev"):     # (B,1,D)
        return ("batch", None, "embed")
    return ("batch",)


def _map_with_path(fn, tree, path: tuple = ()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def decode_shardings(cfg: ModelConfig, shape: ShapeSpec, mesh,
                     rules: ShardingRules):
    """The :class:`PartitionSpec`s of :func:`decode_state_specs`' tokens,
    positions, state tree and encoder memory."""
    tokens, pos, state, memory = decode_state_specs(cfg, shape)

    def bind(path, leaf):
        axes = _state_logical_axes(path)
        axes = tuple(axes) + (None,) * (len(leaf.shape) - len(axes))
        return _filtered(leaf, axes[: len(leaf.shape)], mesh, rules)

    state_sh = _map_with_path(bind, state)
    tok_sh = filter_spec(tuple(tokens.shape), rules.spec("batch"), mesh)
    mem_sh = None
    if memory is not None:
        mem_sh = (filter_spec(tuple(memory[0].shape),
                              rules.spec("batch", None, "embed"), mesh),
                  filter_spec(tuple(memory[1].shape),
                              rules.spec("batch", None), mesh))
    return tok_sh, tok_sh, state_sh, mem_sh


def _filtered(leaf, axes, mesh, rules: ShardingRules) -> P:
    spec = []
    used: set = set()
    for dim, name in zip(leaf.shape, axes):
        phys = rules.table.get(name) if name else None
        spec.append(filter_entry(dim, phys, mesh, used))
    return P(*spec)
