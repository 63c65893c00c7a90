"""Explicit sequence-sharded flash-decode over a process group.

When the KV cache's sequence dim is sharded over the ``model`` mesh
dimension, each rank attends over its local cache slice and the partial
softmaxes are combined with the numerically-stable two-pass rule:

    m  = all-reduce max of local max
    l  = all-reduce sum of exp(local_max - m) · local_sum
    o  = all-reduce sum of exp(local_max - m) · local_weighted_V   / l

The JAX package pins this schedule with ``shard_map`` and three psums; here
the three collectives are ``torch.distributed``'s functional all-reduces
on the mesh dimension's process group, the combine the sharded model's
decode attention runs too, and the inputs and output are DTensors on the
mesh.  Works for any kv_heads (no head-divisibility constraint) — the
reason sequence sharding is the default decode layout.  Every collective
is an all-reduce, which gloo also carries for CUDA tensors, so ranks that
share one card run it over gloo.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.models import attention
from repro_torch.models.common import ModelConfig


def flash_decode_local(q, k_local, v_local, valid_local, group=None):
    """One-token attention over a sequence-sharded cache.

    q: (B, 1, H, hd), the same on every rank of ``group`` (the world when
    None); k_local/v_local: (B, L/n, KV, hd); valid_local: (B, L/n) bool.
    Returns (B, 1, H, hd), the same on every rank.  The combine is the
    sharded model's (:func:`repro_torch.models.attention.flash_combine`).
    """
    b, _, h, hd = q.shape
    kv = k_local.shape[2]
    g = h // kv
    qg = q.reshape(b, kv, g, hd) * (hd ** -0.5)
    s = torch.einsum("bkgh,bskh->bkgs", qg.float(), k_local.float())
    s = torch.where(valid_local[:, None, None, :], s, -torch.inf)
    m, l, w = attention.flash_partials(s)                   # (B,KV,G,·)
    o = torch.einsum("bkgs,bskh->bkgh", w.to(v_local.dtype), v_local).float()
    out = attention.flash_combine(
        m, l, o, dist.group.WORLD if group is None else group)
    return out.reshape(b, 1, h, hd).to(q.dtype)


def _placed(x, mesh, placements):
    """``x`` as a DTensor with ``placements``: a DTensor is redistributed,
    a plain tensor is taken as the full value, alike on every rank."""
    if isinstance(x, DTensor):
        return x.redistribute(mesh, placements)
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False).redistribute(mesh, placements)


def make_flash_decode(mesh, cfg: ModelConfig, axis_name: str = "model"):
    """Returns f(q, k, v, valid) with k/v sequence-sharded over axis_name.

    The inputs follow the reference's ``in_specs``: q replicated; k, v
    (B, L, KV, hd) and valid (B, L) ``Shard(1)`` on ``axis_name`` and
    replicated on the mesh's other dimensions.  DTensors are redistributed
    to that; a plain tensor is the full value.  Each rank computes on its
    own slice only (a DTensor built with ``DTensor.from_local`` from each
    rank's slice never exists whole).  The output is a replicated DTensor.
    """
    del cfg
    dim = list(mesh.mesh_dim_names).index(axis_name)
    group = mesh.get_group(axis_name)
    rep = [Replicate()] * mesh.ndim
    seq = list(rep)
    seq[dim] = Shard(1)

    def f(q, k, v, valid):
        n = mesh.shape[dim]
        if k.shape[1] % n:
            raise ValueError(f"flash_decode: cache length {k.shape[1]} is "
                             f"not a multiple of the {n} ranks of "
                             f"{axis_name!r}")
        out = flash_decode_local(
            _placed(q, mesh, rep).to_local(),
            _placed(k, mesh, seq).to_local(),
            _placed(v, mesh, seq).to_local(),
            _placed(valid, mesh, seq).to_local(), group)
        return DTensor.from_local(out, mesh, rep, run_check=False)

    return f
