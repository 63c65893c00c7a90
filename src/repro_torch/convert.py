"""Carry a capture, a fold state and model trees across from numpy.

The profiler's state is the capture (event columns, the tag and stack
registries, the sample buffer) and the chunked fold's carry; the model
workloads' state is a tree: parameters, an optimizer state (``mu``,
``nu``, ``step``) or a checkpoint tree holding both.  These functions
rebuild the port's objects from plain fields (numpy arrays, lists and
numbers), so a capture or a tree made anywhere (by the JAX package, a
file, another process) runs through the port unchanged, and
:func:`params_to_numpy` carries a tree back.  Arrays are copied; the
port's objects share no memory with the fields given.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as device_lib

from repro_torch.core.cmetric import FoldCarry
from repro_torch.core.events import EventLog
from repro_torch.core.sampler import SampleBuffer
from repro_torch.core.tracer import StackRegistry, TagRegistry
from repro_torch.models.common import tree_map

_LOG_DTYPES = {"times": np.int64, "workers": np.int32, "deltas": np.int8,
               "tags": np.int32, "stacks": np.int32}


def capture_from_numpy(log_fields: dict, tag_names, tag_locations,
                       stack_paths, sample_fields: dict | None = None):
    """Rebuild ``(EventLog, TagRegistry, StackRegistry, SampleBuffer |
    None)`` from plain fields.

    ``log_fields`` holds the :class:`EventLog` columns (``times``,
    ``workers``, ``deltas``, ``tags``, ``stacks``) and ``num_workers``;
    ``tag_names``/``tag_locations`` and ``stack_paths`` list the registries
    in id order; ``sample_fields`` holds the sample columns (``times``,
    ``workers``, ``tags``) and optionally ``dropped``.  The stack
    registry keeps the default top 8 frames, or the longest path given.
    """
    log = EventLog(**{k: np.array(log_fields[k], dtype=dt)
                      for k, dt in _LOG_DTYPES.items()},
                   num_workers=int(log_fields["num_workers"]))
    tags = TagRegistry()
    for name, loc in zip(tag_names, tag_locations, strict=True):
        tags.intern(str(name), str(loc))
    if len(tags) != len(tag_names):
        raise ValueError("tag_names must be distinct")
    stacks = StackRegistry(top_m=max([8, *(len(p) for p in stack_paths)]))
    for path in stack_paths:
        stacks.intern(tuple(int(t) for t in path))
    if len(stacks) != len(stack_paths):
        raise ValueError("stack_paths must be distinct")
    samples = None
    if sample_fields is not None:
        t = np.asarray(sample_fields["times"], np.int64)
        samples = SampleBuffer(max(int(t.shape[0]), 1))
        samples.times[:t.shape[0]] = t
        samples.workers[:t.shape[0]] = np.asarray(sample_fields["workers"],
                                                  np.int32)
        samples.tags[:t.shape[0]] = np.asarray(sample_fields["tags"],
                                               np.int32)
        samples.head = int(t.shape[0])
        samples.dropped = int(sample_fields.get("dropped", 0))
    return log, tags, stacks, samples


def carry_from_numpy(fields: dict) -> FoldCarry:
    """Rebuild a :class:`FoldCarry` from its fields (the dataclass's field
    names, per-worker maps as arrays)."""
    out = dict(fields)
    for k in ("local_cm", "slice_start", "cm_hash"):
        out[k] = np.array(fields[k], np.float64)
    out["open"] = np.array(fields["open"], bool)
    return FoldCarry(**out)


def params_from_numpy(tree, device=None):
    """A tree of the port from one of numpy arrays.

    ``tree`` is nested dicts and lists of arrays, as
    ``jax.tree.map(np.asarray, ...)`` gives for the JAX package's
    ``init_lm`` parameters, its ``adamw.init`` state (the 0-d int32
    ``step`` included) or a ``{"params": ..., "opt": ...}`` checkpoint
    tree; the structure and keys are kept.  Each array is copied to
    ``device`` (the port's default device when None) in its own dtype; a
    bfloat16 array (``ml_dtypes``) goes through float32, which holds every
    bfloat16 value exactly."""
    dev = device_lib.resolve(device)

    def leaf(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(
                device=dev, dtype=torch.bfloat16)
        return torch.from_numpy(np.array(a)).to(dev)
    return tree_map(leaf, tree)


def params_to_numpy(tree):
    """A tree of numpy arrays from one of the port's tensors, with every
    dict's keys in the JAX package's flatten order (sorted), as
    ``jax.tree.map(np.asarray, ...)`` gives the reference's trees.  A
    bfloat16 tensor comes back as float32, which holds it exactly."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: params_to_numpy(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_to_numpy(v) for v in tree)
    t = tree.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()
