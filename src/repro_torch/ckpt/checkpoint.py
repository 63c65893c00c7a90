"""Sharded checkpointing with atomic manifests.

Layout (the JAX package's, file for file)::

    <dir>/step_000100/
        manifest.json        # leaf keys, shapes, dtypes, step
        shard_h000.npz       # this host's param/opt leaves
        .complete            # atomic commit marker (written last)

Leaf keys are the ``/``-joined paths of the JAX package's flatten order
(sorted dict keys, list indices), so the two packages write the same
``manifest.json`` for the same tree and restore each other's checkpoints.
Every host writes the leaves it is primary for (here: single-host writes
all).  The tensors are copied to the host *synchronously* (the next step
overwrites them in place); only the file I/O runs on the writer thread,
which is a registered GAPP worker — a slow blocking save shows up as a
serialization bottleneck in the profile (the paper's Bodytrack OutputBMP
case, verbatim, at fleet scale).  Restoring onto another mesh
(``shardings``) needs the port's mesh, which it does not have yet.
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.models.common import tree_from_items, tree_items


def _flatten(tree) -> dict:
    """``{key: leaf}`` in the reference's order and with its keys."""
    return {"/".join(str(k) for k in path): leaf
            for path, leaf in tree_items(tree)}


def _to_host(leaf) -> np.ndarray:
    """A host copy of ``leaf`` (a copy for a CPU tensor too, whose
    ``numpy()`` would share the memory the next step writes)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


def save(directory: str, step: int, tree, blocking: bool = True,
         gapp=None, wid=None) -> threading.Thread | None:
    """Write a checkpoint; returns the writer thread when non-blocking.

    Device tensors are copied to host *synchronously* (the next step
    writes the same tensors in place) — only the file I/O runs on the
    writer thread."""
    arrays = {k: _to_host(v) for k, v in _flatten(tree).items()}

    def _write():
        if gapp is not None:
            gapp.begin(wid, "ckpt/save")
        d = os.path.join(directory, f"step_{step:06d}")
        tmp = d + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "shard_h000.npz"), **arrays)
        manifest = {
            "step": step,
            "leaves": {k: {"shape": list(a.shape), "dtype": str(a.dtype)}
                       for k, a in arrays.items()},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        with open(os.path.join(tmp, ".complete"), "w") as f:
            f.write("ok")
        if os.path.isdir(d):
            shutil.rmtree(d)
        os.rename(tmp, d)
        if gapp is not None:
            gapp.end(wid)

    if blocking:
        _write()
        return None
    t = threading.Thread(target=_write, daemon=True, name="ckpt-writer")
    t.start()
    return t


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp") \
                and os.path.exists(os.path.join(directory, name, ".complete")):
            steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def restore(directory: str, step: int, like_tree, shardings=None, *,
            device=None):
    """Rebuild ``like_tree``-structured tensors: each leaf in the dtype of
    ``like_tree``'s leaf, on ``device`` (the port's default device when
    None)."""
    if shardings is not None:
        raise NotImplementedError(
            "restore(shardings=...) needs the port's mesh, which it does "
            "not have yet")
    dev = device_lib.resolve(device)
    d = os.path.join(directory, f"step_{step:06d}")
    if not os.path.exists(os.path.join(d, ".complete")):
        raise FileNotFoundError(f"incomplete checkpoint: {d}")
    flat_like = _flatten(like_tree)
    with np.load(os.path.join(d, "shard_h000.npz")) as data:
        missing = [k for k in flat_like if k not in data]
        if missing:
            raise KeyError(f"checkpoint missing leaves: {missing[:5]}...")
        leaves = [torch.from_numpy(data[k]).to(device=dev, dtype=like.dtype)
                  for k, like in flat_like.items()]
    return tree_from_items(like_tree, leaves)


def prune(directory: str, keep: int = 3) -> None:
    if not os.path.isdir(directory):
        return
    all_steps = sorted(int(n.split("_")[1]) for n in os.listdir(directory)
                       if n.startswith("step_") and not n.endswith(".tmp"))
    for s in all_steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:06d}"),
                      ignore_errors=True)
