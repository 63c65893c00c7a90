"""The port's checkpoints against the JAX package's, on the CPU.

Both packages write ``step_%06d/{shard_h000.npz, manifest.json,
.complete}`` with the leaves keyed by the reference's flatten order, so a
checkpoint of either restores through the other bit for bit and the
manifests are the same bytes.  Also the reference's own checkpoint cases
(tests/test_distribution.py), without elastic resharding, which needs the
port's mesh.
"""
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.ckpt import checkpoint as jckpt
from repro.models import init_lm as jinit_lm
from repro.optim import adamw as jadamw
from repro_torch import configs as tconfigs
from repro_torch.ckpt import checkpoint
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import init_lm
from repro_torch.models.common import tree_items
from repro_torch.optim import adamw


def _np_state(arch: str):
    """The reference's tiny params and a stepped AdamW state, as numpy
    (moments not zero, so a mix-up of leaves would show)."""
    p = jinit_lm(jax.random.PRNGKey(0), jconfigs.get_tiny(arch))
    g = jax.tree.map(lambda x: jnp.full_like(x, 0.5), p)
    p, s, _ = jadamw.update(jadamw.AdamWConfig(), g, jadamw.init(p), p)
    return jax.tree.map(np.asarray, {"params": p, "opt": s})


def _assert_equal_trees(t_tree, np_tree):
    tt, nt = tree_items(t_tree), tree_items(np_tree)
    assert [p for p, _ in tt] == [p for p, _ in nt]
    for (path, t), (_, n) in zip(tt, nt):
        a = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
        assert a.dtype == n.dtype and a.shape == n.shape, path
        np.testing.assert_array_equal(a, n, err_msg=str(path))


@pytest.mark.parametrize("arch", ["deepseek-7b", "gemma3-1b", "grok-1-314b"])
def test_reference_checkpoint_restores_through_the_port(tmp_path, arch):
    state = _np_state(arch)
    jckpt.save(str(tmp_path), 3, jax.tree.map(jnp.asarray, state))
    like = params_from_numpy(jax.tree.map(np.zeros_like, state),
                             device="cpu")
    assert checkpoint.latest_step(str(tmp_path)) == 3
    out = checkpoint.restore(str(tmp_path), 3, like, device="cpu")
    assert list(out) == list(like)
    _assert_equal_trees(out, state)


@pytest.mark.parametrize("arch", ["deepseek-7b", "gemma3-1b", "grok-1-314b"])
def test_port_checkpoint_restores_through_the_reference(tmp_path, arch):
    state = _np_state(arch)
    checkpoint.save(str(tmp_path), 5, params_from_numpy(state, device="cpu"))
    like = jax.tree.map(jnp.zeros_like, jax.tree.map(jnp.asarray, state))
    assert jckpt.latest_step(str(tmp_path)) == 5
    out = jckpt.restore(str(tmp_path), 5, like)
    _assert_equal_trees(jax.tree.map(np.asarray, out), state)


def test_manifests_are_the_same_bytes(tmp_path):
    """The port's tree keeps insertion order (``lm_head`` after
    ``final_norm``, ``groups`` before ``tail``); the manifest lists the
    leaves in the reference's sorted order all the same."""
    state = _np_state("gemma3-1b")
    jckpt.save(str(tmp_path / "j"), 1, jax.tree.map(jnp.asarray, state))
    tp = init_lm(torch.Generator().manual_seed(0),
                 tconfigs.get_tiny("gemma3-1b"), device="cpu")
    mine = {"params": tp, "opt": adamw.init(tp)}
    assert list(tp)[:2] == ["embed", "final_norm"]
    checkpoint.save(str(tmp_path / "t"), 1, mine)
    read = {w: (tmp_path / w / "step_000001" / "manifest.json").read_bytes()
            for w in ("j", "t")}
    assert read["t"] == read["j"]
    keys = list(json.loads(read["t"])["leaves"])
    assert keys == ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                             for k in path) for path, _ in
                    jax.tree_util.tree_flatten_with_path(state)[0]]
    with np.load(tmp_path / "t" / "step_000001" / "shard_h000.npz") as t, \
            np.load(tmp_path / "j" / "step_000001" / "shard_h000.npz") as j:
        assert list(t.keys()) == list(j.keys()) == keys


def test_checkpoint_roundtrip(tmp_path):
    cfg = tconfigs.get_tiny("deepseek-7b")
    params = init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    opt = adamw.init(params)
    tree = {"params": params, "opt": opt}
    checkpoint.save(str(tmp_path), 7, tree)
    assert checkpoint.latest_step(str(tmp_path)) == 7
    restored = checkpoint.restore(str(tmp_path), 7, tree, device="cpu")
    for (_, a), (_, b) in zip(tree_items(tree), tree_items(restored)):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_restore_takes_the_like_trees_dtypes():
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3) / 4,
            "n": torch.tensor(3, dtype=torch.int32)}
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save(d, 2, tree)
        like = {"w": torch.zeros(2, 3, dtype=torch.bfloat16),
                "n": torch.zeros((), dtype=torch.int64)}
        out = checkpoint.restore(d, 2, like, device="cpu")
    assert out["w"].dtype == torch.bfloat16 and out["n"].dtype == torch.int64
    assert out["w"].float().tolist() == tree["w"].tolist()
    assert int(out["n"]) == 3
    with pytest.raises(NotImplementedError, match="mesh"):
        checkpoint.restore("unused", 2, like, shardings={"w": None})


def test_checkpoint_async_and_prune(tmp_path):
    tree = {"x": torch.arange(10)}
    for s in (1, 2, 3):
        t = checkpoint.save(str(tmp_path), s, tree, blocking=False)
        assert isinstance(t, threading.Thread)
        t.join(timeout=30)
        assert not t.is_alive()
    checkpoint.prune(str(tmp_path), keep=2)
    assert checkpoint.latest_step(str(tmp_path)) == 3
    assert not os.path.isdir(os.path.join(str(tmp_path), "step_000001"))
    assert os.path.isdir(os.path.join(str(tmp_path), "step_000002"))


def test_async_save_keeps_the_values_of_the_call(tmp_path):
    """The tensors are copied to the host before ``save`` returns, so an
    in-place write right after it (the next step) does not reach the
    file."""
    tree = {"x": torch.zeros(1000)}
    t = checkpoint.save(str(tmp_path), 1, tree, blocking=False)
    tree["x"].fill_(7.0)
    t.join(timeout=30)
    out = checkpoint.restore(str(tmp_path), 1, tree, device="cpu")
    assert float(out["x"].abs().max()) == 0.0


def test_incomplete_checkpoint_rejected(tmp_path):
    d = tmp_path / "step_000009"
    d.mkdir(parents=True)
    with pytest.raises(FileNotFoundError):
        checkpoint.restore(str(tmp_path), 9, {"x": torch.zeros(1)},
                           device="cpu")
    assert checkpoint.latest_step(str(tmp_path)) is None


def test_params_to_numpy_round_trips(tmp_path):
    state = _np_state("qwen3-32b")
    back = params_to_numpy(params_from_numpy(state, device="cpu"))
    _assert_equal_trees(back, state)
    assert list(back) == ["opt", "params"]
