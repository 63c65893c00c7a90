"""The port's multi-rank layer against the JAX package, on the CPU.

``flash_decode`` and ``gpipe`` run on worlds of 2 and 4 gloo ranks
(``run_ranks``, one process a rank), and the reference's
``make_flash_decode`` and ``gpipe`` on 2 and 4 virtual devices (one
subprocess each: the device count is fixed at JAX's first init), on the
same numpy inputs from a seed.  Tolerance rtol/atol 2e-5, the reference's
own (tests/test_flash_decode.py, tests/test_dryrun_small.py).  Each world
and each JAX subprocess is started once for the module.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate

from repro_torch.launch.mesh import run_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=2e-5, atol=2e-5)
B, L, H, KV, HD = 4, 64, 8, 2, 16
#: the reference test's valid lengths, and a row with nothing valid; at 4
#: ranks row 0 leaves shards 1-3 fully masked
LENGTHS = (10, 40, 63, -1)
N_MICRO, WIDTH = 6, 16

JAX_SCRIPT = r"""
import os, sys
os.nice(10)
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=" + sys.argv[1]
import jax, jax.numpy as jnp, numpy as np
from repro.launch.mesh import make_mesh
from repro.models.common import ModelConfig
from repro.pipeline.gpipe import gpipe
from repro.serve.decode_sharded import make_flash_decode

w = int(sys.argv[1])
x = dict(np.load(sys.argv[2]))
out = {}
f = make_flash_decode(make_mesh((w,), ("model",)),
                      ModelConfig(num_heads=8, num_kv_heads=2, head_dim=16))
out["fd"] = np.asarray(f(x["q"], x["k"], x["v"], x["valid"]))
stage_fn = lambda p, a: jnp.tanh(a @ p["w"])
g = gpipe(stage_fn, make_mesh((w,), ("stage",)), n_stages=w, n_micro=6)
out["gp"] = np.asarray(g({"w": x["w"][:w]}, x["x"]))
np.savez(sys.argv[3], **out)
"""


def make_inputs(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return {
        "q": rng.standard_normal((B, 1, H, HD)).astype(f32),
        "k": rng.standard_normal((B, L, KV, HD)).astype(f32),
        "v": rng.standard_normal((B, L, KV, HD)).astype(f32),
        "valid": np.arange(L)[None, :] <= np.asarray(LENGTHS)[:, None],
        "w": (rng.standard_normal((4, WIDTH, WIDTH)) * 0.5).astype(f32),
        "x": rng.standard_normal((N_MICRO, 8, WIDTH)).astype(f32),
    }


def _tanh_stage(p, a):
    return torch.tanh(a @ p["w"])


def rank_body(inputs: dict) -> dict:
    """One rank's share: flash-decode over the whole world as the model
    axis, gpipe over it as the stage axis (params sharded by stage), the
    single-stage identity on a (world, 1) mesh, and what the mesh layer
    says of itself."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.device import use_device
    from repro_torch.launch.mesh import make_host_mesh, make_mesh
    from repro_torch.models.common import ModelConfig
    from repro_torch.pipeline import gpipe
    from repro_torch.pipeline.gpipe import shift_route
    from repro_torch.serve.decode_sharded import make_flash_decode
    torch.set_num_threads(1)
    os.nice(10)                 # below the rest of the suite
    w = dist.get_world_size()
    x = {k: torch.from_numpy(v) for k, v in inputs.items()}
    out = {}
    with use_device("cpu"):
        mesh = make_mesh((w,), ("model",))
        f = make_flash_decode(mesh, ModelConfig(num_heads=8, num_kv_heads=2,
                                                head_dim=16))
        # k, v and valid: each rank builds only its own slice
        n = L // w
        r = dist.get_rank()
        seq = [Shard(1)]

        def local(t):
            return DTensor.from_local(t[:, r * n:(r + 1) * n].clone(), mesh,
                                      seq, run_check=False)
        fd = f(x["q"], local(x["k"]), local(x["v"]), local(x["valid"]))
        out["fd"] = fd.to_local().numpy()
        out["fd_placements"] = tuple(fd.placements)
        out["fd_plain"] = f(x["q"], x["k"], x["v"], x["valid"]) \
            .to_local().numpy()

        smesh = make_mesh((w,), ("stage",))
        stacked = {"w": DTensor.from_local(x["w"][r:r + 1].clone(), smesh,
                                           [Shard(0)], run_check=False)}
        y = gpipe(_tanh_stage, smesh, n_stages=w, n_micro=N_MICRO)(
            stacked, x["x"])
        out["gp"] = y.to_local().numpy()
        out["gp_plain"] = gpipe(_tanh_stage, smesh, n_stages=w,
                                n_micro=N_MICRO)({"w": x["w"][:w]},
                                                 x["x"]).to_local().numpy()

        one = make_mesh((w, 1), ("data", "stage"))
        ident = gpipe(lambda p, a: a * p["scale"], one, n_stages=1,
                      n_micro=3)({"scale": torch.full((1,), 2.0)},
                                 torch.arange(12.0).reshape(3, 4))
        out["identity"] = ident.to_local().numpy()
        out["identity_placements"] = tuple(ident.placements)
        group = smesh.get_group("stage")
        out["routes"] = (shift_route(group, torch.device("cpu")),
                         shift_route(group, torch.device("cuda")))
        host = make_host_mesh(model=w)
        out["host"] = (tuple(host.mesh_dim_names), tuple(host.shape))
        out["stage_host"] = tuple(make_host_mesh(stage=w).shape)
        try:
            make_mesh((w + 1,), ("model",))
        except ValueError as e:
            out["bad_shape"] = str(e)
    return out


def failing_body(bad_rank: int, how: str) -> int:
    import torch.distributed as dist
    if dist.get_rank() == bad_rank:
        if how == "exit":
            os._exit(3)             # dies as a native crash would: no result
        raise ValueError(f"rank {bad_rank} gives up")
    dist.barrier()
    return dist.get_rank()


def tensor_body() -> dict:
    import torch.distributed as dist
    r = dist.get_rank()
    return {"t": torch.full((3,), float(r)), "pair": (torch.arange(4) + r, r)}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """{world size: (each rank's results, the reference's outputs)}."""
    d = tmp_path_factory.mktemp("multirank")
    inputs = make_inputs()
    path = str(d / "inputs.npz")
    np.savez(path, **inputs)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    procs = {w: subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, str(w), path,
         str(d / f"ref{w}.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for w in (2, 4)}
    try:
        ranks = {w: run_ranks(rank_body, w, backend="gloo", args=(inputs,),
                              timeout=300) for w in (2, 4)}
    finally:
        outs = {w: p.communicate(timeout=600) for w, p in procs.items()}
    for w, p in procs.items():
        assert p.returncode == 0, outs[w][1][-3000:]
    return inputs, {w: (ranks[w], dict(np.load(str(d / f"ref{w}.npz"))))
                    for w in (2, 4)}


def _dense(inputs) -> np.ndarray:
    """float64 softmax attention over the whole cache; a row with nothing
    valid gives zeros, as the two-pass rule does."""
    q = inputs["q"].astype(np.float64)
    qg = q.reshape(B, KV, H // KV, HD) * HD ** -0.5
    s = np.einsum("bkgh,bskh->bkgs", qg, inputs["k"].astype(np.float64))
    s = np.where(inputs["valid"][:, None, None, :], s, -np.inf)
    m = np.max(s, axis=-1, keepdims=True)
    p = np.exp(np.where(np.isfinite(s), s - np.where(np.isfinite(m), m, 0),
                        -np.inf))
    p = p / np.maximum(p.sum(axis=-1, keepdims=True), 1e-30)
    return np.einsum("bkgs,bskh->bkgh", p, inputs["v"].astype(
        np.float64)).reshape(B, 1, H, HD)


@pytest.mark.parametrize("w", [2, 4])
def test_flash_decode_matches_the_reference(results, w):
    inputs, by_w = results
    ranks, ref = by_w[w]
    for r in ranks:
        np.testing.assert_allclose(r["fd"], ref["fd"], **TOL)
        np.testing.assert_array_equal(r["fd"], ranks[0]["fd"])
        # the full cache on every rank, sharded by the function itself
        np.testing.assert_array_equal(r["fd_plain"], r["fd"])
        assert r["fd_placements"] == (Replicate(),)
    np.testing.assert_allclose(ranks[0]["fd"], _dense(inputs), **TOL)
    # the fully masked row: zeros, in both packages
    assert not ranks[0]["fd"][3].any() and not ref["fd"][3].any()
    assert np.isfinite(ranks[0]["fd"]).all()


@pytest.mark.parametrize("w", [2, 4])
def test_gpipe_matches_the_reference(results, w):
    inputs, by_w = results
    ranks, ref = by_w[w]
    seq = torch.from_numpy(inputs["x"])
    for s in range(w):
        seq = _tanh_stage({"w": torch.from_numpy(inputs["w"][s])}, seq)
    for r in ranks:
        np.testing.assert_allclose(r["gp"], ref["gp"], **TOL)
        np.testing.assert_allclose(r["gp"], seq.numpy(), **TOL)
        np.testing.assert_array_equal(r["gp_plain"], r["gp"])


def test_gpipe_single_stage_identity(results):
    _, by_w = results
    for r in by_w[2][0]:
        np.testing.assert_allclose(
            r["identity"], np.arange(12.0).reshape(3, 4) * 2.0)
        assert r["identity_placements"] == (Replicate(), Replicate())


def test_mesh_helpers_and_the_shift_route(results):
    _, by_w = results
    for w, (ranks, _) in by_w.items():
        r = ranks[0]
        assert r["routes"] == ("send/recv", "host-staged send/recv")
        assert r["host"] == (("data", "model"), (1, w))
        assert r["stage_host"] == (w,)
        assert f"needs {w + 1} ranks" in r["bad_shape"]


def test_run_ranks_raises_with_the_failing_ranks_traceback():
    with pytest.raises(RuntimeError) as info:
        run_ranks(failing_body, 2, backend="gloo", args=(1, "raise"),
                  timeout=120)
    text = str(info.value)
    assert "rank 1 of 2 (gloo)" in text
    assert "ValueError: rank 1 gives up" in text and "failing_body" in text


def test_run_ranks_names_a_rank_that_died_without_a_result():
    with pytest.raises(RuntimeError) as info:
        run_ranks(failing_body, 2, backend="gloo", args=(1, "exit"),
                  timeout=120)
    text = str(info.value)
    assert text.startswith("rank 0 of 2; ranks that died without a "
                           "result: {1: 3} (exit codes) (gloo)"), text


def test_run_ranks_returns_tensors_by_value():
    out = run_ranks(tensor_body, 2, backend="gloo", timeout=120)
    for r, res in enumerate(out):
        assert torch.equal(res["t"], torch.full((3,), float(r)))
        assert torch.equal(res["pair"][0], torch.arange(4) + r)
        assert res["pair"][1] == r
        # a copy, not shared memory behind a descriptor of the rank's,
        # which dies with it
        assert not res["t"].is_shared()
