"""The sharded train step through DTensor, on the CPU.

The counterpart of the reference's ``test_sharded_train_step_8dev``: each
tiny arch's parameters are ``distribute_tensor``'d by ``param_shardings``
over a (2, 2) ``("data", "model")`` mesh of 4 gloo ranks, the batch is
``Shard(0)`` over ``data``, and two ``make_train_step`` steps run under
``use_mesh`` with the reference's train rules (``rules_for(arch,
"train")``).  Held: every loss finite, the second below the first (as the
reference holds), both losses and both gradient norms within rtol 1e-5
of the port's unsharded step on the same parameters and batch (float32
sums in another order across ranks), and every activation that reaches ``constrain`` under the mesh a
DTensor, so no unsharded path hides.  One world runs the archs of a
file: the dense, GQA, local-window and VLM archs here; the MoE, recurrent
and encoder-decoder ones in ``test_torch_sharded_step_moe_recurrent.py``
(a world's first step of each new shape pays for DTensor's sharding
propagation, so the ten archs take two files' time on two workers).
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.launch.mesh import run_ranks

ARCHS = ("deepseek-7b", "qwen1.5-4b", "qwen3-32b", "gemma3-1b",
         "internvl2-2b")
B, S = 8, 16


def tiny_f32(arch: str):
    """The tiny config computing in float32: bf16 partial sums, rounded
    on each rank before they are added, would differ from the unsharded
    step by far more than 1e-5."""
    return dataclasses.replace(configs.get_tiny(arch),
                               compute_dtype=torch.float32)


def make_batch(cfg, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S))
             .astype(np.int32)}
    if cfg.enc_layers:
        batch["frontend"] = rng.standard_normal(
            (B, 8, cfg.frontend_dim)).astype(np.float32)
    elif cfg.frontend_dim:
        batch["frontend"] = rng.standard_normal(
            (B, cfg.num_prefix, cfg.frontend_dim)).astype(np.float32)
    return batch


def two_steps(arch: str, mesh=None, rules=None) -> list:
    """Two train steps from the seed-0 parameters on ``make_batch``'s
    batch, unsharded or over ``mesh`` under ``rules``: each step's loss
    and gradient norm."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.models import init_lm
    from repro_torch.optim import adamw
    from repro_torch.sharding import api as shapi
    from repro_torch.sharding import params as shparams
    from repro_torch.train.step import make_train_step
    cfg = tiny_f32(arch)
    params = init_lm(torch.Generator("cpu").manual_seed(0), cfg,
                     device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in make_batch(cfg).items()}
    if mesh is not None:
        params = shparams.distribute_params(params, mesh, rules)
        batch = {k: DTensor.from_local(v, mesh, [Replicate(), Replicate()],
                                       run_check=False)
                 .redistribute(mesh, [Shard(0), Replicate()])
                 for k, v in batch.items()}
    step = make_train_step(cfg, adamw.AdamWConfig(lr=1e-3))
    opt = adamw.init(params)
    out = []
    with shapi.use_mesh(mesh, rules):
        err = None
        for _ in range(2):
            params, opt, metrics, err = step(params, opt, batch, err)
            out.append([float(v.full_tensor() if isinstance(v, DTensor)
                              else v)
                        for v in (metrics["loss"], metrics["grad_norm"])])
    return out


def rank_body(archs) -> dict:
    """Each arch's two sharded steps (loss, gradient norm) on this rank,
    and how many activations reached ``constrain`` under the mesh as
    DTensors and as plain tensors."""
    from torch.distributed.tensor import DTensor

    from repro_torch.device import use_device
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.rules import rules_for
    from repro_torch.models import (attention, blocks, moe, recurrent,
                                    transformer)
    from repro_torch.sharding import api as shapi
    from repro_torch.train import step as step_mod
    # four busy ranks: one thread each, below the rest of the suite
    torch.set_num_threads(1)
    os.nice(10)
    seen = {"dtensor": 0, "plain": []}
    real = shapi.constrain

    def spy(x, *logical):
        if shapi.current_binding() is not None:
            if isinstance(x, DTensor):
                seen["dtensor"] += 1
            else:
                seen["plain"].append(logical)
        return real(x, *logical)

    mods = (attention, blocks, moe, recurrent, transformer, step_mod)
    for m in mods:
        m.constrain = spy
    out = {}
    try:
        with use_device("cpu"):
            mesh = make_mesh((2, 2), ("data", "model"))
            for arch in archs:
                seen["dtensor"], seen["plain"] = 0, []
                steps = two_steps(arch, mesh, rules_for(arch, "train"))
                out[arch] = (steps, seen["dtensor"], list(seen["plain"]))
    finally:
        for m in mods:
            m.constrain = real
    return out


def check_arch(sharded, arch) -> None:
    steps, n_dtensor, plain = sharded[0][arch]
    assert all(r[arch][0] == steps for r in sharded), [
        r[arch][0] for r in sharded]
    losses = [loss for loss, _ in steps]
    assert all(np.isfinite(steps).ravel()), steps
    # two steps on the same batch: the loss must drop
    assert losses[1] < losses[0], losses
    # the gradient norm too: AdamW's first update barely depends on the
    # gradients' scale, so the losses alone would not show a partial sum
    # taken for a whole one
    np.testing.assert_allclose(steps, two_steps(arch), rtol=1e-5)
    assert n_dtensor > 0 and not plain, (n_dtensor, plain)


@pytest.fixture(scope="module")
def sharded():
    return run_ranks(rank_body, 4, backend="gloo", args=(ARCHS,),
                     timeout=600)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_step_on_a_2x2_mesh(sharded, arch):
    check_arch(sharded, arch)
