"""The sharded decode step through DTensor, on the CPU.

Each case's tiny arch's parameters are ``distribute_params``'d over a (2, 2)
``("data", "model")`` mesh of 4 gloo ranks under the dry-run's decode
rules (``rules_for(arch, "decode")``: the KV cache sharded over the batch
on ``data`` and over its sequence on ``model``), the decode state is
placed by ``launch.specs.decode_shardings`` and the tokens and positions
over ``data`` (a batch of one stays whole).  Three ``decode_step``
calls then run on both the sharded
and the unsharded state, from positions that put the new K/V in either
rank's span of the cache and, for the local-window ring, wrap it.  Held:
every step's logits and the whole decode state within rtol 1e-5 of the
unsharded step, entries near 0 within 1e-5 of their array's largest
magnitude (float32 sums in another order across ranks), on every rank,
and every K/V cache still placed as the rules say.  That
covers the sharded cache write (``attention._write_shards``), the decode
attention over the sequence-sharded cache and the vocab-parallel token
lookup (``transformer.decode_step``), and RWKV's state read per rank
(``recurrent.rwkv_tmix_step``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.launch.mesh import run_ranks

# (arch, batch): a batch of 1 is not sharded, and its lookup's partial
# sums meet the rest of the step unreduced unless they are reduced first
CASES = (("deepseek-7b", 4), ("grok-1-314b", 4), ("recurrentgemma-2b", 4),
         ("rwkv6-1.6b", 4), ("deepseek-7b", 1))
CACHE, STEPS = 16, 3
POS0 = (0, 5, 9, 14)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        return {k: v for key in tree
                for k, v in _flat(tree[key], path + (key,)).items()}
    if isinstance(tree, list):
        return {k: v for i, t in enumerate(tree)
                for k, v in _flat(t, path + (i,)).items()}
    return {path: tree}


def _placed(tree, fn, path=()):
    """``tree`` with each leaf ``t`` at ``path`` replaced by
    ``fn(path, t)``."""
    if isinstance(tree, dict):
        return {k: _placed(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_placed(v, fn, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def decode_run(arch: str, b: int, mesh=None) -> list:
    """``STEPS`` decode steps of the tiny float32 arch from seed 0,
    unsharded or over ``mesh``: each step's logits and the final state,
    as numpy arrays."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import specs as specs_lib
    from repro_torch.launch.rules import rules_for
    from repro_torch.models import decode_step, init_decode_state, init_lm
    from repro_torch.sharding import api as shapi
    from repro_torch.sharding import params as shparams
    cfg = dataclasses.replace(configs.get_tiny(arch),
                              compute_dtype=torch.float32)
    rules = rules_for(arch, "decode")
    params = init_lm(torch.Generator("cpu").manual_seed(0), cfg,
                     device="cpu")
    state = init_decode_state(cfg, b, CACHE, device="cpu")
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (STEPS, b)).astype(np.int32))
    pos0 = torch.tensor(POS0[-b:], dtype=torch.int32)

    def place(t, spec):
        whole = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        return whole.redistribute(mesh, shapi.to_placements(spec, mesh))

    if mesh is not None:
        params = shparams.distribute_params(params, mesh, rules)
        tok_sh, _, st_sh, _ = specs_lib.decode_shardings(
            cfg, ShapeSpec("t", CACHE, b, "decode"), mesh, rules)
        flat_sh = _flat(st_sh)
        state = _placed(state, lambda path, t: place(t, flat_sh[path]))
    out = []
    with shapi.use_mesh(mesh, rules), torch.no_grad():
        for i in range(STEPS):
            tok, pos = tokens[i], pos0 + i
            if mesh is not None:
                tok, pos = place(tok, tok_sh), place(pos, tok_sh)
            logits, state = decode_step(params, tok, pos, state, cfg)
            out.append(logits)
    if mesh is not None:        # no cache was gathered on the way
        for path, t in _flat(state).items():
            if path[-1] in ("k", "v"):
                assert t.placements == shapi.to_placements(
                    flat_sh[path], mesh), path
    whole = [t.full_tensor() if isinstance(t, DTensor) else t
             for t in out + list(_flat(state).values())]
    return [t.numpy() for t in whole], list(_flat(state))


def rank_body(cases) -> dict:
    from repro_torch.device import use_device
    from repro_torch.launch.mesh import make_mesh
    torch.set_num_threads(1)
    with use_device("cpu"):
        mesh = make_mesh((2, 2), ("data", "model"))
        return {(arch, b): decode_run(arch, b, mesh) for arch, b in cases}


@pytest.fixture(scope="module")
def sharded():
    return run_ranks(rank_body, 4, backend="gloo", args=(CASES,),
                     timeout=600)


@pytest.mark.parametrize("arch,b", CASES)
def test_sharded_decode_step_equals_the_unsharded_one(sharded, arch, b):
    want, paths = decode_run(arch, b)
    for rank in sharded:
        got, got_paths = rank[(arch, b)]
        assert got_paths == paths
        assert len(got) == len(want)
        for g, w in zip(got, want):
            # rtol 1e-5, and entries near 0 held at 1e-5 of the array's
            # largest magnitude (float32 sums in another order)
            np.testing.assert_allclose(
                g, w, rtol=1e-5, atol=1e-5 * float(np.abs(w).max()))
