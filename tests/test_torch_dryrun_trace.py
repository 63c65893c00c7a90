"""The dry-run's cost tracer and traced cells, on the CPU.

The tracer that stands in for XLA's ``cost_analysis`` and
``memory_analysis`` is held against ``FlopCounterMode`` on the real
unsharded step (one fake rank) and against a hand count on a (2, 4) fake
world; ``lower_cell`` and ``main`` run tiny and full-width cells on fake
worlds with ``device="cpu"``; the two-point extrapolation is held against
the reference's, compiled from its source (importing the reference's
``dryrun.py`` sets ``XLA_FLAGS`` for the process).  Only the tests that
compare with the reference import it, so the rest of the file runs where
the JAX package is not installed (the card's machine, torch 2.11).
"""
import ast
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.configs import ShapeSpec
from repro_torch.launch import dryrun as tdryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import roofline as troofline
from repro_torch.launch import specs as tspecs
from repro_torch.launch.cost import CostMode
from repro_torch.models import init_lm as tinit_lm

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _ref_source() -> ast.Module:
    return ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())


def _ref_function(name: str, namespace: dict):
    """A function of the reference's dry-run, compiled from its source
    into ``namespace``."""
    node = next(n for n in _ref_source().body
                if isinstance(n, ast.FunctionDef) and n.name == name)
    exec(compile(ast.Module([node], []), "dryrun.py", "exec"), namespace)
    return namespace[name]



def _batch(cfg, shape, seed=0):
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in tspecs.train_like_specs(cfg, shape).items():
        if v.dtype == torch.int32:
            out[k] = torch.from_numpy(rng.integers(
                0, cfg.vocab_size, tuple(v.shape)).astype(np.int32))
        else:
            out[k] = torch.from_numpy(rng.standard_normal(
                tuple(v.shape)).astype(np.float32))
    return out


@pytest.mark.parametrize("arch", ["deepseek-7b", "grok-1-314b",
                                  "recurrentgemma-2b",
                                  "seamless-m4t-large-v2"])
def test_traced_step_on_one_rank_counts_what_the_real_step_does(arch):
    """One fake rank: the traced FLOPs equal ``FlopCounterMode`` on the
    real unsharded step, and the argument bytes the real tensors'."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.models.common import tree_leaves
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_step
    cfg = tconfigs.get_tiny(arch)
    shape = ShapeSpec("tiny_train", 16, 4, "train")
    with tmesh.fake_world(1):
        mesh = tmesh.make_mesh((1, 1), ("data", "model"), device="cpu")
        trace, memory, rf = tdryrun.lower_cell(
            arch, "tiny_train", "single", cfg=cfg, shape=shape, mesh=mesh,
            device="cpu", return_artifacts=True)
    params = tinit_lm(torch.Generator("cpu").manual_seed(0), cfg,
                      device="cpu")
    opt = adamw.init(params)
    batch = _batch(cfg, shape)
    args = tree_leaves(params) + tree_leaves(opt) + list(batch.values())
    counter = FlopCounterMode(display=False)
    with counter:
        make_train_step(cfg, adamw.AdamWConfig())(params, opt, batch, None)
    assert trace.flops == counter.get_total_flops() > 0
    assert trace.argument_bytes == sum(t.nbytes for t in args)
    assert memory["argument_size"] == trace.argument_bytes
    assert trace.collectives == []
    assert rf.n_chips == 1 and trace.peak_bytes > trace.argument_bytes


def test_hand_counted_mlp_on_a_2x4_world():
    """Two products whose weights are sharded over ``model`` and gathered
    whole before use (FSDP), on a batch sharded over all eight ranks."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    b, d, f = 64, 32, 128
    with tmesh.fake_world(8):
        mesh = tmesh.make_mesh((2, 4), ("data", "model"), device="cpu")
        mode = CostMode()
        with mode:
            x = DTensor.from_local(torch.empty(b // 8, d), mesh,
                                   [Shard(0), Shard(0)], run_check=False)
            w1 = DTensor.from_local(torch.empty(d // 4, f), mesh,
                                    [Replicate(), Shard(0)], run_check=False)
            w2 = DTensor.from_local(torch.empty(f // 4, d), mesh,
                                    [Replicate(), Shard(0)], run_check=False)
            mode.begin((x, w1, w2))
            whole = [Replicate(), Replicate()]
            h = x @ w1.redistribute(mesh, whole)
            y = h @ w2.redistribute(mesh, whole)
            trace = mode.end(y)
    rows = b // 8
    assert trace.flops == 2 * rows * d * f + 2 * rows * f * d
    assert trace.bytes == 4 * ((rows * d + d * f + rows * f)
                               + (rows * f + f * d + rows * d))
    assert trace.collectives == [("all-gather", 4 * d * f, 4),
                                 ("all-gather", 4 * f * d, 4)]
    args = 4 * (rows * d + d // 4 * f + f // 4 * d)
    assert trace.argument_bytes == args
    assert trace.output_bytes == 4 * rows * d
    # at the peak: the arguments, h, the gathered w2 and y (the gathered
    # w1 is freed once h is made)
    assert trace.peak_bytes == args + 4 * (rows * f + f * d + rows * d)
    assert troofline.collective_bytes(trace.collectives) == {
        "all-gather": 2 * 4 * d * f * 3 / 4, "total": 2 * 4 * d * f * 3 / 4}


def test_indexed_ops_count_the_rows_they_move():
    """A cache's row write and read count their indices and twice the
    rows, not the cache."""
    mode = CostMode()
    with mode:
        cache, new = torch.empty(8, 1024, 4, 16), torch.empty(8, 4, 16)
        rows = torch.arange(8)
        slot = torch.zeros(8, dtype=torch.long)
        mode.begin((cache, new, rows, slot))
        cache[rows, slot] = new
        got = cache[rows, slot]
        trace = mode.end(got)
    indices, moved = 2 * 8 * 8, 8 * 4 * 16 * 4
    assert trace.ops == 2 and trace.flops == 0
    assert trace.bytes == 2 * (indices + 2 * moved)
    assert trace.output_bytes == moved
    assert trace.peak_bytes == trace.argument_bytes + moved


def test_remat_recompute_keeps_the_mesh_binding_on_another_thread(
        monkeypatch):
    """The backward pass of CUDA tensors runs on autograd's device
    thread, which inherits the dispatch state (fake modes, DTensor's
    implicit replication) but not the forward thread's mesh binding, a
    Python thread-local.  A remat group's recompute runs there, and must
    constrain its activations as the forward did: here the backward runs
    on a thread of its own, on a (1, 1) fake world of real tensors."""
    import threading

    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models import attention, blocks, lm_loss, transformer
    from repro_torch.models.common import tree_from_items, tree_items
    from repro_torch.sharding import api as shapi
    from repro_torch.sharding import params as shparams
    seen = {True: 0, False: 0}
    real = shapi.constrain

    def spy(x, *logical):
        if isinstance(x, DTensor):
            seen[shapi.current_binding() is not None] += 1
        return real(x, *logical)

    for m in (attention, blocks, transformer):
        monkeypatch.setattr(m, "constrain", spy)
    cfg = tconfigs.get_tiny("deepseek-7b")
    assert cfg.remat
    with tmesh.fake_world(1):
        mesh = tmesh.make_mesh((1, 1), ("data", "model"), device="cpu")
        rules = tdryrun.rules_for("deepseek-7b", "train")
        params = shparams.distribute_params(tinit_lm(
            torch.Generator("cpu").manual_seed(0), cfg, device="cpu"),
            mesh, rules)
        tokens = DTensor.from_local(_batch(cfg, ShapeSpec(
            "t", 8, 2, "train"))["tokens"], mesh, [Replicate()] * 2,
            run_check=False)
        live = [p.detach().requires_grad_(True)
                for _, p in tree_items(params)]
        with shapi.use_mesh(mesh, rules):
            loss, _ = lm_loss(tree_from_items(params, live),
                              {"tokens": tokens}, cfg)
        forward = seen[True]
        assert forward > 0 and seen[False] == 0
        grads = []

        def backward():
            with implicit_replication():
                grads.extend(torch.autograd.grad(loss, live,
                                                 allow_unused=True))
        worker = threading.Thread(target=backward)
        worker.start()
        worker.join(timeout=120)
        assert not worker.is_alive() and len(grads) == len(live)
    # every group recomputed under the forward's binding
    assert seen[False] == 0 and seen[True] > forward


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_lower_cell_traces_tiny_cells_on_small_worlds(kind):
    # one layer: DTensor's sharding propagation of each new shape is
    # what takes the time here
    cfg = dataclasses.replace(tconfigs.get_tiny("deepseek-7b"), num_layers=1)
    shape = ShapeSpec(f"tiny_{kind}", 16, 8, kind)
    for dims, axes in (((2, 4), ("data", "model")),
                       ((2, 2, 2), ("pod", "data", "model"))):
        with tmesh.fake_world(8):
            mesh = tmesh.make_mesh(dims, axes, device="cpu")
            r = tdryrun.run_cell("deepseek-7b", shape.name, "single",
                                 cfg=cfg, shape=shape, mesh=mesh,
                                 device="cpu")
        assert r.ok, r.error
        rf = r.roofline
        assert rf["n_chips"] == 8
        for k in ("flops_per_chip", "bytes_per_chip", "coll_bytes_per_chip",
                  "t_compute", "t_memory", "t_collective", "t_bound",
                  "peak_mem_bytes"):
            assert np.isfinite(rf[k]) and rf[k] > 0, (k, rf[k])
        assert all(np.isfinite(v) for v in r.memory.values())
        assert r.memory["per_chip_total"] >= r.memory["argument_size"] > 0


def _trace_tiny_train(arch, cfg):
    """One tiny train step traced on a (2, 4) fake world; the
    ``CellResult``."""
    shape = ShapeSpec("tiny_train", 16, 4, "train")
    with tmesh.fake_world(8):
        mesh = tmesh.make_mesh((2, 4), ("data", "model"), device="cpu")
        return tdryrun.run_cell(arch, shape.name, "single", cfg=cfg,
                                shape=shape, mesh=mesh, device="cpu")


@pytest.mark.parametrize("arch,heads,kv_heads", [
    ("arctic-480b", 14, 2), ("deepseek-7b", 6, 2), ("deepseek-7b", 6, 6),
    ("deepseek-7b", 14, 2)])
def test_head_merge_backward_traces_when_the_model_axis_splits_no_head(
        arch, heads, kv_heads):
    """arctic-480b's case (56 heads on a 16-way ``model`` axis), reduced:
    heads that 4 does not divide stay whole in the forward, and the
    gradient of their merge before the output projection must be placed
    so again before the view that splits it into heads.  Before, torch
    2.11 refused that view in tiny arctic ("Attempted to split the
    sharded dimension 2", as in the full cell), and 2.13 placed the heads
    as a ``_StridedShard`` that the score products' backward could not
    propagate in the others."""
    cfg = dataclasses.replace(tconfigs.get_tiny(arch), num_layers=1,
                              num_heads=heads, num_kv_heads=kv_heads,
                              head_dim=16)
    r = _trace_tiny_train(arch, cfg)
    assert r.ok, r.error


@pytest.mark.parametrize("arch", ["grok-1-314b", "arctic-480b"])
def test_router_backward_traces_over_flattened_tokens(arch):
    """grok-1-314b's and arctic-480b's ``train_4k`` cells, reduced: the
    router's weight gradient is a product over the flattened (batch,
    seq) tokens, whose gradient torch 2.13's DTensor placed as a
    ``_StridedShard`` and then resolved with a data-dependent op that
    fake tensors refuse."""
    cfg = dataclasses.replace(tconfigs.get_tiny(arch), num_layers=1)
    r = _trace_tiny_train(arch, cfg)
    assert r.ok, r.error


def test_strided_shard_arithmetic_runs_on_host_values():
    """internvl2-2b's and rwkv6-1.6b's ``train_4k`` cells on the 2x16x16
    mesh, reduced to their failing product: a weight gradient over the
    flattened (batch, seq) rows of an activation whose sequence is
    sharded over ``model``.  Torch 2.13's DTensor places those rows as a
    ``_StridedShard`` and works out its local sizes by splitting a host
    tensor of indices and reading it back, which a fake tensor cannot
    (``aten._local_scalar_dense``).  The tracer runs that arithmetic on
    real tensors and counts only the step's ops: the rows gathered over
    ``model``, then one local product.  Torch 2.11's DTensor refuses the
    flatten instead, so no ``_StridedShard`` arises there."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    b, s, d, f = 8, 4, 16, 12
    with tmesh.fake_world(8):
        mesh = tmesh.make_mesh((4, 2), ("data", "model"), device="cpu")
        try:
            DTensor.from_local(torch.empty(b // 4, s // 2, d), mesh,
                               [Shard(0), Shard(1)]).reshape(b * s, d)
        except RuntimeError as e:
            pytest.skip(f"this torch's DTensor does not flatten a sharded "
                        f"sequence: {e}")
        mode = CostMode()
        with mode:
            x = DTensor.from_local(torch.empty(b // 4, s // 2, d), mesh,
                                   [Shard(0), Shard(1)], run_check=False)
            w = DTensor.from_local(torch.empty(f, b * s // 4), mesh,
                                   [Shard(1), Replicate()], run_check=False)
            mode.begin((x, w))
            y = w @ x.reshape(b * s, d)
            trace = mode.end(y)
    assert tuple(y.placements) == (Partial(), Replicate())
    assert trace.flops == 2 * f * (b * s // 4) * d
    assert trace.collectives == [("all-gather", 4 * b * s // 4 * d, 2)]


def _ref_schema() -> tuple:
    """The reference's ``CellResult`` fields and ``memory`` keys, read
    from its source."""
    tree = _ref_source()
    cell = next(n for n in tree.body
                if isinstance(n, ast.ClassDef) and n.name == "CellResult")
    fields = [s.target.id for s in cell.body if isinstance(s, ast.AnnAssign)]
    memory = next(n for n in ast.walk(tree) if isinstance(n, ast.Dict)
                  and any(isinstance(k, ast.Constant)
                          and k.value == "argument_size" for k in n.keys))
    return fields, [k.value for k in memory.keys]


def test_main_writes_the_reference_schema(tmp_path):
    from repro.launch import roofline as jroofline
    out = tmp_path / "dryrun"
    assert tdryrun.main(["--arch", "deepseek-7b", "--shape", "decode_32k",
                         "--device", "cpu", "--out", str(out)]) == 0
    row = json.loads((out / "deepseek-7b_decode_32k_single.json")
                     .read_text())
    fields, memory = _ref_schema()
    assert list(row) == fields
    assert list(row["memory"]) == memory
    ref = jroofline.Roofline(
        arch="a", shape="s", mesh="m", flops_per_chip=1.0,
        bytes_per_chip=1.0, coll_bytes_per_chip=1.0, coll_breakdown={},
        t_compute=1.0, t_memory=1.0, t_collective=1.0, model_flops=1.0,
        peak_mem_bytes=1.0, n_chips=1)
    assert list(row["roofline"]) == list(ref.to_dict())
    assert row["ok"] and row["roofline"]["n_chips"] == 256
    assert row["memory"]["generated_code_size"] == 0


def test_extrapolation_is_the_reference_lerp(monkeypatch):
    """Two synthetic depth points through both packages'
    ``lower_cell_extrapolated``."""
    from repro import configs as jconfigs
    from repro.launch import roofline as jroofline

    def point(pkg, g):
        rf = pkg.Roofline(
            arch="qwen3-32b", shape="train_4k", mesh="single",
            flops_per_chip=1e13 * g + 3e12, bytes_per_chip=2e11 * g + 5e10,
            coll_bytes_per_chip=7e9 * g,
            coll_breakdown={"all-gather": 5e9 * g, "total": 7e9 * g,
                            **({"all-reduce": 2e9 * g} if g > 1 else {})},
            t_compute=0.01 * g + 0.003, t_memory=0.02 * g + 0.001,
            t_collective=0.015 * g, model_flops=0.0,
            peak_mem_bytes=3e9 * g + 1e9, n_chips=256)
        mem = {"argument_size": 1e9 * g, "output_size": 16.0,
               "temp_size": 2e9 * g + 5e8, "generated_code_size": 0,
               "per_chip_total": 3e9 * g + 5e8}
        return mem, rf

    def stub(pkg):
        def lower_cell(arch, shape_name, mesh_name, *, cfg, **kw):
            return point(pkg, cfg.num_layers // cfg.group_size)
        return lower_cell

    ns = {"configs": jconfigs, "dataclasses": dataclasses,
          "roofline_lib": jroofline, "lower_cell": stub(jroofline)}
    ref = _ref_function("lower_cell_extrapolated", ns)
    monkeypatch.setattr(tdryrun, "lower_cell", stub(troofline))
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        want_mem, want_rf = ref("qwen3-32b", shape, "single")
        got_mem, got_rf = tdryrun.lower_cell_extrapolated(
            "qwen3-32b", shape, "single")
        assert got_mem == want_mem
        g, w = got_rf.to_dict(), want_rf.to_dict()
        assert {k: v for k, v in g.items() if k != "roofline_fraction"} \
            == {k: v for k, v in w.items() if k != "roofline_fraction"}
        assert g["mesh"] == "single*" and g["model_flops"] > 0


def test_the_dry_run_imports_no_fake_world_until_it_starts_one():
    code = ("import sys\n"
            "import repro_torch.launch.dryrun, repro_torch.launch.perf, "
            "repro_torch.launch.tabulate, repro_torch.launch.cost\n"
            "print(any('fake_pg' in m for m in sys.modules))\n"
            "from repro_torch.launch.mesh import fake_world\n"
            "with fake_world(4):\n"
            "    import torch.distributed as dist\n"
            "    print(dist.get_world_size())\n"
            "print(dist.is_initialized())\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.split() == ["False", "4", "False"]


def test_asking_for_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tdryrun.lower_cell("deepseek-7b", "decode_32k", "single")
    r = tdryrun.run_cell("deepseek-7b", "decode_32k", "single")
    assert not r.ok and "CUDA" in r.error
