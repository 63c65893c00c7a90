"""The pod axis of the dry-run's 2x16x16 mesh costs what the same shards
cost on a 2-D mesh, on the CPU.

The reference's GSPMD compiles a dimension sharded over ``("pod",
"data")`` as one sharding over the product of the two axes: one
collective a reduction or gather over its replica groups, one slice a
split.  The port's DTensor issues one collective a mesh dimension unless
the mesh holds a group for the run of dimensions (``launch.mesh.make_mesh``
makes one for every run), and splits a ``Replicate()`` tensor one mesh
dimension at a time, copying each piece.

The same tiny cell (one pattern group) is traced on two fake worlds of
eight ranks, (4, 2) ``("data", "model")`` and (2, 2, 2) ``("pod",
"data", "model")``: ``batch`` binds to ``("pod", "data")``, so every rank
holds the same local shards in both.  Their FLOPs, argument bytes,
collectives and peak are equal, and their local operations too, but for
the ops DTensor itself adds on the 3-D mesh, pinned by name, calls and
bytes (``DTENSOR_POD_OPS``).  The MoE archs are left out: their expert
tables bind to ``data`` alone, so the two worlds shard them differently.
"""
import collections
import dataclasses

import numpy as np
import pytest
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch import configs as tconfigs
from repro_torch.configs import ShapeSpec
from repro_torch.launch import cost as tcost
from repro_torch.launch import dryrun as tdryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.mesh import run_ranks

WORLDS = {"2d": ((4, 2), ("data", "model")),
          "3d": ((2, 2, 2), ("pod", "data", "model"))}

# (op, calls, bytes) that DTensor adds on the (2, 2, 2) mesh and no change
# in the port removes.  The loss's sum over the batch-sharded tokens has
# a Replicate gradient, which DTensor expands over the tokens and splits
# to the rank's rows one mesh dimension at a time: one more chunk and
# copy, of half the (B, S) float32 gradient (16 x 8 tokens here).  A tied
# embedding's gradient sums a Replicate part (the lookup's, reduced) and
# a Partial one (the logits'); DTensor makes the first Partial by dividing
# it by each mesh dimension's size in turn: one more division of the
# table's (128, 64) float32 shard.
_SUM_BACKWARD = {"aten.chunk.default": (1, 0),
                 "aten.clone.default": (1, 2 * 4 * 8 * 16 // 2)}
DTENSOR_POD_OPS = {
    ("deepseek-7b", "train"): _SUM_BACKWARD,
    ("recurrentgemma-2b", "train"): {
        **_SUM_BACKWARD, "aten.div.Tensor": (1, 2 * 4 * 128 * 64)},
    ("qwen3-32b", "decode"): {},
    ("seamless-m4t-large-v2", "prefill"): {},
}


def trace_world(arch: str, kind: str, world: str, monkeypatch) -> dict:
    """The tiny cell of ``arch`` (one pattern group) traced on a fake
    world of eight ranks: its ``CostTrace`` and, by op, the calls and
    bytes the tracer counted (a collective by its op and group size)."""
    cfg = tconfigs.get_tiny(arch)
    cfg = dataclasses.replace(cfg, num_layers=cfg.group_size)
    shape = ShapeSpec(f"tiny_{kind}", 16, 8, kind)
    ops = collections.defaultdict(lambda: [0, 0])
    count = tcost.CostMode._count

    def counted(self, func, args, kwargs, out):
        before, n = self.trace.bytes, len(self.trace.collectives)
        count(self, func, args, kwargs, out)
        if len(self.trace.collectives) > n:
            op, nbytes, group = self.trace.collectives[-1]
            key, moved = f"{op}[{group}]", nbytes
        else:
            key, moved = str(func), self.trace.bytes - before
        ops[key][0] += 1
        ops[key][1] += moved

    monkeypatch.setattr(tcost.CostMode, "_count", counted)
    dims, axes = WORLDS[world]
    with tmesh.fake_world(8):
        mesh = tmesh.make_mesh(dims, axes, device="cpu")
        trace, _, _ = tdryrun.lower_cell(
            arch, shape.name, "single", cfg=cfg, shape=shape, mesh=mesh,
            device="cpu", return_artifacts=True)
    monkeypatch.undo()
    return {"trace": trace, "ops": {k: tuple(v) for k, v in ops.items()}}


def op_diff(a: dict, b: dict) -> dict:
    """``{op: (calls, bytes)}`` that ``b`` counts beyond ``a``."""
    out = {}
    for k in set(a) | set(b):
        ca, ba = a.get(k, (0, 0))
        cb, bb = b.get(k, (0, 0))
        if (ca, ba) != (cb, bb):
            out[k] = (cb - ca, bb - ba)
    return out


@pytest.mark.parametrize("arch,kind", list(DTENSOR_POD_OPS))
def test_the_pod_axis_costs_what_the_same_shards_cost_on_a_2d_mesh(
        arch, kind, monkeypatch):
    flat = trace_world(arch, kind, "2d", monkeypatch)
    pod = trace_world(arch, kind, "3d", monkeypatch)
    a, b = flat["trace"], pod["trace"]
    assert b.flops == a.flops > 0
    assert b.argument_bytes == a.argument_bytes > 0
    assert sorted(b.collectives) == sorted(a.collectives)
    assert b.peak_bytes == a.peak_bytes
    pinned = DTENSOR_POD_OPS[(arch, kind)]
    assert op_diff(flat["ops"], pod["ops"]) == pinned
    assert b.bytes - a.bytes == sum(n for _, n in pinned.values())
    assert b.output_bytes == a.output_bytes


@pytest.mark.parametrize("placements,want", [
    ([Partial()] * 3, ("all-reduce", 8)),
    ([Partial(), Partial(), Replicate()], ("all-reduce", 4)),
    ([Replicate(), Partial(), Partial()], ("all-reduce", 4)),
    ([Shard(0), Shard(0), Replicate()], ("all-gather", 4)),
], ids=["pod-data-model", "pod-data", "data-model", "gather-pod-data"])
def test_a_reduction_over_several_mesh_dims_is_one_collective(
        placements, want):
    """On a (2, 2, 2) mesh from ``make_mesh``, DTensor reduces a Partial,
    or gathers a Shard, over adjacent mesh dimensions in one collective
    over their product's group, as GSPMD does."""
    with tmesh.fake_world(8):
        mesh = tmesh.make_mesh((2, 2, 2), ("pod", "data", "model"),
                               device="cpu")
        mode = tcost.CostMode()
        with mode:
            rows = 8 // (4 if want[0] == "all-gather" else 1)
            x = DTensor.from_local(torch.empty(rows, 4), mesh, placements,
                                   run_check=False)
            mode.begin((x,))
            y = x.redistribute(mesh, [Replicate()] * 3)
            trace = mode.end(y)
    assert trace.collectives == [(want[0], 8 * 4 * 4, want[1])]


def _narrow_rank() -> list:
    """One rank of a (2, 2, 2) world: ``narrow_to`` against DTensor's own
    split, and a ZeRO-1 AdamW step (moments sharded further over
    ``("pod", "data")`` than the parameters) against the plain update."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import adamw
    from repro_torch.sharding import api as shapi
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
    g = torch.Generator().manual_seed(0)
    out = []
    x = torch.randn(6, 10, generator=g)           # 6 rows: uneven over 4
    for src, dst in (
            ([Replicate()] * 3, [Shard(0), Shard(0), Replicate()]),
            ([Replicate(), Replicate(), Shard(1)],
             [Shard(0), Shard(0), Shard(1)]),
            ([Replicate(), Shard(1), Replicate()],
             [Shard(0), Shard(1), Shard(0)])):
        d = DTensor.from_local(x, mesh, [Replicate()] * 3).redistribute(
            mesh, src)
        want = d.redistribute(mesh, dst)
        got = shapi.narrow_to(d, want)
        out.append((got.placements == want.placements,
                    torch.equal(got.to_local(), want.to_local())))
    cfg = adamw.AdamWConfig(warmup_steps=2)
    full = {"w": torch.randn(8, 6, generator=g),
            "b": torch.randn(8, generator=g)}
    grads = {k: torch.randn(v.shape, generator=g) for k, v in full.items()}
    state = adamw.init(full)
    for m in ("mu", "nu"):
        state[m] = {k: torch.rand(v.shape, generator=g)
                    for k, v in full.items()}
    p_pl = {"w": [Replicate(), Replicate(), Shard(1)],
            "b": [Replicate()] * 3}
    o_pl = {"w": [Shard(0), Shard(0), Shard(1)],
            "b": [Shard(0), Shard(0), Replicate()]}

    def place(t, pl):
        return DTensor.from_local(t, mesh, [Replicate()] * 3).redistribute(
            mesh, pl)
    with shapi.use_mesh(mesh):
        params = {k: place(v.clone(), p_pl[k]) for k, v in full.items()}
        dgrads = {k: place(v.clone(), p_pl[k]) for k, v in grads.items()}
        dstate = {m: {k: place(v.clone(), o_pl[k])
                      for k, v in state[m].items()} for m in ("mu", "nu")}
        dstate["step"] = place(state["step"].clone(), [Replicate()] * 3)
        new_p, new_s, _ = adamw.update(cfg, dgrads, dstate, params)
        sharded = {k: v.full_tensor() for k, v in new_p.items()}
        moments = {m: {k: v.full_tensor() for k, v in new_s[m].items()}
                   for m in ("mu", "nu")}
    want_p, want_s, _ = adamw.update(cfg, grads, state, full)
    out.append(all(torch.allclose(sharded[k], want_p[k], rtol=1e-6,
                                  atol=1e-7) for k in full))
    out.append(all(torch.allclose(moments[m][k], want_s[m][k], rtol=1e-6,
                                  atol=1e-7)
                   for m in ("mu", "nu") for k in full))
    return out


def test_narrow_to_and_a_zero1_update_on_eight_gloo_ranks():
    """``narrow_to`` takes each rank's block of a further split in one
    view, the same values DTensor's split copies out (6 rows over four
    ranks included); AdamW, which places each gradient as its ZeRO-1
    moment with it, updates the parameters and moments as the plain
    update does."""
    for result in run_ranks(_narrow_rank, 8, backend="gloo"):
        assert np.all(result[:3]) and result[3] and result[4], result



def main() -> int:
    """Every non-MoE arch x (train, prefill, decode) through the same
    two worlds: ``PYTHONPATH=src python tests/test_torch_dryrun_pod.py``
    prints, per case, whether FLOPs, argument bytes, collectives and peak
    are equal, and the ops the 3-D world counts beyond the 2-D one."""
    moe = {"grok-1-314b", "arctic-480b"}
    bad = 0
    for arch in [a for a in tconfigs.ARCHS if a not in moe]:
        for kind in ("train", "prefill", "decode"):
            mp = pytest.MonkeyPatch()
            flat = trace_world(arch, kind, "2d", mp)
            pod = trace_world(arch, kind, "3d", mp)
            a, b = flat["trace"], pod["trace"]
            same = (b.flops == a.flops, b.argument_bytes == a.argument_bytes,
                    sorted(b.collectives) == sorted(a.collectives),
                    b.peak_bytes == a.peak_bytes)
            bad += not all(same)
            print(f"{arch:22s} {kind:8s} flops/args/collectives/peak "
                  f"equal {same}; local bytes +{b.bytes - a.bytes:.0f}; "
                  f"beyond the 2-D world: "
                  f"{op_diff(flat['ops'], pod['ops'])}", flush=True)
    return bad


if __name__ == "__main__":
    raise SystemExit(main())
