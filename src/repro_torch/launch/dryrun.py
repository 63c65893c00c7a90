"""Multi-pod dry-run: trace every (arch × shape × mesh) cell on fake ranks.

For each cell a fake world of 256 (``single``, 16x16) or 512 (``multi``,
2x16x16) ranks is started in this process (:func:`launch.mesh.fake_world`),
the parameters, optimizer moments and inputs are made as fake DTensors
(each rank's shard as a fake tensor: shapes, no storage) placed by the
cell's rules, and the step runs once, eagerly, under the mesh binding,
inside :class:`launch.cost.CostMode`, which counts each local operation's
FLOPs and bytes, the collectives and the live memory.  That trace stands
in for the reference's compiled artifact (``memory_analysis`` /
``cost_analysis`` / the HLO's collectives); :mod:`launch.roofline` turns
it into seconds on the H100's data-sheet rates.

  train_4k      -> train_step (fwd+bwd+AdamW update)
  prefill_32k   -> prefill (full forward, last-token logits)
  decode_32k/long_500k -> serve_step (one token against the KV/recurrent
                   state at seq_len)

The fake ranks model tensors on ``--device`` (CUDA, the port's default;
``cpu`` where there is no card).  Nothing is compiled, and
``scan_layers`` changes nothing (the port runs one loop either way).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b \\
      --shape train_4k --device cpu
"""
import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import traceback

import torch
from torch.distributed.tensor import DTensor, Shard

from repro_torch import configs
from repro_torch import device as device_lib
from repro_torch.launch import cost as cost_lib
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import roofline as roofline_lib
from repro_torch.launch import specs as specs_lib
from repro_torch.launch.rules import rules_for
from repro_torch.models import decode_step, init_lm
from repro_torch.models.common import ModelConfig
from repro_torch.optim import adamw
from repro_torch.serve.engine import make_prefill_step
from repro_torch.sharding import api as shapi
from repro_torch.sharding import params as shparams
from repro_torch.train.step import make_train_step


@dataclasses.dataclass
class CellResult:
    arch: str
    shape: str
    mesh: str
    ok: bool
    seconds: float
    error: str = ""
    memory: dict | None = None
    roofline: dict | None = None


# the archs whose single-mesh cells ``main`` extrapolates from one and two
# pattern groups (``--method auto``), as the reference does
EXTRAPOLATED = {"qwen3-32b", "grok-1-314b", "arctic-480b"}


def _mesh(name: str, device=None):
    return mesh_lib.make_production_mesh(multi_pod=(name == "multi"),
                                         device=device)


def _param_structs(cfg: ModelConfig):
    """The parameter tree's shapes and dtypes (fake tensors)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        return init_lm(torch.Generator("cpu"), cfg, device="cpu")


def _opt_structs(p_struct):
    def f32(tree):
        return _map(lambda s: torch.empty(s.shape, dtype=torch.float32,
                                          device="meta"), tree)
    return {"mu": f32(p_struct), "nu": f32(p_struct),
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def _map(fn, tree, *rest):
    """``fn`` over the tensor leaves of nested dicts and lists, with the
    leaves of matching trees ``rest`` (a ``PartitionSpec`` is a leaf)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def zero1(spec_tree, p_struct, mesh, rules):
    """ZeRO-1: additionally shard optimizer moments over the DP axes on the
    first free, divisible dimension."""
    sizes = shapi.axis_sizes(mesh)
    dp = rules.table.get("batch")
    axes = dp if isinstance(dp, tuple) else (dp,)
    axes = tuple(a for a in axes if a in sizes)

    def one(struct, spec):
        parts = list(spec) + [None] * (len(struct.shape) - len(spec))
        used = set()
        for p in parts:
            if p is not None:
                used.update(p if isinstance(p, tuple) else (p,))
        free = tuple(a for a in axes if a not in used)
        if free:
            size = 1
            for a in free:
                size *= sizes[a]
            for i, (dim, cur) in enumerate(zip(struct.shape, parts)):
                if cur is None and dim % size == 0 and dim >= size:
                    parts[i] = free if len(free) > 1 else free[0]
                    break
        return shapi.P(*parts)

    return _map(one, p_struct, spec_tree)


def _shard(struct, spec, mesh, device):
    """A fake DTensor of ``struct``'s global shape and dtype on ``mesh``,
    placed by ``spec``: this rank's shard, made in the active fake mode."""
    placements = shapi.to_placements(spec, mesh)
    local = list(struct.shape)
    for size, pl in zip(mesh.shape, placements):
        if isinstance(pl, Shard):
            local[pl.dim] //= size
    return DTensor.from_local(
        torch.empty(local, dtype=struct.dtype, device=device), mesh,
        placements, run_check=False)


def _trace(cfg, shape, mesh, rules, device, *, scan_layers, zero1_opt,
           local_impl):
    """Run the cell's step once on fake DTensors inside a
    :class:`~repro_torch.launch.cost.CostMode`; returns its trace and the
    cell's model FLOPs."""
    p_struct = _param_structs(cfg)
    p_specs = shparams.physical_specs(p_struct, mesh, rules)
    if shape.kind == "decode":
        inputs = specs_lib.decode_state_specs(cfg, shape)
        shardings = specs_lib.decode_shardings(cfg, shape, mesh, rules)
    else:
        inputs = specs_lib.train_like_specs(cfg, shape)
        shardings = specs_lib.train_like_shardings(cfg, inputs, mesh, rules)
    mode = cost_lib.CostMode()
    with mode, shapi.use_mesh(mesh, rules):
        def place(structs, specs):
            return _map(lambda s, sp: _shard(s, sp, mesh, device), structs,
                        specs)
        params = place(p_struct, p_specs)
        if shape.kind == "train":
            o_specs = zero1(p_specs, p_struct, mesh, rules) if zero1_opt \
                else p_specs
            o_struct = _opt_structs(p_struct)
            opt = {"mu": place(o_struct["mu"], o_specs),
                   "nu": place(o_struct["nu"], o_specs),
                   "step": _shard(o_struct["step"], shapi.P(), mesh, device)}
            batch = place(inputs, shardings)
            step = make_train_step(cfg, adamw.AdamWConfig(),
                                   scan_layers=scan_layers,
                                   local_impl=local_impl)
            mode.begin((params, opt, batch))
            out = step(params, opt, batch, None)[:3]
            model_flops = roofline_lib.model_flops_train(
                cfg, shape.global_batch * shape.seq_len)  # 6ND: fwd+bwd
        elif shape.kind == "prefill":
            batch = place(inputs, shardings)
            prefill = make_prefill_step(cfg, scan_layers=scan_layers,
                                        local_impl=local_impl)
            mode.begin((params, batch))
            with torch.no_grad():
                out = prefill(params, batch)
            model_flops = roofline_lib.model_flops_prefill(
                cfg, shape.global_batch * shape.seq_len)
        else:  # decode
            tok, pos, state, memory = inputs
            tok_sh, pos_sh, st_sh, mem_sh = shardings
            tok, pos = place(tok, tok_sh), place(pos, pos_sh)
            state = place(state, st_sh)
            if memory is not None:
                memory = tuple(place(list(memory), list(mem_sh)))
            mode.begin((params, tok, pos, state, memory))
            with torch.no_grad():
                logits, new_state = decode_step(params, tok, pos, state,
                                                cfg, memory=memory)
                # aten.argmax over vocab-sharded logits: DTensor turns the
                # local indices into global ones with a tensor of the
                # rank's offset, which a fake tensor cannot read; the
                # vocab dimension is gathered first
                whole = shapi.to_placements(shapi.filter_spec(
                    tuple(logits.shape), rules.spec("batch", None), mesh),
                    mesh)
                logits = logits.redistribute(mesh, whole)
                out = (torch.argmax(logits, -1).to(torch.int32), new_state)
            model_flops = roofline_lib.model_flops_decode(
                cfg, shape.global_batch)
        trace = mode.end(out)
    return trace, model_flops


def lower_cell(arch: str, shape_name: str, mesh_name: str, *,
               scan_layers: bool = False, zero1_opt: bool = True,
               extra_rules: dict | None = None, local_impl: str = "mask",
               opt_level: int = 0, attn_qchunk: int = 0, remat: bool = True,
               return_artifacts: bool = False, cfg: ModelConfig | None = None,
               shape: configs.ShapeSpec | None = None, mesh=None,
               device=None):
    """Trace one cell; returns ``(memory, roofline)``, the reference's
    ``memory_analysis`` fields and :class:`~launch.roofline.Roofline`.

    ``mesh`` (a ``DeviceMesh`` over an initialised world) replaces the
    production mesh, which otherwise comes with a fake world of its own;
    ``shape`` replaces ``configs.SHAPES[shape_name]``; ``device`` is the
    device the fake ranks' tensors model (the port's default when
    None)."""
    cfg = cfg if cfg is not None else configs.get_config(arch)
    if opt_level or attn_qchunk or not remat:
        cfg = dataclasses.replace(cfg, opt_level=opt_level,
                                  attn_qchunk=attn_qchunk, remat=remat)
    shape = shape if shape is not None else configs.SHAPES[shape_name]
    rules = rules_for(arch, shape.kind, extra_rules)
    dev = device_lib.resolve(device)
    with contextlib.ExitStack() as stack:
        if mesh is None:
            stack.enter_context(mesh_lib.fake_world(
                512 if mesh_name == "multi" else 256))
            mesh = _mesh(mesh_name, dev)
        n_chips = mesh.size()
        trace, model_flops = _trace(cfg, shape, mesh, rules, dev,
                                    scan_layers=scan_layers,
                                    zero1_opt=zero1_opt,
                                    local_impl=local_impl)
    memory = roofline_lib.memory_dict(trace)
    rf = roofline_lib.analyze(trace, arch=arch, shape=shape_name,
                              mesh_name=mesh_name, n_chips=n_chips,
                              model_flops=model_flops)
    if return_artifacts:
        return trace, memory, rf
    return memory, rf


def lower_cell_extrapolated(arch: str, shape_name: str, mesh_name: str,
                            **kw):
    """Two-point unrolled extrapolation for very deep configs.

    Trace the full-width model at 1 and 2 pattern-groups, take the
    per-group delta of every roofline term, and extrapolate linearly to
    the full depth:  X(G) = X(1) + (G-1)·(X(2)-X(1)).  Exact for
    parameter/optimizer terms and per-layer collectives (both are
    strictly linear in depth); activations/temp extrapolate linearly in
    the saved-residual component with the constant per-group working set
    captured in the base point.
    """
    cfg_full = configs.get_config(arch)
    gs = cfg_full.group_size
    g_full = cfg_full.num_layers / gs
    pts = []
    for g in (1, 2):
        cfg_g = dataclasses.replace(cfg_full, num_layers=g * gs)
        mem, rf = lower_cell(arch, shape_name, mesh_name, cfg=cfg_g, **kw)
        pts.append((mem, rf))
    (m1, r1), (m2, r2) = pts
    lerp = lambda a, b: a + (g_full - 1) * (b - a)  # noqa: E731
    memory = {k: lerp(m1[k], m2[k]) for k in m1}
    coll = {k: lerp(r1.coll_breakdown.get(k, 0.0),
                    r2.coll_breakdown.get(k, 0.0))
            for k in set(r1.coll_breakdown) | set(r2.coll_breakdown)}
    shape = configs.SHAPES[shape_name]
    if shape.kind == "train":
        model_flops = roofline_lib.model_flops_train(
            cfg_full, shape.global_batch * shape.seq_len)
    elif shape.kind == "prefill":
        model_flops = roofline_lib.model_flops_prefill(
            cfg_full, shape.global_batch * shape.seq_len)
    else:
        model_flops = roofline_lib.model_flops_decode(cfg_full,
                                                      shape.global_batch)
    rf = roofline_lib.Roofline(
        arch=arch, shape=shape_name, mesh=mesh_name + "*",
        flops_per_chip=lerp(r1.flops_per_chip, r2.flops_per_chip),
        bytes_per_chip=lerp(r1.bytes_per_chip, r2.bytes_per_chip),
        coll_bytes_per_chip=coll.get("total", 0.0),
        coll_breakdown=coll,
        t_compute=lerp(r1.t_compute, r2.t_compute),
        t_memory=lerp(r1.t_memory, r2.t_memory),
        t_collective=lerp(r1.t_collective, r2.t_collective),
        model_flops=model_flops,
        peak_mem_bytes=lerp(r1.peak_mem_bytes, r2.peak_mem_bytes),
        n_chips=r1.n_chips,
    )
    return memory, rf


def run_cell(arch: str, shape_name: str, mesh_name: str,
             method: str = "direct", **kw) -> CellResult:
    t0 = time.time()
    try:
        if method == "extrapolate":
            memory, rf = lower_cell_extrapolated(arch, shape_name, mesh_name,
                                                 **kw)
        else:
            memory, rf = lower_cell(arch, shape_name, mesh_name, **kw)
        return CellResult(arch, shape_name, mesh_name, True,
                          time.time() - t0, memory=memory,
                          roofline=rf.to_dict())
    except Exception as e:  # noqa: BLE001 — report, don't crash the sweep
        return CellResult(arch, shape_name, mesh_name, False,
                          time.time() - t0,
                          error=f"{type(e).__name__}: {e}\n"
                          + traceback.format_exc(limit=8))


def parse_rules(text: str) -> dict:
    """``logical=phys`` overrides, comma separated; ``a+b`` a tuple of
    axes, ``None`` unbound."""
    extra = {}
    for kv in text.split(","):
        if not kv:
            continue
        k, v = kv.split("=")
        extra[k] = None if v in ("None", "none", "") else (
            tuple(v.split("+")) if "+" in v else v)
    return extra


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi",
                                                         "both"])
    ap.add_argument("--scan-layers", action="store_true")
    ap.add_argument("--local-impl", default="mask",
                    choices=["mask", "chunked"])
    ap.add_argument("--rules", default="",
                    help="logical=phys overrides, comma separated "
                         "(e.g. seq=model,cache_seq=None)")
    ap.add_argument("--opt-level", type=int, default=0)
    ap.add_argument("--attn-qchunk", type=int, default=0)
    ap.add_argument("--method", default="auto",
                    choices=["auto", "direct", "extrapolate"],
                    help="auto: direct trace for small archs, two-point "
                         "extrapolation for very deep ones; multi-pod "
                         "always traces the full depth as the "
                         "shardability proof")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--device", default=None,
                    help="the device the fake ranks model (default: the "
                         "port's, CUDA)")
    args = ap.parse_args(argv)

    extra = parse_rules(args.rules)
    archs = [args.arch] if args.arch else configs.ARCHS
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    os.makedirs(args.out, exist_ok=True)

    results = []
    for arch in archs:
        shapes = [args.shape] if args.shape else configs.applicable_shapes(
            arch)
        for shape in shapes:
            for mesh_name in meshes:
                if args.method == "auto":
                    if mesh_name == "multi":
                        method, scan = "direct", True
                    elif arch in EXTRAPOLATED:
                        method, scan = "extrapolate", False
                    else:
                        method, scan = "direct", False
                else:
                    method, scan = args.method, args.scan_layers
                r = run_cell(arch, shape, mesh_name, method=method,
                             scan_layers=scan, opt_level=args.opt_level,
                             attn_qchunk=args.attn_qchunk,
                             extra_rules=extra, local_impl=args.local_impl,
                             device=args.device)
                results.append(r)
                status = "OK " if r.ok else "FAIL"
                mem = (f"{r.memory['per_chip_total'] / 2**30:.2f} GiB/chip"
                       if r.memory else "-")
                print(f"[{status}] {arch:22s} {shape:12s} {mesh_name:6s} "
                      f"{r.seconds:7.1f}s  {mem}", flush=True)
                if not r.ok:
                    print(r.error, file=sys.stderr, flush=True)
                tag = f"{arch}_{shape}_{mesh_name}"
                with open(os.path.join(args.out, tag + ".json"), "w") as f:
                    json.dump(dataclasses.asdict(r), f, indent=2)
    nfail = sum(not r.ok for r in results)
    print(f"\n{len(results) - nfail}/{len(results)} cells traced")
    rows = [roofline_lib.Roofline(**{k: v for k, v in r.roofline.items()
                                     if k in {f.name for f in
                                              dataclasses.fields(
                                                  roofline_lib.Roofline)}})
            for r in results if r.ok]
    print(roofline_lib.render_table(rows))
    return 1 if nfail else 0


if __name__ == "__main__":
    sys.exit(main())
