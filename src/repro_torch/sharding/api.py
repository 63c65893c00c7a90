"""Logical-axis sharding: models annotate, rules bind axes to the mesh.

Models never mention physical mesh axes.  They call
``constrain(x, "batch", "seq", "embed")`` with *logical* axis names; a
:class:`ShardingRules` table (chosen per arch x shape by the launcher) maps
logical names to physical mesh axes, and ``use_mesh`` installs the binding
for a region of code.  Outside any binding the constraints are no-ops, so
the same model code runs on one device and on a mesh unchanged.

The mesh is a ``torch.distributed`` :class:`DeviceMesh`, and a binding
places DTensors: :func:`to_placements` turns a :class:`PartitionSpec` into
DTensor placements, and :func:`constrain` redistributes a DTensor to them.
A plain tensor passes through ``constrain`` unchanged, as it would outside
the binding.  :func:`axis_size`, :func:`filter_entry` and
:func:`filter_spec` read only a mesh's name-to-size mapping
(:func:`axis_sizes`), so a plain mapping stands in for a mesh too large to
start.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from collections.abc import Mapping

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

_state = threading.local()


# Default logical->physical table.  "dp" is the data-parallel super-axis
# (pod x data on the multi-pod mesh).
DEFAULT_RULES: dict[str, object] = {
    "batch": ("pod", "data"),      # activation batch
    "seq": None,                   # activation sequence (set to "model" for SP)
    "resid_seq": None,             # residual stream between blocks — bind to
                                   # "model" for Megatron-style sequence
                                   # parallelism (AG at block entry, RS at
                                   # exit; intra-block tensors keep TP)
    "cache_seq": None,             # KV-cache sequence (set to "model" for
                                   # sequence-sharded flash-decode)
    "embed": None,                 # d_model — replicated
    "heads": "model",              # attention heads (TP)
    "kv_heads": None,              # kv heads — replicated unless divisible
    "head_dim": None,
    "mlp": "model",                # FFN hidden (TP)
    "vocab": "model",              # embedding/logits vocab (TP)
    "experts": "model",            # MoE expert axis of *weights* (EP)
    "experts_act": "model",        # MoE expert axis of dispatched activations
    "expert_in": None,             # per-expert FFN input dim (FSDP-style
                                   # weight sharding for huge expert tables)
    "expert_mlp": None,            # per-expert FFN hidden (TP fallback for
                                   # E < mesh 'model' size)
    "lru": "model",                # RG-LRU width
    "rwkv_heads": "model",
    "stage": "stage",              # pipeline stage (pipeline/ only)
}


class PartitionSpec(tuple):
    """One entry per tensor dimension: ``None`` (not sharded), a mesh axis
    name, or a tuple of names (sharded over their product, the first the
    major).  A tuple, like ``jax.sharding.PartitionSpec``'s entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    table: dict

    def spec(self, *logical) -> PartitionSpec:
        phys = []
        for name in logical:
            if name is None:
                phys.append(None)
            else:
                phys.append(self.table.get(name))
        return P(*phys)

    def replace(self, **updates) -> "ShardingRules":
        t = dict(self.table)
        t.update(updates)
        return ShardingRules(t)


def default_rules(**updates) -> ShardingRules:
    return ShardingRules(dict(DEFAULT_RULES)).replace(**updates) \
        if updates else ShardingRules(dict(DEFAULT_RULES))


@contextlib.contextmanager
def _implicit_replication():
    """DTensor's implicit replication over this thread's outermost mesh
    binding: torch's ``implicit_replication()`` clears its flag on exit,
    so a nested binding leaves it to the outer one."""
    depth = getattr(_state, "implicit_depth", 0)
    _state.implicit_depth = depth + 1
    try:
        if depth:
            yield
        else:
            with implicit_replication():
                yield
    finally:
        _state.implicit_depth = depth


@contextlib.contextmanager
def use_mesh(mesh: DeviceMesh | None, rules: ShardingRules | None = None):
    """Bind ``mesh`` and ``rules`` for the enclosed code on this thread
    (``None`` unbinds); the previous binding comes back on exit.

    While a mesh is bound, a plain tensor that meets a DTensor in an
    operation counts as a ``Replicate()`` DTensor (DTensor's implicit
    replication): the models build their constants (positions, masks,
    rotary tables) as plain tensors, alike on every rank.  Torch keeps
    that switch per thread, as the binding is (2.11 and 2.13 alike); it
    stays on under a nested ``use_mesh(None)``.  Nothing runs on local
    shards."""
    prev = getattr(_state, "binding", None)
    _state.binding = (mesh, rules or default_rules()) if mesh is not None \
        else None
    try:
        with _implicit_replication() if mesh is not None else \
                contextlib.nullcontext():
            yield
    finally:
        _state.binding = prev


def current_binding():
    return getattr(_state, "binding", None)


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a :class:`DeviceMesh`, of an object with a
    ``shape`` mapping (a ``jax.sharding.Mesh``), or of a mapping."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(mesh.shape)


def axis_size(name: str) -> int:
    """Size of the physical axis a logical name maps to (1 if unbound)."""
    b = current_binding()
    if b is None:
        return 1
    mesh, rules = b
    sizes = axis_sizes(mesh)
    phys = rules.table.get(name)
    if phys is None:
        return 1
    if isinstance(phys, tuple):
        out = 1
        for a in phys:
            out *= sizes[a]
        return out
    return sizes[phys]


def filter_entry(dim: int, names, mesh, used: set | None = None) -> object:
    """Resolve one PartitionSpec entry against a mesh: drop axes the mesh
    doesn't have (e.g. 'pod' on the single-pod mesh), axes already used by
    an earlier dimension (first use wins), and the whole entry if the
    remaining axis product doesn't divide the dimension."""
    if names is None:
        return None
    sizes = axis_sizes(mesh)
    ns = tuple(n for n in (names if isinstance(names, tuple) else (names,))
               if n in sizes and (used is None or n not in used))
    if not ns:
        return None
    size = 1
    for n in ns:
        size *= sizes[n]
    if dim <= 0 or dim % size != 0:
        return None
    if used is not None:
        used.update(ns)
    return ns if len(ns) > 1 else ns[0]


def filter_spec(shape: tuple, spec: PartitionSpec, mesh) -> PartitionSpec:
    entries = tuple(spec) + (None,) * (len(shape) - len(spec))
    used: set = set()
    return P(*[filter_entry(d, n, mesh, used) for d, n in
               zip(shape, entries)])


def to_placements(spec: PartitionSpec, mesh: DeviceMesh) -> tuple:
    """DTensor placements of a filtered ``spec`` on ``mesh``: a tensor
    dimension ``d`` sharded over mesh axes ``a`` then ``b`` is ``Shard(d)``
    on both mesh dimensions (``a`` the major, as in JAX), every other mesh
    dimension ``Replicate()``.  The axes of one entry must come in the
    mesh's dimension order, the only order plain ``Shard`` expresses.  A
    mesh dimension of size 1 holds the whole tensor either way and stays
    ``Replicate()``, the placement every DTensor rule takes."""
    names = list(mesh.mesh_dim_names)
    sizes = axis_sizes(mesh)
    out: list = [Replicate()] * len(names)
    used: set = set()
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"to_placements: entry {entry} of {spec} is "
                             f"not in the mesh's order {tuple(names)}")
        for m in dims:
            if m in used:
                raise ValueError(f"to_placements: mesh axis {names[m]} "
                                 f"used twice in {spec}")
            used.add(m)
            if sizes[names[m]] > 1:
                out[m] = Shard(d)
    return tuple(out)


def constrain(x, *logical):
    """Place ``x`` as the active binding's rules say: a DTensor is
    redistributed to the placements of ``logical`` (filtered against the
    mesh, see :func:`filter_spec`).  ``x`` itself outside a binding, for a
    plain tensor, and where no axis is sharded (as the reference's
    ``with_sharding_constraint`` is skipped then)."""
    b = current_binding()
    if b is None or not isinstance(x, DTensor):
        return x
    mesh, rules = b
    spec = filter_spec(tuple(x.shape), rules.spec(*logical), mesh)
    if all(s is None for s in spec):
        return x
    placements = to_placements(spec, mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)


def _block(shape, mesh: DeviceMesh, placements, coord=None) -> tuple:
    """``(offset, size)`` per tensor dimension of the block of a tensor of
    global ``shape`` placed as ``placements`` on ``mesh`` that the rank at
    ``coord`` holds (this rank when None): the mesh dimensions split in
    order, each as ``torch.chunk`` does."""
    coord = mesh.get_coordinate() if coord is None else coord
    offset, size = [0] * len(shape), list(shape)
    for m, pl in enumerate(placements):
        if isinstance(pl, Shard):
            d = pl.dim
            step = -(-size[d] // mesh.size(m))
            o = min(coord[m] * step, size[d])
            offset[d] += o
            size[d] = max(min(step, size[d] - o), 0)
    return offset, size


def narrow_to(x, like):
    """``x`` placed as the DTensor ``like`` is, where that only shards
    further what ``x`` shards (``Replicate()`` to ``Shard(d)`` on some
    mesh dimensions): this rank's block of ``x``'s local tensor, a view,
    in one step.  ``x.redistribute`` splits one mesh dimension at a time
    and copies each piece, twice for a dimension over ``("pod", "data")``
    where the reference slices once.  ``x`` itself unless both are
    DTensors placed differently; no gradient flows through."""
    if not (isinstance(x, DTensor) and isinstance(like, DTensor)) \
            or x.placements == like.placements:
        return x
    placements = tuple(like.placements)
    for src, dst in zip(x.placements, placements):
        if src != dst and not (isinstance(src, Replicate)
                               and isinstance(dst, Shard)):
            raise ValueError(f"narrow_to: {tuple(x.placements)} to "
                             f"{placements} is not a further split")
    mesh = x.device_mesh
    local = x.to_local()
    start, _ = _block(x.shape, mesh, x.placements)
    offset, size = _block(x.shape, mesh, placements)
    for d, (o, o0, n) in enumerate(zip(offset, start, size)):
        if n != local.shape[d]:
            local = local.narrow(d, o - o0, n)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=x.shape, stride=x.stride())


def grad_as_value(x):
    """``x``, with its gradient placed as ``x`` is before it flows back
    into the operations that made ``x``.  DTensor otherwise lets a
    partial gradient reach a nonlinear backward and resolves it there as
    it chooses (torch 2.13 reduce-scatters it over the sequence, whose
    flattened tokens it then plans as a ``_StridedShard``).  ``x`` itself
    for a plain tensor or one that needs no gradient."""
    if isinstance(x, DTensor) and x.requires_grad:
        mesh, placements = x.device_mesh, x.placements
        x.register_hook(lambda g: g if g.placements == placements
                        else g.redistribute(mesh, placements))
    return x


def replicated(fn, batched: tuple = ()):
    """``fn`` run on whole tensors, for an operation DTensor has no rule
    for.  Under a binding, each DTensor argument is redistributed to
    ``Replicate()`` and ``fn`` gets its full value, with no mesh bound,
    except the arguments at the positions in ``batched``: their leading
    dimension is the batch, which keeps its shard over the mesh axes that
    ``batch`` binds to, so ``fn`` must treat batch rows independently.
    Its tensor outputs come back as DTensors on the mesh, placed as the
    batched arguments (``Replicate()`` where ``batched`` is empty).  An
    argument used whole beside a batch shard has a partial gradient on
    each rank, summed over the batch's axes (gradients flow through
    both).  Outside a binding, or with no DTensor argument, it is ``fn``
    itself."""
    def run(*args):
        b = current_binding()
        if b is None or not any(isinstance(a, DTensor) for a in args):
            return fn(*args)
        mesh, rules = b
        rep = (Replicate(),) * mesh.ndim
        placed = rep
        if batched:
            spec = filter_spec((args[batched[0]].shape[0],),
                               rules.spec("batch"), mesh)
            placed = to_placements(spec, mesh)
        grad = tuple(Partial() if isinstance(pl, Shard) else Replicate()
                     for pl in placed)
        local = []
        for i, a in enumerate(args):
            if not isinstance(a, DTensor):
                local.append(a)
            elif i in batched:
                local.append(a.redistribute(mesh, placed).to_local())
            else:
                local.append(a.redistribute(mesh, rep).to_local(
                    grad_placements=grad))
        with use_mesh(None):
            out = fn(*local)

        def wrap(t):
            return DTensor.from_local(t, mesh, placed, run_check=False) \
                if isinstance(t, torch.Tensor) else t
        return tuple(map(wrap, out)) if isinstance(out, tuple) else wrap(out)
    return run


def _axes(entry) -> tuple:
    """The mesh axes of one PartitionSpec entry."""
    return () if entry is None else (
        entry if isinstance(entry, tuple) else (entry,))


def _regroup(x, placements, grad_placements) -> torch.Tensor:
    """This rank's block of the DTensor ``x`` placed as ``placements``, a
    plain tensor, moved by one all-to-all over the mesh's ranks: each rank
    sends every other the part of its shard that the other's block holds
    (along a mesh dimension ``x`` is replicated on, only to the ranks of
    its own index there), so no rank holds more than its old and new
    blocks.  DTensor's redistribute instead gathers a dimension whole
    before it splits it anew (an expert table sharded over ``data`` to one
    sharded over ``model``).  The gradient flows back by the reverse
    all-to-all to ``x``'s shards, placed as ``grad_placements``."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed import get_process_group_ranks
    from torch.distributed._functional_collectives import \
        all_to_all_single_autograd
    mesh, src = x.device_mesh, tuple(x.placements)
    shape, dims = tuple(x.shape), tuple(mesh.shape)
    # the mesh's rank table is a real tensor, which a fake mode (the
    # dry-run's) would refuse to read
    with unset_fake_temporarily():
        ranks = mesh.mesh.numpy()
    coords = {int(ranks[c]): c for c in np.ndindex(*dims)}
    me = tuple(mesh.get_coordinate())
    rep = [m for m, pl in enumerate(src) if not isinstance(pl, Shard)]

    def overlap(a, b):
        lo = [max(p, q) for p, q in zip(a[0], b[0])]
        hi = [min(p + n, q + k) for p, n, q, k in zip(*a, *b)]
        return None if any(h <= o for o, h in zip(lo, hi)) else (lo, hi)

    local = x.to_local(grad_placements=grad_placements)
    mine, want = _block(shape, mesh, src), _block(shape, mesh, placements)
    group = (mesh._flatten() if mesh.ndim > 1 else mesh).get_group()
    sends, ins, outs, boxes = [], [], [], []
    for r in get_process_group_ranks(group):
        c = coords[r]
        peer = all(c[m] == me[m] for m in rep)
        box = overlap(mine, _block(shape, mesh, placements, c)) \
            if peer else None
        if box is not None:
            piece = local
            for d, (lo, hi) in enumerate(zip(*box)):
                piece = piece.narrow(d, lo - mine[0][d], hi - lo)
            sends.append(piece.reshape(-1))
        ins.append(0 if box is None else sends[-1].numel())
        box = overlap(_block(shape, mesh, src, c), want) if peer else None
        boxes.append(box)
        outs.append(0 if box is None else
                    math.prod(h - lo for lo, h in zip(*box)))
    buf = torch.cat(sends) if sends else local.new_empty(0)
    got = all_to_all_single_autograd(buf, outs, ins, group)
    out = local.new_empty(want[1])
    for piece, box in zip(torch.split(got, outs), boxes):
        if box is not None:
            out[tuple(slice(lo - o, h - o) for lo, h, o in
                      zip(*box, want[0]))] = piece.reshape(
                [h - lo for lo, h in zip(*box)])
    return out


def local_block(fn, in_axes: tuple, out_axes: tuple, *,
                partial: tuple = (), reduce_op: str = "sum",
                offsets: bool = False):
    """``fn`` run on each rank's block, as ``shard_map`` runs it.  Under a
    binding, each tensor argument is placed at the placements of its
    logical axes in ``in_axes`` (one tuple an argument, None to pass it as
    it is), filtered as :func:`constrain` filters them (first use wins; an
    axis that does not divide is dropped), and ``fn`` gets the local
    tensors, with no mesh bound; a plain tensor counts as replicated.
    Its output is a DTensor whose dimensions are sharded over the mesh
    axes that the logical names in ``out_axes`` resolved to in the
    arguments, and ``Partial(reduce_op)`` over those that the names in
    ``partial`` resolved to (``fn`` sums over them, or takes their max
    with ``reduce_op="max"``).  An argument replicated along a
    mesh dimension that some argument is sharded on gets a partial
    gradient there.  With ``offsets``, ``fn`` also gets ``offsets=``, each
    argument's block's global offset per dimension (None for a
    non-tensor).  Outside a binding, or with no DTensor argument, it is
    ``fn`` itself, its offsets 0.

    An argument is moved by DTensor's redistribute where that only
    gathers, only splits or reduces, else by one all-to-all
    (:func:`_regroup`)."""
    def run(*args):
        b = current_binding()
        if b is None or not any(isinstance(a, DTensor) for a in args):
            if offsets:
                return fn(*args, offsets=tuple(
                    (0,) * a.ndim if isinstance(a, torch.Tensor) else None
                    for a in args))
            return fn(*args)
        mesh, rules = b
        resolved: dict = {}
        targets = []
        for a, axes in zip(args, in_axes):
            if axes is None or not isinstance(a, torch.Tensor):
                targets.append(None)
                continue
            spec = filter_spec(tuple(a.shape), rules.spec(*axes), mesh)
            for name, entry in zip(axes, spec):
                if name is not None and entry is not None:
                    resolved.setdefault(name, entry)
            targets.append(to_placements(spec, mesh))
        varies = {m for pl in targets if pl is not None
                  for m, p in enumerate(pl) if isinstance(p, Shard)}
        local, offs = [], []
        for a, pl in zip(args, targets):
            if pl is None:
                local.append(a)
                offs.append(None)
                continue
            start, size = _block(a.shape, mesh, pl)
            offs.append(tuple(start))
            if not isinstance(a, DTensor):
                for d, (o, n) in enumerate(zip(start, size)):
                    if n != a.shape[d]:
                        a = a.narrow(d, o, n)
                local.append(a)
                continue
            src = tuple(a.placements)
            grad = tuple(Partial() if isinstance(p, Replicate)
                         and m in varies else p for m, p in enumerate(pl))
            if src == pl:
                local.append(a.to_local(grad_placements=grad))
            elif any(isinstance(s, Partial) for s in src) or all(
                    s == t or isinstance(t, Replicate)
                    for s, t in zip(src, pl)) or all(
                    s == t or isinstance(s, Replicate)
                    for s, t in zip(src, pl)):
                local.append(a.redistribute(mesh, pl).to_local(
                    grad_placements=grad))
            else:
                local.append(_regroup(a, pl, tuple(
                    Partial() if isinstance(p, Replicate) and m in varies
                    else p for m, p in enumerate(src))))
        with use_mesh(None):
            out = fn(*local, offsets=tuple(offs)) if offsets \
                else fn(*local)
        used: set = set()
        entries = []
        for name in out_axes:
            axes = _axes(resolved.get(name))
            entries.append(None if not axes or used & set(axes)
                           else resolved[name])
            used.update(_axes(entries[-1]))
        placements = list(to_placements(P(*entries), mesh))
        names = list(mesh.mesh_dim_names)
        for name in partial:
            for axis in _axes(resolved.get(name)):
                m = names.index(axis)
                if axis not in used and mesh.size(m) > 1:
                    placements[m] = Partial(reduce_op)
        return DTensor.from_local(out, mesh, placements, run_check=False)
    return run


def named_sharding(*logical) -> tuple:
    """``(mesh, placements)`` of the active binding for ``logical``; axes
    the mesh lacks are dropped (no shape is known to filter by)."""
    b = current_binding()
    if b is None:
        raise RuntimeError("named_sharding requires an active use_mesh "
                           "binding")
    mesh, rules = b
    sizes = axis_sizes(mesh)
    spec = []
    for entry in rules.spec(*logical):
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        kept = tuple(a for a in axes if a in sizes)
        spec.append(None if not kept else kept if len(kept) > 1
                    else kept[0])
    return mesh, to_placements(P(*spec), mesh)
