"""The dry-run's cost tracer: what one eager step does on each chip.

The JAX package compiles each cell and reads XLA's
``compiled.cost_analysis()`` (FLOPs, bytes accessed),
``compiled.memory_analysis()`` (argument, output and temporary bytes)
and the collectives of the optimised HLO.  The port has no compiled
program to ask, so it runs the step once, eagerly, on fake tensors: a
:class:`CostMode` is a ``FakeTensorMode`` (shapes, dtypes and devices,
no storage and no arithmetic) that also counts each *local* operation,
the one a rank would run on its shard after DTensor has propagated the
placements and issued the collectives.  What it counts:

* **flops**: the FLOPs of each local operation by
  ``torch.utils.flop_counter``'s formulas (products, convolutions,
  attention; elementwise operations count 0, as there).  Local shapes
  make them per-chip FLOPs.  Operations inside
  ``sharding.api.replicated(...)`` run on whole local tensors and count
  as they are.
* **bytes**: each local operation's tensor operands and results, every
  time, with no fusion: what the eager program reads and writes.  Views
  move nothing and count nothing.  An indexed operation (a gather, a
  scatter, an embedding lookup) counts its indices and twice the rows it
  moves, not the whole table it indexes.
* **collectives**: each functional collective DTensor issues, as
  ``(op, result bytes, group size)`` with the reference's HLO op names
  (``all-gather``, ``reduce-scatter``, ``all-reduce``, ``all-to-all``).
* **memory**: the bytes of the storages alive, counted from the step's
  arguments (the local shards of the parameters, optimizer state, batch
  or decode state), each new storage added when an operation makes it
  and taken away when it is freed, and the peak of that sum.  Outputs
  are the step's results that do not share an argument's storage (the
  port updates parameters, moments and caches in place).  There is no
  generated code, so its size is 0.

DTensor's own sharding propagation runs each operation once more on
fake tensors of the global shapes, to learn the output's shape; those
calls are not the step's and are not counted, nor is the index
arithmetic of its placements, which runs on real host tensors.
Counting starts at
:meth:`CostMode.begin` and stops at :meth:`CostMode.end`; tensors made
before it (the arguments) are fake all the same.
"""
from __future__ import annotations

import dataclasses
import sys
import threading
import weakref

import torch
from torch._subclasses.fake_tensor import (FakeTensorMode,
                                           unset_fake_temporarily)
from torch.utils._pytree import tree_flatten, tree_leaves
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten

# the functional collectives DTensor issues, by op name: the reference's
# HLO op, and the position of the group-size argument (None: read the
# group from its name, the last positional argument)
_COLLECTIVES = {
    "all_gather_into_tensor": ("all-gather", 1),
    "reduce_scatter_tensor": ("reduce-scatter", 2),
    "all_reduce": ("all-reduce", None),
    "all_to_all_single": ("all-to-all", None),
    "shard_dim_alltoall": ("all-to-all", None),
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd",
                          "_dtensor")

# operations that move no data (views by another name, allocations)
_NO_BYTES = {aten._unsafe_view.default, aten.detach.default,
             aten.alias.default, aten.lift_fresh.default,
             aten.empty.memory_format, aten.empty_strided.default,
             aten.empty_like.default}

# indexed operations: the position of their index argument(s), and that
# of the rows they move (None: their result)
_INDEXED = {
    aten.index.Tensor: (1, None),
    aten.gather.default: (2, None),
    aten.embedding.default: (1, None),
    aten.index_select.default: (2, None),
    aten.index_put_.default: (1, 2),
    aten.index_put.default: (1, 2),
    aten._index_put_impl_.default: (1, 2),
    aten.scatter.src: (2, 3),
    aten.scatter_.src: (2, 3),
    aten.scatter_add.default: (2, 3),
    aten.scatter_add_.default: (2, 3),
}


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _indexed_bytes(func, args, out) -> int:
    """Indices plus twice the moved rows: read and written once each."""
    index, rows = _INDEXED[func]
    moved = _tensors(out) if rows is None else [args[rows]]
    return sum(map(_nbytes, _tensors(args[index]))) \
        + 2 * sum(map(_nbytes, moved))


def _group_size(name: str) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name).size()


# DTensor's own work on tensors, by (function name prefix, file name
# suffix): its sharding propagation, which runs an operation on fake
# tensors of the global shapes to learn its output's metadata, or, for
# an operation with no rule of its own, its decomposition on meta tensors
# to learn its strategy (torch 2.13); none of it is the step's
_PROPAGATION = (("_propagate_tensor_meta", ""),
                ("propagate_strategy", "_decompositions.py"))
# its index arithmetic for a _StridedShard (torch 2.13), which splits a
# host tensor of indices and reads them back: a fake tensor has no values
_SHARD_ARITHMETIC = (("local_shard_size_and_offset", "placement_types.py"),)


def _within(frames: tuple, depth: int) -> bool:
    """True if one of the ``depth`` frames above the dispatch runs one of
    ``frames``."""
    f = sys._getframe(2)
    for _ in range(depth):
        if f is None:
            return False
        code = f.f_code
        if any(code.co_name.startswith(name)
               and code.co_filename.endswith(file) for name, file in frames):
            return True
        f = f.f_back
    return False


@dataclasses.dataclass
class CostTrace:
    """One step's counts on one chip."""
    flops: float = 0.0
    bytes: float = 0.0
    collectives: list = dataclasses.field(default_factory=list)
    ops: int = 0
    argument_bytes: int = 0
    output_bytes: int = 0
    peak_bytes: int = 0

    @property
    def temp_bytes(self) -> int:
        return self.peak_bytes - self.argument_bytes


class CostMode(FakeTensorMode):
    """A ``FakeTensorMode`` that counts, between :meth:`begin` and
    :meth:`end`, each local operation's FLOPs and bytes, each collective,
    and the bytes of live storages (see the module docstring)."""

    def __init__(self):
        super().__init__(allow_non_fake_inputs=False)
        self.trace = CostTrace()
        self._counting = False
        self._local = threading.local()
        # reentrant: a storage's finalizer runs at whatever allocation
        # collects it, which may come while ``_track`` holds the lock
        self._lock = threading.RLock()
        self._live = weakref.WeakKeyDictionary()   # storage -> bytes
        self._alias = weakref.WeakKeyDictionary()  # storage -> its source
        self._arg_storages: set = set()            # ids of the arguments'
        self._live_bytes = 0

    # -- storages -----------------------------------------------------
    def _freed(self, nbytes: int) -> None:
        with self._lock:
            self._live_bytes -= nbytes

    def _track(self, tensors) -> None:
        for t in tensors:
            st = t.untyped_storage()
            if st in self._live or st in self._alias:
                continue
            n = st.nbytes()
            self._live[st] = n
            weakref.finalize(st, self._freed, n)
            with self._lock:
                self._live_bytes += n
                if self._live_bytes > self.trace.peak_bytes:
                    self.trace.peak_bytes = self._live_bytes

    @staticmethod
    def _local_tensors(tree) -> list:
        """The local tensors of ``tree``'s leaves, DTensors unwrapped."""
        from torch.distributed.tensor import DTensor
        out = []
        for t in tree_flatten(tree)[0]:
            if isinstance(t, DTensor):
                t = t._local_tensor
            if isinstance(t, torch.Tensor):
                out.append(t)
        return out

    def begin(self, arguments) -> None:
        """Count from here; ``arguments`` (a tree) are the step's inputs,
        alive throughout."""
        local = self._local_tensors(arguments)
        storages = {id(t.untyped_storage()): t.untyped_storage()
                    for t in local}
        self.trace.argument_bytes = sum(st.nbytes()
                                        for st in storages.values())
        self._arg_storages = set(storages)
        self._track(local)
        self.trace.peak_bytes = self._live_bytes
        self._counting = True

    def end(self, outputs) -> CostTrace:
        """Stop counting; ``outputs`` (a tree) are the step's results."""
        self._counting = False
        fresh = {}
        for t in self._local_tensors(outputs):
            st = t.untyped_storage()
            if id(st) not in self._arg_storages:
                fresh.setdefault(id(st), st.nbytes())
        self.trace.output_bytes = sum(fresh.values())
        return self.trace

    # -- dispatch -----------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _within(_SHARD_ARITHMETIC, 16):
            with unset_fake_temporarily():
                return func(*args, **kwargs)
        depth = getattr(self._local, "depth", 0)
        self._local.depth = depth + 1
        try:
            out = super().__torch_dispatch__(func, types, args, kwargs)
        finally:
            self._local.depth = depth
        if (self._counting and depth == 0 and out is not NotImplemented
                and not _within(_PROPAGATION, 64)):
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        outs = _tensors(out)
        ns = func.namespace
        if ns in _COLLECTIVE_NAMESPACES:
            name = func._schema.name.split("::")[-1]
            if name in _COLLECTIVES:
                op, pos = _COLLECTIVES[name]
                group = int(args[pos]) if pos is not None else \
                    _group_size(args[-1])
                self.trace.collectives.append(
                    (op, sum(map(_nbytes, outs)), group))
                self._track(outs)
            elif name == "wait_tensor":
                # it returns its input; a fake one is a new tensor, which
                # keeps the input's storage alive instead of adding its own
                self._alias[outs[0].untyped_storage()] = \
                    args[0].untyped_storage()
            return
        if ns == "prim" or not outs:
            return
        self.trace.ops += 1
        self._track(outs)
        packet = func._overloadpacket
        if packet in flop_registry:
            self.trace.flops += flop_registry[packet](*args, **kwargs,
                                                      out_val=out)
        if func in _NO_BYTES or _is_view(func):
            return
        if func in _INDEXED:
            self.trace.bytes += _indexed_bytes(func, args, out)
        else:
            self.trace.bytes += sum(map(_nbytes, _tensors((args, kwargs)))) \
                + sum(map(_nbytes, outs))
