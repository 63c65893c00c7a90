"""Device meshes over ``torch.distributed``, and the ranks behind them.

The JAX package builds a ``jax.sharding.Mesh`` over the devices of one
process.  Here a mesh is a ``torch.distributed`` :class:`DeviceMesh` over
the ranks of an initialised world, one process a rank, with a process
group per mesh dimension where the reference has an axis name.
:func:`run_ranks` starts such a world: it is the counterpart of
``--xla_force_host_platform_device_count`` for tests, examples and
``chip_smoke.py``.

``make_production_mesh`` gives the dry-run's 16x16 and 2x16x16 meshes
over a world of 256 or 512 ranks; :func:`fake_world` starts such a world
in one process, whose collectives move nothing (the counterpart of the
reference's ``--xla_force_host_platform_device_count=512``).
"""
from __future__ import annotations

import faulthandler
import math
import multiprocessing
import os
import pickle
import queue
import tempfile
import traceback
from contextlib import contextmanager

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch import device as device_lib


def make_mesh(shape, axes, *, device=None) -> DeviceMesh:
    """A :class:`DeviceMesh` of ``shape`` with dimension names ``axes``
    over the initialised world, whose ranks hold tensors on ``device``
    (the port's default device, CUDA, when None)."""
    dev = device_lib.resolve(device)
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"make_mesh: shape {shape} and axes {axes} differ "
                         f"in length")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group is initialised "
                           "(start the ranks with run_ranks)")
    if math.prod(shape) != dist.get_world_size():
        raise ValueError(f"make_mesh: shape {shape} needs "
                         f"{math.prod(shape)} ranks, the world has "
                         f"{dist.get_world_size()}")
    mesh = init_device_mesh(dev.type, shape, mesh_dim_names=axes)
    # a group for every run of adjacent dimensions, so that DTensor
    # reduces a Partial, or gathers a Shard, over several dimensions in
    # one collective, as GSPMD does over the replica groups of an axis
    # product, where it would otherwise issue one per dimension
    for i in range(len(axes)):
        for j in range(i + 2, len(axes) + 1):
            mesh[axes[i:j]]._flatten()
    return mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device=None) -> DeviceMesh:
    """The production mesh, (16, 16) ``("data", "model")`` or, with
    ``multi_pod``, (2, 16, 16) ``("pod", "data", "model")``, over the
    initialised world (256 or 512 ranks; see :func:`fake_world`)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


@contextmanager
def fake_world(n: int):
    """A world of ``n`` ranks in this process, as rank 0, over
    ``torch.distributed``'s fake backend: every collective returns at
    once and moves nothing, so a program's placements, shapes and
    collectives can be traced on fake tensors without the ranks.  The
    world ends on exit."""
    # the fake backend registers itself when its module is imported
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already "
                           "initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_host_mesh(model: int = 1, data: int | None = None,
                   stage: int | None = None, *, device=None) -> DeviceMesh:
    """Small mesh over the world's ranks (tests/examples): ``("stage",)``
    when ``stage`` is given, else ``("data", "model")`` with ``data``
    defaulting to the ranks ``model`` leaves."""
    n = dist.get_world_size()
    if stage is not None:
        return make_mesh((stage,), ("stage",), device=device)
    data = data if data is not None else n // model
    return make_mesh((data, model), ("data", "model"), device=device)


def _rank_main(fn, rank, world_size, backend, store, args, results):
    """One rank: join the world through the file store, run
    ``fn(*args)``, post ``(rank, ok, result or traceback)``.  A failure is
    posted before the rank leaves the world, so it reaches the parent
    ahead of the errors it causes on the other ranks."""
    faulthandler.enable()       # a rank that dies natively prints its stack
    try:
        if backend == "nccl":
            torch.cuda.set_device(0 if torch.cuda.device_count() == 1
                                  else rank)
        dist.init_process_group(backend, init_method=f"file://{store}",
                                rank=rank, world_size=world_size)
        # pickled here: a tensor put on the queue as it is would travel as
        # a file descriptor that dies with this process
        results.put((rank, True, pickle.dumps(fn(*args))))
    except BaseException:       # noqa: BLE001 -- posted to the parent
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world_size: int, *, backend: str, args: tuple = (),
              timeout: float = 600.0) -> list:
    """Run ``fn(*args)`` on ``world_size`` ranks, each a process started
    with ``spawn``, in a world of the named ``backend`` (``"gloo"`` or
    ``"nccl"``; nothing is swapped if it refuses) initialised from a file
    store.  Returns each rank's result, in rank order; ``fn`` and its
    results travel by pickle, so ``fn`` is a module-level function and
    its results picklable (tensors travel by value).  If a rank raises, the other
    ranks are ended and :class:`RuntimeError` carries the failing rank's
    traceback, and the exit codes of ranks that died without a result (a
    native crash prints its stack to the rank's standard error)."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="repro-ranks-") as d:
        store = os.path.join(d, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, world_size, backend, store, args,
                                   results))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        out: dict = {}
        failure = None
        try:
            while len(out) < world_size and failure is None:
                try:
                    rank, ok, value = results.get(timeout=timeout)
                except queue.Empty:
                    failure = (None, f"no result from ranks "
                               f"{sorted(set(range(world_size)) - set(out))}"
                               f" within {timeout} s")
                    break
                if ok:
                    out[rank] = pickle.loads(value)
                else:
                    failure = (rank, value)
        finally:
            for p in procs:
                if failure is not None and p.is_alive():
                    p.terminate()
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
            results.close()
    if failure is not None:
        rank, text = failure
        who = "run_ranks" if rank is None else f"rank {rank} of {world_size}"
        # a rank that died without posting (a native crash) is the likelier
        # cause of the others' connection errors
        died = {r: p.exitcode for r, p in enumerate(procs)
                if r not in out and r != rank and p.exitcode not in (0, None,
                                                                     -15)}
        if died:
            who += f"; ranks that died without a result: {died} (exit codes)"
        raise RuntimeError(f"{who} ({backend}): {text}")
    return [out[r] for r in range(world_size)]


# NVIDIA H100 SXM data sheet (the 700 W part): the roofline denominators.
PEAK_FLOPS_BF16 = 989e12          # FLOP/s, dense bf16 on the tensor cores
HBM_BW = 3.35e12                  # B/s, HBM3
ICI_BW = 450e9                    # B/s per direction: NVLink 4, 900 GB/s
                                  # both directions together
# An NVLink domain holds 8 H100s, so the production mesh's 16-wide
# ``model`` axis crosses it, onto the slower network between hosts: a
# collective time at ICI_BW is a lower bound there.
