"""Pipeline parallelism: the GPipe schedule over a stage mesh dimension.

The layer stack is split into ``n_stages`` stages, one a rank of a
``stage`` mesh dimension; microbatches flow stage-to-stage, each step's
activations shifted to the next stage by point-to-point sends.  The
schedule is the classic GPipe fill/steady/drain loop of length
``n_micro + n_stages - 1`` — the warm-up and drain slots are *bubbles*,
i.e. exactly the reduced-parallelism intervals GAPP's CMetric is built to
expose (see examples/pipeline_bubbles.py: the per-stage busy intervals of
this schedule are ingested into the profiler and the bubble fraction
appears as stage-0/stage-N-1 criticality).

The shift (the reference's ``ppermute``) takes one of two routes, chosen
from the stage group's backend and the activations' device
(:func:`shift_route`): ``"send/recv"`` (NCCL, or gloo with CPU tensors)
or ``"host-staged send/recv"`` for gloo with CUDA tensors, which gloo
cannot send: the activation is copied to the host, sent over gloo, and
copied back to the card on the receiving rank.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.models.common import tree_map


def shift_route(group, device: torch.device) -> str:
    """How :func:`gpipe` moves activations between the ranks of
    ``group`` for tensors on ``device``."""
    if dist.get_backend(group) == "gloo" and device.type == "cuda":
        return "host-staged send/recv"
    return "send/recv"


def _shift(y, idx: int, n_stages: int, group, route: str):
    """Stage ``idx`` sends ``y`` to stage ``idx + 1`` and returns what
    stage ``idx - 1`` sent it (zeros on stage 0)."""
    send = y.cpu() if route == "host-staged send/recv" else y.contiguous()
    recv = torch.empty_like(send) if idx > 0 else None
    ops = []
    if idx < n_stages - 1:
        ops.append(dist.P2POp(dist.isend, send,
                              dist.get_global_rank(group, idx + 1), group))
    if recv is not None:
        ops.append(dist.P2POp(dist.irecv, recv,
                              dist.get_global_rank(group, idx - 1), group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return torch.zeros_like(y) if recv is None else recv.to(y.device)


def _local_stage(p, idx: int):
    """This stage's slice of a stacked leaf: the local shard of a DTensor
    sharded on dim 0 over the stage dimension, or row ``idx`` of a plain
    tensor holding every stage."""
    if isinstance(p, DTensor):
        local = p.to_local()
        if local.shape[0] != 1:
            raise ValueError(f"gpipe: a stage holds {local.shape[0]} rows "
                             f"of a stacked leaf, not 1")
        return local[0]
    return p[idx]


def gpipe(stage_fn, mesh, n_stages: int, n_micro: int,
          stage_axis: str = "stage"):
    """Build a pipelined apply: (stacked_params, x) -> y.

    stage_fn: (params_for_stage, activation) -> activation, same shape.
    stacked_params: leaves with leading dim n_stages: DTensors sharded on
    dim 0 over ``stage_axis`` (each rank holds only its own stage), or
    plain tensors holding every stage.
    x: (n_micro, mb, ...) microbatched input, the same on every rank (a
    replicated DTensor or a plain tensor).
    Returns y of the same shape (outputs of the last stage) on every rank,
    as a replicated DTensor.
    """
    ranks = mesh.shape[list(mesh.mesh_dim_names).index(stage_axis)]
    if ranks != n_stages:
        raise ValueError(f"gpipe: {n_stages} stages on a {stage_axis!r} "
                         f"dimension of {ranks} ranks")
    group = mesh.get_group(stage_axis)
    rep = [Replicate()] * mesh.ndim

    def pipelined(stacked_params, x):
        idx = mesh.get_local_rank(stage_axis)
        params = tree_map(lambda p: _local_stage(p, idx), stacked_params)
        xloc = x.full_tensor() if isinstance(x, DTensor) else x
        route = shift_route(group, xloc.device)
        n_steps = n_micro + n_stages - 1
        carry = torch.zeros(xloc.shape[1:], dtype=xloc.dtype,
                            device=xloc.device)        # incoming activation
        outs = torch.zeros_like(xloc)                   # last-stage outputs
        is_last = idx == n_stages - 1
        for t in range(n_steps):
            mb_id = t - idx                             # microbatch at stage
            # stage 0 ingests microbatch t (if any) from x
            inp = xloc[min(max(t, 0), n_micro - 1)] if idx == 0 else carry
            y = stage_fn(params, inp)
            active = 0 <= mb_id < n_micro
            if not active:
                y = torch.zeros_like(y)
            # last stage banks its output at slot mb_id
            if active and is_last:
                outs[mb_id] = y
            # shift activations to the next stage
            if n_stages > 1:
                carry = _shift(y, idx, n_stages, group, route)
        # deliver outs (only the last stage's copy is meaningful): a
        # masked all-reduce sum broadcasts it to every stage member
        if n_stages > 1:
            if not is_last:
                outs.zero_()
            dist.all_reduce(outs, group=group)
        return DTensor.from_local(outs, mesh, rep, run_check=False)

    return pipelined


def schedule_intervals(n_stages: int, n_micro: int, t_stage: float = 1.0):
    """The GPipe schedule as (stage, start, end) busy intervals — the
    ground-truth activity trace used to drive the profiler in tests and in
    examples/pipeline_bubbles.py.  Bubble fraction = (n_stages-1)/(n_micro +
    n_stages-1)."""
    out = []
    for s in range(n_stages):
        for m in range(n_micro):
            t0 = (s + m) * t_stage
            out.append((s, t0, t0 + t_stage))
    return out
