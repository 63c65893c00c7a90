#!/usr/bin/env python3
"""What flash-decode's combine costs, on one NVIDIA GPU.

    python3 decode_variants.py

Runs ``chip_smoke.py``'s phase-10 flash-decode (deepseek-7b's decode
width: B 8, 32 heads, hd 128, bf16, a 32,768-slot cache split over the
ranks) on worlds of 1 rank (NCCL) and 2 and 4 gloo ranks sharing the card,
with the combine as committed (``models.attention.flash_combine``:
functional all-reduces, each slice's weights against its own max, the
slices rescaled by the all-reduced max) and with copies that change one
piece: the collectives in place (``torch.distributed.all_reduce``), the
max all-reduced before the weights are taken (so nothing is rescaled),
and both (the combine as it stood before the model's decode attention
shared it).  Every variant in turn, then again in reverse order, each
for ``chip_smoke.FD_CALLS`` calls after two warm-up calls; printed: ms a
call on the slowest rank, and each variant's float32 output against the
committed one's.  Every line names the card and its power limit.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)


def _inplace(t, op, group):
    import torch.distributed as dist
    t = t.clone()
    dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max"
                    else dist.ReduceOp.SUM, group=group)
    return t


def _global_max_local(q, k_local, v_local, valid_local, group=None):
    """``flash_decode_local`` with the max all-reduced before the weights
    are taken (no rescale), through ``attention._all_reduce``."""
    import torch
    import torch.distributed as dist
    from repro_torch.models import attention
    group = dist.group.WORLD if group is None else group
    b, _, h, hd = q.shape
    kv = k_local.shape[2]
    qg = q.reshape(b, kv, h // kv, hd) * (hd ** -0.5)
    s = torch.einsum("bkgh,bskh->bkgs", qg.float(), k_local.float())
    s = torch.where(valid_local[:, None, None, :], s, -torch.inf)
    m = attention._all_reduce(torch.amax(s, dim=-1, keepdim=True), "max",
                              group)
    w = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0))
    l = attention._all_reduce(torch.sum(w, dim=-1, keepdim=True), "sum",
                              group)
    o = torch.einsum("bkgs,bskh->bkgh", w.to(v_local.dtype), v_local).float()
    o = attention._all_reduce(o, "sum", group)
    return (o / torch.clamp(l, min=1e-30)).reshape(b, 1, h, hd).to(q.dtype)


VARIANTS = ("committed", "in-place collectives", "max before the weights",
            "in place, max before the weights")


def rank_body() -> dict:
    """This rank's slice of the cache; each variant's float32 output and
    its ms a call, in turns."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard

    import chip_smoke as cs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import attention
    from repro_torch.models.common import ModelConfig
    from repro_torch.serve import decode_sharded
    torch.set_num_threads(2)
    w, r = dist.get_world_size(), dist.get_rank()
    n = cs.FD_L // w
    q, valid = cs.fd_query("cuda")
    k, v = cs.fd_cache(r * n, (r + 1) * n, "cuda")
    mesh = make_mesh((w,), ("model",), device="cuda")
    f = decode_sharded.make_flash_decode(mesh, ModelConfig(
        num_heads=cs.FD_H, num_kv_heads=cs.FD_KV, head_dim=cs.FD_HD))

    def local(t):
        return DTensor.from_local(t, mesh, [Shard(1)], run_check=False)
    dvalid = local(valid[:, r * n:(r + 1) * n].contiguous())
    k32, v32 = local(k), local(v)
    kb, vb, qb = local(k.bfloat16()), local(v.bfloat16()), q.bfloat16()
    committed = (decode_sharded.flash_decode_local, attention._all_reduce)
    setups = {
        "committed": committed,
        "in-place collectives": (committed[0], _inplace),
        "max before the weights": (_global_max_local, committed[1]),
        "in place, max before the weights": (_global_max_local, _inplace)}
    out, times = {}, {name: [] for name in VARIANTS}
    try:
        for name in VARIANTS + VARIANTS[::-1]:
            decode_sharded.flash_decode_local, attention._all_reduce = \
                setups[name]
            if name not in out:
                out[name] = f(q, k32, v32, dvalid).to_local().cpu()
            for _ in range(2):
                f(qb, kb, vb, dvalid)
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            for _ in range(cs.FD_CALLS):
                f(qb, kb, vb, dvalid)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) / cs.FD_CALLS
                               * 1e3)
    finally:
        decode_sharded.flash_decode_local, attention._all_reduce = committed
    return {"times": times, "err": {
        name: float((o - out["committed"]).abs().max())
        for name, o in out.items()}}


def main() -> int:
    import torch

    from repro_torch.launch.mesh import run_ranks
    if not torch.cuda.is_available():
        print("decode_variants.py needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    for w, backend in ((1, "nccl"), (2, "gloo"), (4, "gloo")):
        ranks = run_ranks(rank_body, w, backend=backend, timeout=600)
        for name in VARIANTS:
            runs = [max(r["times"][name][i] for r in ranks)
                    for i in range(2)]
            err = max(r["err"][name] for r in ranks)
            print(f"[decode] world {w} ({backend}) {name}: "
                  f"{runs[0]:.4f}, {runs[1]:.4f} ms a call (slowest rank; "
                  f"in turn, then in reverse); float32 max |diff| from the "
                  f"committed {err:.3e} ({card})", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
