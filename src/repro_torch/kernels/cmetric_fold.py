"""CUDA kernels: the CMetric interval fold and the carry-seeded prefix.

For every event the analysis needs the active-worker count during the
interval that follows it and the running ``global_cm`` prefix::

    n[i]   = n_in   + sum_{e<=i} delta[e]
    gcm[i] = gcm_in + sum_{e<i}  dt[e] / n[e]   (over intervals with n > 0)

two coupled prefix scans over the event stream (paper §4.1).

* :func:`fold` replaces the TPU kernel ``_fold_kernel`` of the JAX package
  (``src/repro/kernels/cmetric_fold.py``, wrapper ``fold``).
* :func:`carry_cumsum` replaces ``_cumsum_kernel`` of the same file
  (wrapper ``carry_cumsum``): the carry-seeded prefix of the chunked fold.

Design (``csrc/cmetric_fold.cu``): the TPU kernels carry the prefix from
one grid step to the next in VMEM scratch, relying on the TPU's sequential
grid; CUDA blocks run concurrently.  Both wrappers are one memset and one
launch: a single pass over 8192-event tiles with a decoupled look-back.
Each block takes its tile from an atomic ticket, scans it, publishes the
tile's sums and then its inclusive prefixes in self-describing 64-bit
status words, and finds its own offset from its predecessors' words.  The
fold chains two look-backs: it scans the deltas (int32; the TPU kept the
count in f32), publishes the tile's count at once, looks back for the
count coming into the tile, forms ``n`` and the contributions, then scans
those in float32 and looks back over the float64 (contrib, idle) words;
its tile waits out the look-backs in shared memory, not in registers.
The status words are zeroed by a memset on the stream before each launch.

Bound: memory.  ``fold`` must move 16 bytes per event (dt, deltas in; n,
gcm out), ``carry_cumsum`` 12 (contrib, idle_contrib in; g out).  These
designs move 16 and 12, plus 24 and 16 bytes of status per tile.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs and scratch with ``torch.empty``, and counts its launches in
:data:`LAUNCHES`.  On a CPU tensor it runs the plain version from
:mod:`repro_torch.kernels.ref`; on a CUDA tensor it launches the kernel or
raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

#: Kernel launches per wrapper since the last reset (CPU calls don't count).
LAUNCHES = {"fold": 0, "carry_cumsum": 0}


def check_vector(x: torch.Tensor, dtype: torch.dtype, name: str) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(x)}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if x.dim() != 1:
        raise ValueError(f"{name} must be 1-D, got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_device(tensors, names) -> torch.device:
    dev = tensors[0].device
    for t, name in zip(tensors[1:], names[1:]):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, {names[0]} on {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev} (cpu runs the plain "
                         "version, cuda the kernel)")
    return dev


def carry_args(carry, size: int, dev: torch.device):
    """A carry (``None``, or numbers / 0-d tensors) as the kernels take it:
    ``(device tensor or None, [size host floats])``.  Plain numbers go by
    value; a carry holding tensors (one returned by an earlier call) is
    stacked on the device, without a host round-trip."""
    if carry is None:
        return None, [0.0] * size
    if len(carry) != size:
        raise ValueError(f"carry must have {size} entries, got {len(carry)}")
    if not any(isinstance(c, torch.Tensor) for c in carry):
        return None, [float(c) for c in carry]
    return torch.stack([torch.as_tensor(c, dtype=torch.float32, device=dev)
                        .reshape(()) for c in carry]), [0.0] * size


def vec_ok(*tensors: torch.Tensor) -> int:
    """1 when every pointer allows the kernels' 16-byte loads and stores."""
    return int(all(t.data_ptr() % 16 == 0 for t in tensors))


def raise_on_error(rc: int, fn: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{fn} failed to launch: CUDA error {rc}")


def _tiles(lib, e: int) -> int:
    tile = lib.gapp_tile_size()
    return (e + tile - 1) // tile


def fold(dt, deltas, carry=None):
    """Blocked, carry-resumable CMetric fold (see
    :func:`repro_torch.kernels.ref.fold_ref`).

    Args:
      dt:     f32[E] interval lengths (last entry 0).
      deltas: i32[E] state-change deltas (+1/-1, 0 padding).
      carry:  optional (count, gcm, idle) triple resuming a prior call.

    Returns ``(n i32[E], gcm f32[E], total_cm, idle, count)`` with the
    scalars as 0-d f32 tensors on the input's device; the final
    ``(total_cm, idle, count)`` triple is the carry for the next chunk.
    """
    check_vector(dt, torch.float32, "dt")
    check_vector(deltas, torch.int32, "deltas")
    if dt.shape != deltas.shape:
        raise ValueError(f"dt {tuple(dt.shape)} and deltas "
                         f"{tuple(deltas.shape)} differ in shape")
    e = dt.shape[0]
    if e == 0:
        raise ValueError("fold needs at least one event")
    dev = check_device([dt, deltas], ["dt", "deltas"])
    if dev.type == "cpu":
        return ref.fold_ref(dt, deltas, carry)
    lib = build.load("cmetric_fold")
    n = torch.empty(e, dtype=torch.int32, device=dev)
    gcm = torch.empty(e, dtype=torch.float32, device=dev)
    scalars = torch.empty(3, dtype=torch.float32, device=dev)
    status = torch.empty(3 * _tiles(lib, e) + 1, dtype=torch.int64,
                         device=dev)
    carry_dev, carry_vals = carry_args(carry, 3, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.gapp_fold(dt.data_ptr(), deltas.data_ptr(), e,
                           None if carry_dev is None else carry_dev.data_ptr(),
                           *carry_vals, n.data_ptr(), gcm.data_ptr(),
                           scalars.data_ptr(), status.data_ptr(),
                           vec_ok(dt, deltas, n, gcm), stream)
    raise_on_error(rc, "gapp_fold")
    LAUNCHES["fold"] += 1
    return n, gcm, scalars[0], scalars[1], scalars[2]


def carry_cumsum(contrib, idle_contrib, carry):
    """Carry-seeded prefix of the chunked fold (see
    :func:`repro_torch.kernels.ref.carry_cumsum_ref`).

    ``carry`` is ``(gcm0, idle0)``, taken as f32.  Returns ``(g f32[E],
    gcm_end, idle_end)``: ``g[i]`` is global_cm *at* event i (inclusive of
    event i's contribution).
    """
    check_vector(contrib, torch.float32, "contrib")
    check_vector(idle_contrib, torch.float32, "idle_contrib")
    if contrib.shape != idle_contrib.shape:
        raise ValueError(f"contrib {tuple(contrib.shape)} and idle_contrib "
                         f"{tuple(idle_contrib.shape)} differ in shape")
    e = contrib.shape[0]
    if e == 0:
        raise ValueError("carry_cumsum needs at least one event")
    dev = check_device([contrib, idle_contrib], ["contrib", "idle_contrib"])
    if dev.type == "cpu":
        return ref.carry_cumsum_ref(contrib, idle_contrib, carry)
    lib = build.load("cmetric_fold")
    g = torch.empty(e, dtype=torch.float32, device=dev)
    scalars = torch.empty(2, dtype=torch.float32, device=dev)
    status = torch.empty(2 * _tiles(lib, e) + 1, dtype=torch.int64,
                         device=dev)
    carry_dev, carry_vals = carry_args(carry, 2, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.gapp_carry_cumsum(
            contrib.data_ptr(), idle_contrib.data_ptr(), e,
            None if carry_dev is None else carry_dev.data_ptr(), *carry_vals,
            g.data_ptr(), scalars.data_ptr(), status.data_ptr(),
            vec_ok(contrib, idle_contrib, g), stream)
    raise_on_error(rc, "gapp_carry_cumsum")
    LAUNCHES["carry_cumsum"] += 1
    return g, scalars[0], scalars[1]
