"""The yardstick: the card's data-sheet peaks and the operations and bytes
each step needs, counted from shapes by the configuration's family
(``families/<family>.py``).

Peaks are NVIDIA's H100 SXM data sheet (dense, at the 700 W limit).  The
counts are what the inputs need, not what the port does: each weight and
each written cache row read once, decode's attention over the positions
a row attends to, remat's recompute not counted.  Training's model FLOPs
follow the usual 6 N T + 12 L (H hd) S T, which counts all S x S pairs.
The product kernels' bound counts the weight products alone, at the
bf16 peak: attention's products are left to the step's share, so a
kernel that takes them out of cuBLAS can never lift the products' share
over their roof.
"""
from __future__ import annotations

from gappbench import cell as cell_lib

BF16_FLOPS = 989e12          # tensor cores, bf16 in, float32 accumulate
HBM_BYTES = 3.35e12


def matmul_params(s) -> int:
    """Every weight that enters a product (the embedding is a lookup)."""
    return cell_lib.family_of(s).matmul_params(s)


def param_count(s) -> int:
    return cell_lib.family_of(s).param_count(s)


def decode_step(s, slots: int, rows: int, positions=None) -> dict:
    """One decode step of ``slots`` tokens whose positions sum to
    ``rows - slots`` (``rows``: the cache rows a whole cache attends,
    each slot's position plus one; ``positions``: the slots' positions,
    for a family whose layers attend other rows).  The family's FLOPs and
    bytes by part (``w_*``: the weight products), their sums, the step's
    bound in seconds, and the weight products' bound alone."""
    out = cell_lib.family_of(s).decode_counts(s, slots, rows, positions)
    out["flops"] = sum(v for k, v in out.items() if k.endswith("_flops"))
    out["bytes"] = sum(v for k, v in out.items() if k.endswith("_bytes"))
    out["bound_s"] = max(out["flops"] / BF16_FLOPS, out["bytes"] / HBM_BYTES)
    out["w_bound_s"] = max(out["w_flops"] / BF16_FLOPS,
                           out["w_bytes"] / HBM_BYTES)
    return out


def decode_steps(rec: dict):
    """:func:`decode_step` of each step of a decode record."""
    s = rec["shape"]
    positions = rec.get("positions") or [None] * len(rec["tokens"])
    for n, r, pos in zip(rec["tokens"], rec["rows"], positions):
        yield decode_step(s, n, r, pos)


def train_step(s, batch: int, seq: int) -> dict:
    """One training step of ``batch`` rows of ``seq`` tokens (plus the
    configuration's patch prefix): the positions, the model FLOPs, the
    weight products' FLOPs, and their bound in seconds."""
    out = cell_lib.family_of(s).train_counts(s, batch, seq)
    out["w_bound_s"] = out["w_flops"] / BF16_FLOPS
    return out
