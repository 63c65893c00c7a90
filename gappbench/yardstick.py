"""The yardstick: the card's data-sheet peaks and the operations and bytes
each step needs, counted from shapes.

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

from gappbench.cell import Shape

BF16_FLOPS = 989e12          # tensor cores, bf16 in, float32 accumulate
HBM_BYTES = 3.35e12


def layer_matmul_params(s: Shape) -> int:
    """Parameters of one layer's weight products (q, k, v, o, gate, up,
    down)."""
    hd = s.head_dim
    return (s.d * s.heads * hd + 2 * s.d * s.kv_heads * hd
            + s.heads * hd * s.d + 3 * s.d * s.d_ff)


def matmul_params(s: Shape) -> int:
    """Every weight that enters a product: the layers, the head and the
    patch projector (the embedding is a lookup)."""
    return s.layers * layer_matmul_params(s) + s.d * s.vocab \
        + s.frontend_dim * s.d


def param_count(s: Shape) -> int:
    return matmul_params(s) + s.vocab * s.d + (2 * s.layers + 1) * s.d


def decode_step(s: Shape, slots: int, rows: int) -> dict:
    """One decode step of ``slots`` tokens whose positions sum to
    ``rows - slots`` (``rows``: the cache rows attended, each slot's
    position plus one).  FLOPs and bytes of the weight products and of
    attention's two products, the step's bound in seconds, and the
    weight products' bound alone."""
    w = matmul_params(s) - s.frontend_dim * s.d
    attn_w = 2 * s.heads * s.head_dim          # per row, one product
    kv_row = 2 * s.kv_heads * s.head_dim        # bf16 bytes of a k (or v) row
    out = {
        "w_flops": 2 * slots * w,
        "w_bytes": 2 * w + slots * s.d * 2,
        "qk_flops": s.layers * attn_w * rows,
        "qk_bytes": s.layers * kv_row * rows,
        "pv_flops": s.layers * attn_w * rows,
        "pv_bytes": s.layers * kv_row * rows,
    }
    out["flops"] = out["w_flops"] + out["qk_flops"] + out["pv_flops"]
    out["bytes"] = out["w_bytes"] + out["qk_bytes"] + out["pv_bytes"]
    out["bound_s"] = max(out["flops"] / BF16_FLOPS, out["bytes"] / HBM_BYTES)
    out["w_bound_s"] = max(out["w_flops"] / BF16_FLOPS,
                           out["w_bytes"] / HBM_BYTES)
    return out


def train_step(s: Shape, batch: int, seq: int) -> dict:
    """One training step of ``batch`` rows of ``seq`` tokens (plus the
    configuration's patch prefix): the model FLOPs (6 N T for the weight
    products, the head over the tokens the loss reads, 12 L (H hd) S T
    for attention), and the weight products' bound in seconds."""
    n = seq + s.prefix
    t = batch * n
    layer_w = s.layers * layer_matmul_params(s) + s.frontend_dim * s.d
    w_flops = 6 * layer_w * t + 6 * s.d * s.vocab * batch * seq
    # forward and the two backward products, for q k^T and for p v
    one = 2 * s.heads * s.head_dim * n * n * batch * s.layers
    qk_flops = 3 * one
    pv_flops = 3 * one
    return {
        "positions": t,
        "model_flops": w_flops + qk_flops + pv_flops,
        "w_flops": w_flops,
        "w_bound_s": w_flops / BF16_FLOPS,
    }
