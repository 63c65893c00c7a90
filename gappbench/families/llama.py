"""The ``llama`` family: a llama-style decoder (pre-norm RMSNorm, rotary
attention with grouped K/V, SwiGLU), one dense block a layer, with an
optional projected patch prefix (a vision-language model's language
model).  Its plain reference is ``reference/llama.py``.

Names of the configuration file follow the published ``config.json``; a
``vision`` group gives the patch prefix (``frontend_dim``, ``num_prefix``).
"""
from __future__ import annotations

import dataclasses

import torch

from gappbench.cell import CacheLayer

NAME = "llama"

#: leaf names kept in float32 whatever the serving dtype: none
FLOAT32_LEAVES = frozenset()


@dataclasses.dataclass(frozen=True)
class Shape:
    """A configuration's sizes, as the yardstick and the reference use
    them (names follow the published config.json)."""

    layers: int
    d: int
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    rope_theta: float
    eps: float
    frontend_dim: int = 0
    prefix: int = 0
    family: str = NAME

    @classmethod
    def from_config(cls, c: dict) -> "Shape":
        v = c.get("vision") or {}
        return cls(layers=c["num_hidden_layers"], d=c["hidden_size"],
                   heads=c["num_attention_heads"],
                   kv_heads=c["num_key_value_heads"],
                   head_dim=c["hidden_size"] // c["num_attention_heads"],
                   d_ff=c["intermediate_size"], vocab=c["vocab_size"],
                   rope_theta=float(c["rope_theta"]),
                   eps=float(c["rms_norm_eps"]),
                   frontend_dim=v.get("frontend_dim", 0),
                   prefix=v.get("num_prefix", 0))


def shape(config: dict) -> Shape:
    return Shape.from_config(config)


def model_config(s: Shape, name: str):
    from repro_torch.models.common import ModelConfig
    return ModelConfig(
        name=name, family="vlm" if s.frontend_dim else "dense",
        num_layers=s.layers, d_model=s.d, num_heads=s.heads,
        num_kv_heads=s.kv_heads, d_ff=s.d_ff,
        vocab_size=s.vocab, block_pattern=("dense",),
        rope_theta=s.rope_theta, frontend_dim=s.frontend_dim,
        num_prefix=s.prefix)


def leaf_specs(s: Shape) -> list[tuple[tuple, tuple, float | None]]:
    d, hd = s.d, s.head_dim
    out = [(("embed",), (s.vocab, d), d ** -0.5),
           (("final_norm",), (d,), None),
           (("lm_head",), (d, s.vocab), d ** -0.5)]
    if s.frontend_dim:
        out.append((("frontend",), (s.frontend_dim, d),
                    s.frontend_dim ** -0.5))
    for layer in range(s.layers):
        g = ("groups", layer, "b0")
        out += [(g + ("ln1",), (d,), None), (g + ("ln2",), (d,), None),
                (g + ("attn", "wq"), (d, s.heads * hd), d ** -0.5),
                (g + ("attn", "wk"), (d, s.kv_heads * hd), d ** -0.5),
                (g + ("attn", "wv"), (d, s.kv_heads * hd), d ** -0.5),
                (g + ("attn", "wo"), (s.heads * hd, d),
                 (s.heads * hd) ** -0.5),
                (g + ("ffn", "gate"), (d, s.d_ff), d ** -0.5),
                (g + ("ffn", "up"), (d, s.d_ff), d ** -0.5),
                (g + ("ffn", "down"), (s.d_ff, d), s.d_ff ** -0.5)]
    return out


def cache_layers(s: Shape, cache_len: int) -> list[CacheLayer]:
    """One group a layer, each with the whole cache."""
    return [CacheLayer(layer, "b0", cache_len) for layer in range(s.layers)]


def make_bank(s: Shape, seed: int, rows: int, device) -> tuple:
    """Per layer ``rows`` bf16 rows of k and of v, stacked:
    (layers, rows, kv_heads, head_dim) each."""
    from gappbench.weights import leaf_seed
    gen = torch.Generator(device).manual_seed(leaf_seed(seed, 1 << 20))
    shape = (s.layers, rows, s.kv_heads, s.head_dim)
    k = torch.randn(shape, generator=gen, device=device, dtype=torch.bfloat16)
    v = torch.randn(shape, generator=gen, device=device, dtype=torch.bfloat16)
    return k, v


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


def decode_counts(s: Shape, slots: int, rows: int, positions=None) -> dict:
    """The weight products' FLOPs and bytes (every weight read once), and
    attention's two products over ``rows`` cache rows in every layer;
    ``positions`` is not needed."""
    w = matmul_params(s) - s.frontend_dim * s.d
    attn_w = 2 * s.heads * s.head_dim          # per row, one product
    kv_row = 2 * s.kv_heads * s.head_dim        # bf16 bytes of a k (or v) row
    return {
        "w_flops": 2 * slots * w,
        "w_bytes": 2 * w + slots * s.d * 2,
        "qk_flops": s.layers * attn_w * rows,
        "qk_bytes": s.layers * kv_row * rows,
        "pv_flops": s.layers * attn_w * rows,
        "pv_bytes": s.layers * kv_row * rows,
    }


def train_counts(s: Shape, batch: int, seq: int) -> dict:
    """6 N T for the weight products (the head over the tokens the loss
    reads), 12 L (H hd) S T for attention, counting all S x S pairs."""
    n = seq + s.prefix
    t = batch * n
    layer_w = s.layers * layer_matmul_params(s) + s.frontend_dim * s.d
    w_flops = 6 * layer_w * t + 6 * s.d * s.vocab * batch * seq
    # forward and the two backward products, for q k^T and for p v
    one = 2 * s.heads * s.head_dim * n * n * batch * s.layers
    qk_flops = 3 * one
    pv_flops = 3 * one
    return {"positions": t, "model_flops": w_flops + qk_flops + pv_flops,
            "w_flops": w_flops}
