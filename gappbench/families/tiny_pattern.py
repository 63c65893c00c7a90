"""The ``tiny-pattern`` family, for the CPU tests alone: a decoder whose
layers run a pattern of block kinds the port already runs, so that every
part of the family interface is used by a family that is not ``llama``.

* ``"local"``: rotary GQA attention over a sliding window of ``window``
  positions (a ring cache of that many rows in decode), then a dense
  SwiGLU MLP;
* ``"moe"``: full causal attention, then an expert FFN: a float32 router,
  softmax, the top ``top_k`` renormalised, each expert a SwiGLU of width
  ``d_ff``; the router's auxiliary loss as the port's
  (``aux_weight * E * sum(first choices' share * mean probability)``,
  summed over the expert layers).

The layers run in groups of the pattern, a shorter tail last.  The
configuration routes without drops: its ``capacity_factor`` is at least
experts / top-k, so an expert's capacity in a group holds every token
of it.  Its plain reference is ``reference/tiny_pattern.py``.
"""
from __future__ import annotations

import dataclasses

from gappbench.cell import CacheLayer

NAME = "tiny-pattern"

#: the router reads float32 (the port's ``FLOAT32_MATRICES``)
FLOAT32_LEAVES = frozenset({"router"})

KINDS = ("local", "moe")


@dataclasses.dataclass(frozen=True)
class Shape:
    layers: int
    d: int
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    rope_theta: float
    eps: float
    pattern: tuple
    window: int
    experts: int
    top_k: int
    capacity_factor: float
    aux_weight: float
    prefix: int = 0
    family: str = NAME

    def blocks(self) -> list[tuple[tuple, str]]:
        """``(path, kind)`` of every block in the order the layers run:
        ``("groups", g, "b<i>")`` and the tail's ``("tail", "b<i>")``."""
        n = len(self.pattern)
        out = [(("groups", g, f"b{i}"), kind)
               for g in range(self.layers // n)
               for i, kind in enumerate(self.pattern)]
        out += [(("tail", f"b{i}"), kind)
                for i, kind in enumerate(self.pattern[:self.layers % n])]
        return out


def shape(c: dict) -> Shape:
    pattern = tuple(c["block_pattern"])
    if set(pattern) - set(KINDS):
        raise SystemExit(f"gappbench: {NAME} runs the blocks {KINDS}, "
                         f"not {pattern}")
    e, k = c["num_experts"], c["num_experts_per_tok"]
    if not c.get("norm_topk_prob") or c["capacity_factor"] * k < e:
        raise SystemExit(f"gappbench: {NAME} routes with the top-k "
                         "renormalised and without drops (capacity_factor "
                         ">= experts / top-k)")
    return Shape(layers=c["num_hidden_layers"], d=c["hidden_size"],
                 heads=c["num_attention_heads"],
                 kv_heads=c["num_key_value_heads"],
                 head_dim=c["hidden_size"] // c["num_attention_heads"],
                 d_ff=c["intermediate_size"], vocab=c["vocab_size"],
                 rope_theta=float(c["rope_theta"]),
                 eps=float(c["rms_norm_eps"]), pattern=pattern,
                 window=c["sliding_window"], experts=e, top_k=k,
                 capacity_factor=float(c["capacity_factor"]),
                 aux_weight=float(c["router_aux_loss_coef"]))


def model_config(s: Shape, name: str):
    from repro_torch.models.common import ModelConfig
    return ModelConfig(
        name=name, family="moe", num_layers=s.layers, d_model=s.d,
        num_heads=s.heads, num_kv_heads=s.kv_heads, d_ff=s.d_ff,
        vocab_size=s.vocab, block_pattern=s.pattern, window=s.window,
        rope_theta=s.rope_theta, num_experts=s.experts, top_k=s.top_k,
        capacity_factor=s.capacity_factor, router_aux_weight=s.aux_weight)


def leaf_specs(s: Shape) -> list[tuple[tuple, tuple, float | None]]:
    d, hd, f, e = s.d, s.head_dim, s.d_ff, s.experts
    out = [(("embed",), (s.vocab, d), d ** -0.5),
           (("final_norm",), (d,), None),
           (("lm_head",), (d, s.vocab), d ** -0.5)]
    for b, kind in s.blocks():
        out += [(b + ("ln1",), (d,), None), (b + ("ln2",), (d,), None),
                (b + ("attn", "wq"), (d, s.heads * hd), d ** -0.5),
                (b + ("attn", "wk"), (d, s.kv_heads * hd), d ** -0.5),
                (b + ("attn", "wv"), (d, s.kv_heads * hd), d ** -0.5),
                (b + ("attn", "wo"), (s.heads * hd, d),
                 (s.heads * hd) ** -0.5)]
        if kind == "moe":
            out += [(b + ("ffn", "router"), (d, e), d ** -0.5),
                    (b + ("ffn", "we_gate"), (e, d, f), d ** -0.5),
                    (b + ("ffn", "we_up"), (e, d, f), d ** -0.5),
                    (b + ("ffn", "we_down"), (e, f, d), f ** -0.5)]
        else:
            out += [(b + ("ffn", "gate"), (d, f), d ** -0.5),
                    (b + ("ffn", "up"), (d, f), d ** -0.5),
                    (b + ("ffn", "down"), (f, d), f ** -0.5)]
    return out


def cache_layers(s: Shape, cache_len: int) -> list[CacheLayer]:
    """Every block attends: a ``local`` one over a ring of the window's
    rows (the port's ``min(window, cache_len)``), a ``moe`` one over the
    whole cache.  The tail is the engine state's last group."""
    out = []
    for b, kind in s.blocks():
        group = b[1] if b[0] == "groups" else s.layers // len(s.pattern)
        rows = min(s.window, cache_len) if kind == "local" else cache_len
        out.append(CacheLayer(group, b[-1], rows))
    return out


def route_layers(s: Shape) -> list[tuple[int, str]]:
    """Every ``moe`` block, as ``cache_layers`` places it."""
    return [(c.group, c.block) for c, (_, kind) in
            zip(cache_layers(s, 1), s.blocks()) if kind == "moe"]


def make_bank(s: Shape, seed: int, rows: int, device) -> tuple:
    from gappbench.weights import bank_for
    return bank_for(cache_layers(s, rows), s.kv_heads, s.head_dim, seed,
                    device)


def _attn_params(s: Shape) -> int:
    hd = s.head_dim
    return 2 * s.d * s.heads * hd + 2 * s.d * s.kv_heads * hd


def _kinds(s: Shape) -> list[str]:
    return [kind for _, kind in s.blocks()]


def matmul_params(s: Shape) -> int:
    """Every weight that enters a product: attention, the MLPs, the
    routers and every expert, and the head."""
    mlp = 3 * s.d * s.d_ff
    n = s.d * s.vocab
    for kind in _kinds(s):
        n += _attn_params(s) + (s.d * s.experts + s.experts * mlp
                                if kind == "moe" else mlp)
    return n


def param_count(s: Shape) -> int:
    return matmul_params(s) + s.vocab * s.d + (2 * s.layers + 1) * s.d


def decode_counts(s: Shape, slots: int, rows: int, positions) -> dict:
    """The weight products a step's tokens need: attention, the MLPs and
    the routers once, each token's ``top_k`` experts in FLOPs, and in
    bytes the experts that uniform routing touches in expectation
    (``E (1 - (1 - k/E)^slots)`` a layer); attention's two products over
    each slot's rows: ``pos + 1`` in a full layer, ``min(pos + 1,
    window)`` in a local one."""
    kinds = _kinds(s)
    mlp = 3 * s.d * s.d_ff
    per_token = s.d * s.vocab + sum(
        _attn_params(s) + (s.d * s.experts + s.top_k * mlp
                           if kind == "moe" else mlp) for kind in kinds)
    n_moe = kinds.count("moe")
    touched = s.experts * (1 - (1 - s.top_k / s.experts) ** slots)
    read = per_token + n_moe * (touched - s.top_k) * mlp
    local_rows = sum(min(p + 1, s.window) for p in positions)
    attended = sum(local_rows if kind == "local" else rows
                   for kind in kinds)
    attn_w = 2 * s.heads * s.head_dim
    kv_row = 2 * s.kv_heads * s.head_dim
    return {
        "w_flops": 2 * slots * per_token,
        "w_bytes": 2 * read + slots * s.d * 2,
        "qk_flops": attn_w * attended,
        "qk_bytes": kv_row * attended,
        "pv_flops": attn_w * attended,
        "pv_bytes": kv_row * attended,
    }


def train_counts(s: Shape, batch: int, seq: int) -> dict:
    """6 N T over the weights a token uses (its ``top_k`` experts), the
    head over every token, and 12 (H hd) pairs T for attention: all S x S
    pairs in a full layer, S x min(S, window) in a local one."""
    kinds = _kinds(s)
    mlp = 3 * s.d * s.d_ff
    t = batch * seq
    per_token = sum(_attn_params(s) + (s.d * s.experts + s.top_k * mlp
                                       if kind == "moe" else mlp)
                    for kind in kinds)
    w_flops = 6 * per_token * t + 6 * s.d * s.vocab * t
    pairs = sum(seq * (min(seq, s.window) if kind == "local" else seq)
                for kind in kinds)
    attn = 6 * 2 * s.heads * s.head_dim * pairs * batch
    return {"positions": t, "model_flops": w_flops + attn,
            "w_flops": w_flops}
