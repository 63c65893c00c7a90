"""Loading a cell by name: its workload, configuration and traffic files,
and the metrics ``BENCHMARK.json`` asks of it."""
from __future__ import annotations

import dataclasses
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def _load(kind: str, name: str) -> dict:
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"gappbench: no {kind} file {path.name}")
    return json.loads(path.read_text())


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


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    traffic: dict
    limits: dict
    shape: Shape
    end_to_end: list | None      # metric names BENCHMARK.json asks for;
    per_layer: list | None       # None: every reader that finds a value


def _metric_names(bench: dict, key: str, cell: str) -> list[str]:
    return [m["name"] for m in bench.get(key, [])
            if "workloads" not in m or cell in m["workloads"]]


def load(cell: str) -> Cell:
    w = _load("workloads", cell)
    config = _load("configs", w["config"])
    traffic = _load("traffic", w["traffic"])
    e2e = per_layer = None
    bench_file = ROOT / "BENCHMARK.json"
    if bench_file.is_file():
        bench = json.loads(bench_file.read_text())
        if any(x["name"] == cell for x in bench.get("workloads", [])):
            e2e = _metric_names(bench, "end_to_end", cell)
            per_layer = _metric_names(bench, "per_layer", cell)
    return Cell(cell, w["config"], traffic,
                w.get("limits", {}), Shape.from_config(config), e2e,
                per_layer)


def model_config(shape: Shape, name: str):
    """The port's ``ModelConfig`` for ``shape`` (bf16 compute over float32
    parameters, remat on: the port's defaults)."""
    from repro_torch.models.common import ModelConfig
    return ModelConfig(
        name=name, family="vlm" if shape.frontend_dim else "dense",
        num_layers=shape.layers, d_model=shape.d, num_heads=shape.heads,
        num_kv_heads=shape.kv_heads, d_ff=shape.d_ff,
        vocab_size=shape.vocab, block_pattern=("dense",),
        rope_theta=shape.rope_theta, frontend_dim=shape.frontend_dim,
        num_prefix=shape.prefix)
