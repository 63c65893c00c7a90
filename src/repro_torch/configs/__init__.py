"""Assigned architecture configs and the input-shape grid.

Each module defines ``config()`` (the exact published configuration) and
``tiny()`` (a reduced same-family config for CPU smoke tests).  The dry-run
grid is ``ARCHS`` × each arch's applicable ``SHAPES`` cells.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.common import ModelConfig

ARCHS = [
    "deepseek-7b",
    "qwen1.5-4b",
    "qwen3-32b",
    "gemma3-1b",
    "recurrentgemma-2b",
    "seamless-m4t-large-v2",
    "internvl2-2b",
    "grok-1-314b",
    "arctic-480b",
    "rwkv6-1.6b",
]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str              # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

# long_500k requires sub-quadratic sequence handling: run for SSM / hybrid /
# mostly-local archs, skip for pure full-attention archs (see DESIGN.md §4).
SUBQUADRATIC = {"recurrentgemma-2b", "rwkv6-1.6b", "gemma3-1b"}


def _module(name: str):
    return importlib.import_module(
        "repro_torch.configs." + name.replace("-", "_").replace(".", "_"))


def get_config(name: str) -> ModelConfig:
    return _module(name).config()


def get_tiny(name: str) -> ModelConfig:
    return _module(name).tiny()


def applicable_shapes(arch: str) -> list[str]:
    out = []
    for s in SHAPES:
        if s == "long_500k" and arch not in SUBQUADRATIC:
            continue
        out.append(s)
    return out


def grid() -> list[tuple[str, str]]:
    """All (arch, shape) dry-run cells, including the documented skips as
    absent rows (see EXPERIMENTS.md for the skip table)."""
    return [(a, s) for a in ARCHS for s in applicable_shapes(a)]
