"""Loading a cell by name: its workload, configuration and traffic files,
the configuration's family, and the metrics ``BENCHMARK.json`` asks of
it.

A configuration file names its ``family`` (``llama`` when it names none):
the module ``families/<family>.py`` (a ``-`` in the name is a ``_`` in the
file's), loaded by path, that holds everything about that architecture
the harness needs, and whose plain reference is
``reference/<family>.py``.  A family module supplies:

* ``NAME`` and ``Shape``: a frozen dataclass of the configuration's sizes
  with a ``family`` field (the family's name), built by
  ``shape(config_dict)``; it goes into the run's record;
* ``model_config(shape, name)``: the port's ``ModelConfig``;
* ``leaf_specs(shape)``: ``(path, shape, scale)`` of every parameter in a
  fixed order, in the port's tree layout (``scale`` None: a norm scale),
  and ``FLOAT32_LEAVES``, the leaf names kept in float32 whatever the
  serving dtype;
* ``cache_layers(shape, cache_len)``: one :class:`CacheLayer` an attention
  layer, in the order the layers run;
* ``make_bank(shape, seed, cache_len, device)``: the prompts' K/V, one
  ``(rows, kv_heads, head_dim)`` k and v a cache layer;
* optionally, ``route_layers(shape)``: the ``(group, block)`` of every
  layer that routes tokens to experts, in the order the layers run (like
  ``cache_layers``).  A family that supplies it is judged in decode under
  the program's own routing (``decode.RouteTap``, ``run.check_decode``),
  and its reference's ``decode_logits`` takes ``routes``, ``route_gaps``,
  ``reroute`` and ``own_route_gap`` (see ``reference/tiny_pattern.py``);
* the yardstick's counts: ``matmul_params``, ``param_count``,
  ``decode_counts(shape, slots, rows, positions)`` and
  ``train_counts(shape, batch, seq)``.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
DEFAULT_FAMILY = "llama"


def _load(kind: str, name: str) -> dict:
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"gappbench: no {kind} file {path.name}")
    return json.loads(path.read_text())


@dataclasses.dataclass(frozen=True)
class CacheLayer:
    """Where one attention layer's decode cache sits in the engine's
    state (``engine.state[group][block]["kv"]``) and how many rows it has:
    the whole cache, or a ring of the window's rows.  Position ``p`` lies
    at row ``p % rows`` either way (a ring holds the last ``rows``
    positions), and its prompt K/V is the bank's row ``(p + offset) %
    rows`` of that layer."""

    group: int
    block: str
    rows: int


def family(name: str):
    """The family module ``families/<name>.py``, loaded once by path."""
    stem = name.replace("-", "_")
    mod_name = "gappbench_family_" + stem
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    path = HERE / "families" / f"{stem}.py"
    if not path.is_file():
        raise SystemExit(f"gappbench: no family file {path.name}")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    # a dataclass's module has to be in sys.modules as it is made
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def family_of(shape):
    return family(shape.family)


#: the ``llama`` family's shape, under the name the records and tests use
Shape = family(DEFAULT_FAMILY).Shape


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    traffic: dict
    limits: dict
    shape: object                # the family's Shape
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
                w.get("limits", {}),
                family(config.get("family", DEFAULT_FAMILY)).shape(config),
                e2e, per_layer)


def route_layers(shape) -> list:
    """``(group, block)`` of each expert layer of ``shape``'s family, in
    the order the layers run; none where the family routes nothing."""
    fam = family_of(shape)
    return fam.route_layers(shape) if hasattr(fam, "route_layers") else []


def model_config(shape, name: str):
    """The port's ``ModelConfig`` for ``shape`` (bf16 compute over float32
    parameters, remat on: the port's defaults)."""
    return family_of(shape).model_config(shape, name)
