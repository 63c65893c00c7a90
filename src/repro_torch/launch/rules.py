"""The launcher's per-arch and per-shape-kind rule overrides.

Plain data copied from the JAX package's dry-run (``launch/dryrun.py``),
kept in this module of their own so that the sharded steps and the tests
bind them without the dry-run; :mod:`repro_torch.launch.dryrun`
re-exports them.
"""
from __future__ import annotations

from repro_torch.sharding import api as shapi
from repro_torch.sharding import params as shparams

# Per-arch logical-axis overrides.
ARCH_RULES: dict[str, dict] = {
    # grok: 8 experts cannot shard a 16-way axis -> TP experts over 'model',
    # FSDP-style weight sharding of the big expert tables over 'data'.
    "grok-1-314b": {"experts": None, "expert_in": "data",
                    "expert_mlp": "model"},
    # arctic: 128 experts -> EP over 'data' (8/chip-row), TP over 'model'.
    "arctic-480b": {"experts": "data", "expert_in": None,
                    "expert_mlp": "model"},
}

# Shape-kind overrides: decode shards the KV cache sequence over 'model'
# (flash-decode); training/prefill keep activations DP + heads TP.
KIND_RULES: dict[str, dict] = {
    "decode": {"cache_seq": "model"},
    "prefill": {},
    "train": {},
}


def rules_for(arch: str, kind: str, extra: dict | None = None):
    table = dict(shapi.DEFAULT_RULES)
    table.update(shparams.PARAM_LOGICAL_EXTRA)
    table.update(ARCH_RULES.get(arch, {}))
    table.update(KIND_RULES.get(kind, {}))
    table.update(extra or {})
    return shapi.ShardingRules(table)
