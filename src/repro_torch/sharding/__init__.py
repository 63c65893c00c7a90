"""Sharding: logical-axis annotations + parameter partition rules."""
from repro_torch.sharding.api import (ShardingRules, axis_size, constrain,
                                      default_rules, named_sharding,
                                      use_mesh)
from repro_torch.sharding.params import (logical_param_specs,
                                         param_shardings, physical_specs)

__all__ = [
    "ShardingRules", "axis_size", "constrain", "default_rules",
    "named_sharding", "use_mesh", "logical_param_specs", "param_shardings",
    "physical_specs",
]
