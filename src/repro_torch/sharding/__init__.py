"""Sharding: logical-axis annotations (only ``constrain`` so far)."""
from repro_torch.sharding.api import constrain

__all__ = ["constrain"]
