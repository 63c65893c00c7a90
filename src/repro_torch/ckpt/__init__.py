"""Checkpointing: sharded, atomic, in the JAX package's layout."""
from repro_torch.ckpt import checkpoint

__all__ = ["checkpoint"]
