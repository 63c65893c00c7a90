"""Optimizers: AdamW + gradient compression (error feedback)."""
from repro_torch.optim import adamw, compression

__all__ = ["adamw", "compression"]
