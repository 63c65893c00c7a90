"""Data pipeline: synthetic sources + instrumented prefetch."""
from repro_torch.data.pipeline import PrefetchLoader, SyntheticLM

__all__ = ["PrefetchLoader", "SyntheticLM"]
