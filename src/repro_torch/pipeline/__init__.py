"""Pipeline parallelism (GPipe over a stage mesh dimension)."""
from repro_torch.pipeline.gpipe import gpipe, schedule_intervals

__all__ = ["gpipe", "schedule_intervals"]
