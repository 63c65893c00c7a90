"""Pipeline parallelism: the GPipe schedule (``gpipe()`` is not ported)."""
from repro_torch.pipeline.gpipe import schedule_intervals

__all__ = ["schedule_intervals"]
