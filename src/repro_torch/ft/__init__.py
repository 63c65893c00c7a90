"""Fault tolerance: straggler monitor + crash-restart driver."""
from repro_torch.ft.monitor import (StragglerMonitor, StragglerVerdict,
                                    run_with_restarts)

__all__ = ["StragglerMonitor", "StragglerVerdict", "run_with_restarts"]
