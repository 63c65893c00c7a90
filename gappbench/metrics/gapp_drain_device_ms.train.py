"""GAPP session: the mean device segment of a drain that folded events
(the fold prefix's upload, its kernel and the read-back, with the wait
behind the step's queued work), in the train cells."""
from gappbench.metrics import _spans

KIND = "per_layer"
UNIT = "ms"


def read(rec):
    return _spans.drain_device_ms(rec, "train")
