"""Model step: the device milliseconds a training step spends under the
program's ``optim/adamw`` span (clipping, the moments and the update),
from the traced window (``spanrun.py``)."""
from gappbench.metrics import _spans

KIND = "per_layer"
UNIT = "ms"


def read(rec):
    return _spans.per_step_ms(rec, "train", "optim/adamw")
