"""Model step: the device milliseconds a training step spends under the
program's ``model/attention`` spans: forward, remat's recompute and the
backward of the spans' forward ops, from the traced window
(``spanrun.py``)."""
from gappbench.metrics import _spans

KIND = "per_layer"
UNIT = "ms"


def read(rec):
    return _spans.per_step_ms(rec, "train", "model/attention")
