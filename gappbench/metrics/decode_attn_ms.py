"""Model step: the device milliseconds a decode step spends under the
program's ``model/attention`` spans (each layer's attention over the
cache), from the traced window (``spanrun.py``)."""
from gappbench.metrics import _spans

KIND = "per_layer"
UNIT = "ms"


def read(rec):
    return _spans.per_step_ms(rec, "decode", "model/attention")
