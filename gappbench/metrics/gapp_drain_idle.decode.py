"""GAPP session: the share of the traced window with nothing running on
the card while a drain is open, in the decode cells (``spanrun.py``)."""
from gappbench.metrics import _spans

KIND = "per_layer"
UNIT = "%"


def read(rec):
    sp = _spans.reduction(rec, "decode")
    if sp is None or not sp["drains"]:
        return None
    return 100.0 * sp["drain_idle_s"] / sp["window_s"]
