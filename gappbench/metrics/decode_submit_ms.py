"""Engine loop: the host milliseconds a decode step spends in the
program's ``serve/submit`` spans (admitting requests to free slots), from
the traced window (``spanrun.py``)."""
from gappbench.metrics import _spans

KIND = "per_layer"
UNIT = "ms"


def read(rec):
    return _spans.per_step_ms(rec, "decode", "serve/submit", "host_s")
