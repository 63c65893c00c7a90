"""Kernels: the decode window's matrix products against their roof: the
weight products' bound counted from shapes (the weights' bytes, or their
FLOPs at the bf16 peak) summed over the steps, over the device time of
every product kernel.  Attention's products over the cache are in the
time and not in the bound, so a kernel that takes them out of cuBLAS
lifts the share and never past 100%."""
from gappbench import yardstick as ys
from gappbench.metrics import _products

KIND = "per_layer"
UNIT = "%"


def read(rec):
    if rec["entry"] != "decode" or rec["trace"] is None:
        return None
    t = _products.seconds(rec["trace"])
    if t <= 0:
        return None
    bound = sum(d["w_bound_s"] for d in ys.decode_steps(rec))
    return 100.0 * bound / t
