"""Kernels: the training window's matrix products against their roof:
the weight products' FLOPs counted from shapes at the bf16 peak (remat's
recompute not counted), over the device time of every product kernel.
Attention's products are in the time and not in the count, so a kernel
that takes them out of cuBLAS lifts the share and never past 100%."""
from gappbench import yardstick as ys
from gappbench.metrics import _products

KIND = "per_layer"
UNIT = "%"


def read(rec):
    if rec["entry"] != "train" or rec["trace"] is None:
        return None
    t = _products.seconds(rec["trace"])
    if t <= 0:
        return None
    b = ys.train_step(rec["shape"], rec["batch"], rec["seq"])
    return 100.0 * rec["steps"] * b["w_bound_s"] / t
