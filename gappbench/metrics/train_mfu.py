"""Model step: the window's model FLOPs (6 N T for the weight products,
12 L (H hd) S T for attention, remat's recompute not counted) over the
window, as a share of the bf16 peak."""
from gappbench import yardstick as ys

KIND = "per_layer"
UNIT = "%"


def read(rec):
    if rec["entry"] != "train" or rec["trace"] is None:
        return None
    f = ys.train_step(rec["shape"], rec["batch"], rec["seq"])["model_flops"]
    return 100.0 * rec["steps"] * f / rec["window_s"] / ys.BF16_FLOPS
